"""Ridge / masked-ridge solves and standardization on sufficient statistics.

Port of ``pdx/ops/linalg.py:21-131``. Every fit runs on the Gram statistics
``G = X^T X``, ``b = X^T y``; a support mask keeps shapes static (inactive
rows/columns become identity rows), so a whole hyperparameter grid is one
batched ``torch.linalg.solve``. Batch dimensions lead: ``G`` (..., p, p),
``b`` and masks (..., p), ``alpha`` a float or a tensor of the batch shape.
"""

from __future__ import annotations

import torch
from torch import Tensor


def gram_stats(X: Tensor, y: Tensor, weights: Tensor | None = None) -> dict[str, Tensor]:
    """Sufficient statistics for (weighted) least squares.

    G = X^T W X, b = X^T W y, sx = weighted column sums, n = total weight,
    syy = y^T W y, sy = sum of W y. Leading axes of X (..., n, p), y and
    the weights (..., n) are batch axes.
    """
    if weights is None:
        Xw = X
        yw = y
        n = torch.tensor(X.shape[-2], dtype=X.dtype, device=X.device)
    else:
        Xw = X * weights[..., None]
        yw = y * weights
        n = torch.sum(weights, dim=-1)
    return {
        "G": X.mT @ Xw,
        "b": (X.mT @ yw[..., None])[..., 0],
        "sx": torch.sum(Xw, dim=-2),
        "n": n,
        "syy": torch.sum(y * yw, dim=-1),
        "sy": torch.sum(yw, dim=-1),
    }


def standardized_stats(stats: dict[str, Tensor]) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Raw Gram stats -> standardized-column stats (Gs, bs, mean, scale).

    Gs = Xs^T Xs and bs = Xs^T y for Xs = (X - mean) / scale; y is not
    centred, as in the reference: Xs^T y = (b - mean * sy) / scale.
    """
    G, b, sx = stats["G"], stats["b"], stats["sx"]
    n, sy = stats["n"][..., None], stats["sy"][..., None]  # against (..., p)
    mean = sx / n
    var = torch.diagonal(G, dim1=-2, dim2=-1) / n - mean**2
    std = torch.sqrt(torch.clamp(var, min=0.0))
    scale = torch.where(std > _zero_std_tol(mean, std.dtype), std, torch.ones_like(std))
    Gc = G - n[..., None] * mean[..., :, None] * mean[..., None, :]
    Gs = Gc / (scale[..., :, None] * scale[..., None, :])
    bs = (b - mean * sy) / scale
    return Gs, bs, mean, scale


def _zero_std_tol(mean: Tensor, dtype: torch.dtype) -> Tensor:
    """Relative zero-variance cutoff for column standardization.

    A reduction order other than NumPy's pairwise one can leave O(eps)
    residual std on an exactly-constant column, and dividing by it blows the
    coefficient up by ~1/eps. The cutoff is relative to |mean| ONLY: a
    constant column's residual is O(eps * |mean|), while a genuine zero-mean
    column with tiny std must still be standardized. Exactly-zero columns
    fall out via the strict ``std > tol`` comparison.
    """
    eps = torch.finfo(dtype).eps
    return (eps**0.5) * 10.0 * torch.abs(mean)


def _batch_scalar(alpha: float | Tensor, like: Tensor) -> Tensor:
    """``alpha`` as a tensor of ``like``'s dtype whose shape broadcasts
    against (..., p, p): batch shape + two trailing singleton axes."""
    a = torch.as_tensor(alpha, dtype=like.dtype, device=like.device)
    return a[..., None, None]


def ridge_solve(G: Tensor, b: Tensor, alpha: float | Tensor) -> Tensor:
    """Solve (G + alpha I) c = b (normal-equation ridge, no intercept)."""
    p = G.shape[-1]
    eye = torch.eye(p, dtype=G.dtype, device=G.device)
    return torch.linalg.solve(G + _batch_scalar(alpha, G) * eye, b[..., None])[..., 0]


def masked_ridge_solve(G: Tensor, b: Tensor, mask: Tensor, alpha: float | Tensor) -> Tensor:
    """Ridge solve restricted to the active support, with static shapes.

    Equivalent to solving (G[m, m] + alpha I) c_m = b[m] and scattering c_m
    back: inactive rows/cols are replaced by identity rows with zero RHS.
    """
    p = G.shape[-1]
    m = mask.to(G.dtype)
    eye = torch.eye(p, dtype=G.dtype, device=G.device)
    A = (
        G * (m[..., :, None] * m[..., None, :])
        + _batch_scalar(alpha, G) * eye * m[..., None, :] * torch.ones_like(m)[..., :, None]
        + eye * (1.0 - m)[..., None, :]
    )
    rhs = b * m
    sol = torch.linalg.solve(A, rhs[..., None])[..., 0]
    return sol * m


def column_standardize_stats(X: Tensor) -> tuple[Tensor, Tensor]:
    """(mean, scale) per column; scale = population std, 1 where the column
    is constant (see :func:`_zero_std_tol`)."""
    mean = torch.mean(X, dim=-2)
    std = torch.std(X, dim=-2, correction=0)
    scale = torch.where(std > _zero_std_tol(mean, std.dtype), std, torch.ones_like(std))
    return mean, scale


def test_sse_from_stats(c: Tensor, G_te: Tensor, b_te: Tensor, syy_te: Tensor) -> Tensor:
    """Sum of squared residuals ||X_te c - y_te||^2 from test sufficient stats."""
    quad = torch.einsum("...p,...pq,...q->...", c, G_te, c)
    cross = torch.einsum("...p,...p->...", c, b_te)
    return quad - 2.0 * cross + syy_te


test_sse_from_stats.__test__ = False  # a library function, not a pytest case
