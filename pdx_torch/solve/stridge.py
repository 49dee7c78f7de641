"""STRidge (sequentially thresholded ridge) — masked, static-shape, batched.

Port of ``pdx/solve/stridge.py``: standardize the Gram statistics,
ridge-solve, then up to ``max_iter`` times zero |c| < threshold and refit on
the surviving support, then unscale by /(scale + 1e-12). ``pdx`` runs all
``max_iter`` iterations because the loop is a fixed-point iteration (once
the support stops changing the masked solve returns the same coefficients,
and the all-small case drives the mask to zero, itself a fixed point); the
eager loop here stops at that fixed point, which gives the same result.
``pdx`` vmaps a grid; here the (alpha, threshold) grid is a leading (A, T)
batch and each iteration is one batched solve, on the Gram statistics
(:func:`stridge_grid`) or by QR of the data matrix (:func:`stridge_qr_grid`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import Tensor

from pdx_torch.ops.linalg import (
    column_standardize_stats,
    gram_stats,
    masked_ridge_solve,
    standardized_stats,
)


@dataclass
class StridgeResult:
    coeffs: Tensor  # unscaled coefficients in original column units
    mask: Tensor  # final support mask
    n_active: Tensor


def threshold_loop(
    solve_fn: Callable[[Tensor], Tensor],
    c0: Tensor,
    m0: Tensor,
    threshold: float | Tensor,
    max_iter: int,
    sign_fn: Callable[[Tensor], Tensor] | None = None,
) -> tuple[Tensor, Tensor]:
    """The STRidge threshold loop with a pluggable masked solver, shared by
    every variant. ``solve_fn(mask)`` -> coefficients on that support (zeros
    elsewhere), a function of the mask alone; ``sign_fn(c)`` -> c with
    wrong-signed entries zeroed. ``c0`` and ``m0`` are (*B, p), ``threshold``
    a float or a tensor of the batch shape B.

    Stops once no mask of the batch changed: the next solve would repeat
    this one, so running on to ``max_iter`` changes nothing.
    """
    threshold = torch.as_tensor(threshold, dtype=c0.dtype, device=c0.device)[..., None]
    c, m = c0, m0
    for _ in range(max_iter):
        if sign_fn is not None:
            c = sign_fn(c)
        small = torch.abs(c) < threshold
        all_small = torch.all(small | (m <= 0), dim=-1, keepdim=True)
        # support shrinks monotonically; all-small zeroes the mask entirely
        m_new = torch.where(all_small, torch.zeros_like(m), m * (~small).to(m.dtype))
        if torch.equal(m_new, m):
            break
        c, m = solve_fn(m_new), m_new
        if sign_fn is not None:
            c = sign_fn(c)
    return c, m


def _stridge_iterations(
    Gs: Tensor,
    bs: Tensor,
    alpha: float | Tensor,
    threshold: float | Tensor,
    max_iter: int,
    init_mask: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Core masked iteration on standardized stats. Returns (coeffs_std, mask).

    ``alpha`` and ``threshold`` are floats or tensors of one batch shape B;
    ``bs`` is then (*B, p) (or broadcasts to it) and every solve is batched.
    ``init_mask`` restricts the fit to a column subset from the start.
    """
    batch = torch.as_tensor(threshold).shape
    mask0 = torch.ones_like(bs) if init_mask is None else init_mask.to(Gs.dtype)
    m0 = mask0.expand(torch.broadcast_shapes(batch + (1,), bs.shape))

    def solve_fn(m: Tensor) -> Tensor:
        return masked_ridge_solve(Gs, bs, m, alpha)

    return threshold_loop(solve_fn, solve_fn(m0), m0, threshold, max_iter)


def stridge_from_stats(
    stats: dict[str, Tensor],
    *,
    alpha: float | Tensor = 1e-3,
    threshold: float | Tensor = 1e-6,
    max_iter: int = 25,
    init_mask: Tensor | None = None,
) -> StridgeResult:
    """STRidge from raw sufficient statistics (see :func:`gram_stats`)."""
    Gs, bs, _mean, scale = standardized_stats(stats)
    c_std, mask = _stridge_iterations(Gs, bs, alpha, threshold, max_iter, init_mask)
    coeffs = c_std / (scale + 1e-12)
    return StridgeResult(coeffs=coeffs, mask=mask, n_active=torch.sum(mask > 0, dim=-1))


def stridge(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    weights: Tensor | None = None,
) -> Tensor:
    """Drop-in equivalent of the reference ``stridge(X, y, ...)``, returning
    unscaled coefficients."""
    stats = gram_stats(X, y, weights)
    return stridge_from_stats(stats, alpha=alpha, threshold=threshold, max_iter=max_iter).coeffs


def stridge_grid(
    stats: dict[str, Tensor],
    alphas: Tensor,
    thresholds: Tensor,
    *,
    max_iter: int = 25,
) -> tuple[Tensor, Tensor]:
    """STRidge over a full alpha x threshold grid: every iteration is one
    batched (A, T, p, p) solve. Returns (coeffs[(A, T, p)], masks[(A, T, p)])."""
    Gs, bs, _mean, scale = standardized_stats(stats)
    alphas = torch.as_tensor(alphas, dtype=Gs.dtype, device=Gs.device)
    thresholds = torch.as_tensor(thresholds, dtype=Gs.dtype, device=Gs.device)
    a_grid = alphas[:, None].expand(len(alphas), len(thresholds))
    t_grid = thresholds[None, :].expand(len(alphas), len(thresholds))
    c_std, masks = _stridge_iterations(Gs, bs, a_grid, t_grid, max_iter)
    return c_std / (scale + 1e-12), masks


# ---------------------------------------------------------------------------
# QR-based STRidge: identical algorithm, data-matrix solves
# ---------------------------------------------------------------------------


def _masked_ridge_qr(Xs: Tensor, y: Tensor, mask: Tensor, alpha: float | Tensor) -> Tensor:
    """Ridge solve on the active support via QR of the augmented matrix
    [X*m ; sqrt(alpha) diag(m) + diag(1-m)]: the minimizer of the Gram path,
    conditioned as cond(X) instead of cond(X)^2, which is what float32 needs
    on an ill-conditioned dictionary (the 9-term rich KS library).

    ``mask`` is (*B, p) and ``alpha`` a float or a tensor of the batch shape
    B: the augmented matrices differ only through them, so one batched
    ``torch.linalg.qr`` serves the whole batch. Q's signs are the
    library's own; the solution does not depend on them."""
    n, p = Xs.shape[-2:]
    m = mask.to(Xs.dtype)
    sqrt_a = torch.sqrt(torch.as_tensor(alpha, dtype=Xs.dtype, device=Xs.device))[..., None, None]
    eye = torch.eye(p, dtype=Xs.dtype, device=Xs.device)
    Xm = Xs * m[..., None, :]
    aug = sqrt_a * eye * m[..., None, :] + eye * (1.0 - m)[..., None, :]
    A = torch.cat([Xm, aug.expand(Xm.shape[:-2] + (p, p))], dim=-2)
    Q, R = torch.linalg.qr(A, mode="reduced")
    # Q^T [y; 0]: the p augmented rows meet zeros
    qty = Q[..., :n, :].mT @ y[..., None]
    return torch.linalg.solve_triangular(R, qty, upper=True)[..., 0] * m


def stridge_qr(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float | Tensor = 1e-3,
    threshold: float | Tensor = 1e-6,
    max_iter: int = 25,
) -> Tensor:
    """STRidge with QR inner solves (the reference algorithm, better float32
    conditioning). Returns unscaled coefficients; ``alpha`` and ``threshold``
    may be tensors of one batch shape B, and the result is then (*B, p)."""
    mean, scale = column_standardize_stats(X)
    Xs = (X - mean) / scale
    batch = torch.broadcast_shapes(torch.as_tensor(alpha).shape, torch.as_tensor(threshold).shape)
    m0 = torch.ones(batch + X.shape[-1:], dtype=X.dtype, device=X.device)

    def solve_fn(m: Tensor) -> Tensor:
        return _masked_ridge_qr(Xs, y, m, alpha)

    c, _m = threshold_loop(solve_fn, solve_fn(m0), m0, threshold, max_iter)
    return c / (scale + 1e-12)


def stridge_qr_grid(
    X: Tensor,
    y: Tensor,
    alphas: Tensor,
    thresholds: Tensor,
    *,
    max_iter: int = 25,
) -> Tensor:
    """:func:`stridge_qr` over a full alpha x threshold grid, every iteration
    one batched QR of (A, T, n + p, p). Returns coeffs[(A, T, p)]."""
    alphas = torch.as_tensor(alphas, dtype=X.dtype, device=X.device)
    thresholds = torch.as_tensor(thresholds, dtype=X.dtype, device=X.device)
    a_grid = alphas[:, None].expand(len(alphas), len(thresholds))
    t_grid = thresholds[None, :].expand(len(alphas), len(thresholds))
    return stridge_qr(X, y, alpha=a_grid, threshold=t_grid, max_iter=max_iter)
