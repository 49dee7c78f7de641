"""Robust sparse-regression family: Huber-IRLS, trimmed, sign-constrained,
bootstrap-ensemble, and the combined robust pipeline.

Port of ``pdx/solve/robust.py``. Every variant is the masked threshold loop
of :mod:`pdx_torch.solve.stridge` with a pluggable masked inner solver.
``pdx`` vmaps the bootstrap members; here they are a leading batch axis
(``X[idx]`` is (B, n_sub, p), the weighted Grams are batched products), so a
30-member ensemble is one batched fit. Bootstrap index sets are drawn on the
host (numpy Generator, the reference's draw order), so both packages fit the
same rows.

Shapes: ``X`` (..., n, p), ``y`` and row weights (..., n), column masks and
coefficients (..., p); leading axes are batch axes.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.linalg import column_standardize_stats, masked_ridge_solve
from pdx_torch.solve.stridge import stridge, threshold_loop


def huber_weight(r: Tensor, delta: float = 1.35) -> Tensor:
    """w = 1 for |r| <= delta else delta/|r| (+1e-12 guard)."""
    abs_r = torch.abs(r)
    return torch.where(abs_r <= delta, torch.ones_like(r), delta / (abs_r + 1e-12))


def median(x: Tensor, dim: int = -1) -> Tensor:
    """The median that averages the two middle values of an even count, as
    ``numpy.median`` does (``torch.median`` returns the lower one)."""
    n = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    return 0.5 * (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2))


def _masked_weighted_ridge(X: Tensor, y: Tensor, w: Tensor, col_mask: Tensor, alpha) -> Tensor:
    """Solve (Xm^T W Xm + alpha I)|support = Xm^T W y with static shapes."""
    Xm = X * col_mask[..., None, :]
    G = Xm.mT @ (Xm * w[..., None])
    b = (Xm.mT @ (w * y)[..., None])[..., 0]
    return masked_ridge_solve(G, b, col_mask, alpha)


def irls_huber(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float = 1e-3,
    delta: float = 1.35,
    max_iter: int = 50,
    tol: float = 1e-6,
    col_mask: Tensor | None = None,
) -> Tensor:
    """IRLS with Huber loss and MAD residual scale.

    Keeps the reference's convergence quirk: on convergence the *previous*
    iterate is returned. Each member of a batch stops on its own: a member
    that has converged is frozen while the others run on, and the loop ends
    when all have converged or after ``max_iter`` steps.
    """
    if col_mask is None:
        col_mask = torch.ones(X.shape[:-2] + X.shape[-1:], dtype=X.dtype, device=X.device)
    Xm = X * col_mask[..., None, :]
    beta = _masked_weighted_ridge(X, y, torch.ones_like(y), col_mask, alpha)
    done = torch.zeros(beta.shape[:-1], dtype=torch.bool, device=X.device)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        r = y - (Xm @ beta[..., None])[..., 0]
        sigma = median(torch.abs(r)) * 1.4826 + 1e-12
        w = huber_weight(r / sigma[..., None], delta=delta)
        beta_new = _masked_weighted_ridge(X, y, w, col_mask, alpha)
        converged = torch.amax(torch.abs(beta_new - beta), dim=-1) < tol
        beta = torch.where((done | converged)[..., None], beta, beta_new)
        done = done | converged
    return beta


def _standardize_data(X: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    mean, scale = column_standardize_stats(X)
    return (X - mean[..., None, :]) / scale[..., None, :], mean, scale


def _make_sign_fn(signs) -> Callable[[Tensor], Tensor] | None:
    if signs is None:
        return None

    def sign_fn(c: Tensor) -> Tensor:
        s = torch.as_tensor(signs, device=c.device)
        wrong = ((s == -1) & (c > 0)) | ((s == 1) & (c < 0))
        return torch.where(wrong, torch.zeros_like(c), c)

    return sign_fn


def _fit(solve_fn, like: Tensor, threshold, max_iter: int, sign_fn=None) -> Tensor:
    """Full-support solve, then the threshold loop; ``like`` gives the
    coefficients' shape, dtype and device."""
    m0 = torch.ones_like(like)
    c, _m = threshold_loop(solve_fn, solve_fn(m0), m0, threshold, max_iter, sign_fn=sign_fn)
    return c


def stridge_huber(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    huber_delta: float = 1.35,
    huber_iter: int = 50,
) -> Tensor:
    """STRidge with Huber-IRLS inner solves."""
    Xs, mean, scale = _standardize_data(X)

    def solve_fn(mask):
        return irls_huber(Xs, y, alpha=alpha, delta=huber_delta, max_iter=huber_iter, col_mask=mask)

    return _fit(solve_fn, mean, threshold, max_iter) / (scale + 1e-12)


def _kept_rows(resid: Tensor, n_trim: int) -> Tensor:
    """Indices of all but the ``n_trim`` largest residuals, smallest first
    (a stable sort, as ``jnp.argsort`` is)."""
    order = torch.argsort(resid, stable=True)
    return order[: resid.shape[0] - n_trim]


def trimmed_stridge(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    trim_frac: float = 0.1,
) -> Tensor:
    """STRidge on residual-trimmed rows: trimming is a 0/1 row-weight vector
    from a sort of the initial fit's residuals."""
    n = X.shape[0]
    Xs, mean, scale = _standardize_data(X)
    w = torch.ones_like(y)
    n_trim = int(n * trim_frac)
    if n_trim > 0:
        c_init = _masked_weighted_ridge(Xs, y, w, torch.ones_like(mean), alpha)
        keep = _kept_rows(torch.abs(y - Xs @ c_init), n_trim)
        w = torch.zeros_like(y)
        w[keep] = 1.0

    def solve_fn(mask):
        return _masked_weighted_ridge(Xs, y, w, mask, alpha)

    return _fit(solve_fn, mean, threshold, max_iter) / (scale + 1e-12)


def stridge_sign_constrained(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    signs: list[int] | None = None,
) -> Tensor:
    """STRidge with physics-informed sign constraints: wrong-signed
    coefficients are zeroed before thresholding and again after each refit."""
    Xs, mean, scale = _standardize_data(X)
    ones_rows = torch.ones_like(y)

    def solve_fn(mask):
        return _masked_weighted_ridge(Xs, y, ones_rows, mask, alpha)

    c = _fit(solve_fn, mean, threshold, max_iter, sign_fn=_make_sign_fn(signs))
    return c / (scale + 1e-12)


def bootstrap_indices(n: int, n_sub: int, n_bootstrap: int, seed: int) -> np.ndarray:
    """Host-side bootstrap index sets, reference draw order
    (np.random.default_rng(seed).choice(n, n_sub, replace=True) per member)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(n, size=n_sub, replace=True) for _ in range(n_bootstrap)])


def ensemble_stridge(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    n_bootstrap: int = 50,
    subsample_frac: float = 0.7,
    seed: int = 0,
    use_huber: bool = False,
    huber_delta: float = 1.35,
) -> tuple[Tensor, Tensor]:
    """Bootstrap-ensemble STRidge: every member is restandardized and fitted
    in one batch; aggregation is the median, with the std for uncertainty."""
    n = y.shape[0]
    n_sub = max(int(n * subsample_frac), 1)
    idx = torch.as_tensor(bootstrap_indices(n, n_sub, n_bootstrap, seed), device=X.device)
    kw = dict(alpha=alpha, threshold=threshold, max_iter=max_iter)
    if use_huber:
        all_coeffs = stridge_huber(X[idx], y[idx], huber_delta=huber_delta, huber_iter=50, **kw)
    else:
        all_coeffs = stridge(X[idx], y[idx], **kw)
    return median(all_coeffs, dim=0), torch.std(all_coeffs, dim=0, correction=0)


def robust_stridge(
    X: Tensor,
    y: Tensor,
    *,
    alpha: float = 1e-3,
    threshold: float = 1e-6,
    max_iter: int = 25,
    use_huber: bool = True,
    huber_delta: float = 1.35,
    trim_frac: float = 0.05,
    n_bootstrap: int = 30,
    signs: list[int] | None = None,
    bootstrap_seed: int = 42,
) -> tuple[Tensor, dict]:
    """Combined robust pipeline: trim -> bootstrap{(Huber|ridge) + STRidge
    thresholding + sign constraints} -> median/std/95% CI.

    The reference standardizes once globally; bootstrap members are NOT
    restandardized, and the signs are applied once after each member's loop.
    """
    n = X.shape[0]
    Xs, mean, scale = _standardize_data(X)
    Xs_clean, y_clean = Xs, y
    n_trim = int(n * trim_frac)
    if n_trim > 0:
        c_init = _masked_weighted_ridge(Xs, y, torch.ones_like(y), torch.ones_like(mean), alpha)
        keep = _kept_rows(torch.abs(y - Xs @ c_init), n_trim)
        Xs_clean, y_clean = Xs[keep], y[keep]
    n_clean = n - n_trim

    idx = torch.as_tensor(
        bootstrap_indices(n_clean, int(n_clean * 0.8), n_bootstrap, bootstrap_seed), device=X.device
    )
    X_sub, y_sub = Xs_clean[idx], y_clean[idx]  # (B, n_sub, p), (B, n_sub)
    if use_huber:
        def solve_fn(mask):
            return irls_huber(X_sub, y_sub, alpha=alpha, delta=huber_delta, col_mask=mask)
    else:
        ones_sub = torch.ones_like(y_sub)

        def solve_fn(mask):
            return _masked_weighted_ridge(X_sub, y_sub, ones_sub, mask, alpha)

    all_coeffs = _fit(solve_fn, X_sub[:, 0, :], threshold, max_iter)  # (B, p)
    sign_fn = _make_sign_fn(signs)
    if sign_fn is not None:
        all_coeffs = sign_fn(all_coeffs)

    denom = scale + 1e-12
    q = torch.tensor([0.025, 0.975], dtype=X.dtype, device=X.device)
    ci = torch.quantile(all_coeffs, q, dim=0)
    info = {
        "std": torch.std(all_coeffs, dim=0, correction=0) / denom,
        "ci_95_low": ci[0] / denom,
        "ci_95_high": ci[1] / denom,
        "n_trimmed": n_trim,
        "n_bootstrap": n_bootstrap,
    }
    return median(all_coeffs, dim=0) / denom, info
