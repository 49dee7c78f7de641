"""STRidge (sequentially thresholded ridge) — masked, static-shape, batched.

Port of ``pdx/solve/stridge.py:43-96, 177-205``: standardize the Gram
statistics, ridge-solve, then ``max_iter`` times zero |c| < threshold and
refit on the surviving support, then unscale by /(scale + 1e-12). The
reference's early ``break`` is a fixed-point iteration (once the support
stops changing the masked solve is idempotent, and the all-small case drives
the mask to zero, itself a fixed point), so the loop always runs all
``max_iter`` iterations. ``pdx`` vmaps a grid; here the (alpha, threshold)
grid is a leading (A, T) batch and each iteration is one batched solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from pdx_torch.ops.linalg import gram_stats, masked_ridge_solve, standardized_stats


@dataclass
class StridgeResult:
    coeffs: Tensor  # unscaled coefficients in original column units
    mask: Tensor  # final support mask
    n_active: Tensor


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
    threshold = torch.as_tensor(threshold, dtype=Gs.dtype, device=Gs.device)[..., None]
    mask0 = torch.ones_like(bs) if init_mask is None else init_mask.to(Gs.dtype)
    m = mask0.expand(torch.broadcast_shapes(threshold.shape, bs.shape))
    c = masked_ridge_solve(Gs, bs, m, alpha)
    for _ in range(max_iter):
        small = torch.abs(c) < threshold
        all_small = torch.all(small | (m <= 0), dim=-1, keepdim=True)
        # support shrinks monotonically; all-small zeroes the mask entirely
        m = torch.where(all_small, torch.zeros_like(m), m * (~small).to(m.dtype))
        c = masked_ridge_solve(Gs, bs, m, alpha)
    return c, m


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
