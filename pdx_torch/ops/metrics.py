"""Regression and fit metrics (port of ``pdx/ops/metrics.py``).

Every reduction runs over the last axis; leading axes are a batch (one row
of metrics per patch, where ``pdx`` vmaps). For 1-D inputs each function
returns the scalar ``pdx`` returns.
"""

from __future__ import annotations

import torch
from torch import Tensor


def rmse(y_true: Tensor, y_pred: Tensor) -> Tensor:
    return torch.sqrt(torch.mean((y_true - y_pred) ** 2, dim=-1))


def r2_score(y_true: Tensor, y_pred: Tensor) -> Tensor:
    """R^2 with the reference's +1e-18 total-sum-of-squares guard."""
    ss_res = torch.sum((y_true - y_pred) ** 2, dim=-1)
    ss_tot = torch.sum((y_true - torch.mean(y_true, dim=-1, keepdim=True)) ** 2, dim=-1)
    return 1.0 - ss_res / (ss_tot + 1e-18)


def nrmse(y_true: Tensor, y_pred: Tensor) -> Tensor:
    """RMSE over the population std of y_true (+1e-12 guard)."""
    return rmse(y_true, y_pred) / (torch.std(y_true, dim=-1, correction=0) + 1e-12)


def mae(y_true: Tensor, y_pred: Tensor) -> Tensor:
    return torch.mean(torch.abs(y_true - y_pred), dim=-1)


def pearson_corr(y_true: Tensor, y_pred: Tensor) -> Tensor:
    """Pearson correlation with an epsilon-guarded denominator."""
    yt = y_true - torch.mean(y_true, dim=-1, keepdim=True)
    yp = y_pred - torch.mean(y_pred, dim=-1, keepdim=True)
    denom = torch.sqrt(torch.sum(yt**2, dim=-1)) * torch.sqrt(torch.sum(yp**2, dim=-1)) + 1e-18
    return torch.sum(yt * yp, dim=-1) / denom


def regression_metrics(y_true: Tensor, y_pred: Tensor) -> dict[str, Tensor]:
    """rmse, r2, nrmse, mae and corr (analyze_results.py:136-154)."""
    return {
        "rmse": rmse(y_true, y_pred),
        "r2": r2_score(y_true, y_pred),
        "nrmse": nrmse(y_true, y_pred),
        "mae": mae(y_true, y_pred),
        "corr": pearson_corr(y_true, y_pred),
    }


def _masked_median(x: Tensor, mask: Tensor) -> Tensor:
    """Median of x over the mask's entries, the middle pair averaged for an
    even count (``jnp.nanmedian`` of x with the rest set to NaN; NaN for an
    empty mask)."""
    s = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values  # masked-out entries sort last
    n = torch.sum(mask, dim=-1, keepdim=True)
    lo = torch.gather(s, -1, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(s, -1, n // 2)
    med = (0.5 * (lo + hi))[..., 0]
    return torch.where(n[..., 0] > 0, med, torch.nan)


def masked_regression_metrics(y_true: Tensor, y_pred: Tensor, mask: Tensor) -> dict[str, Tensor]:
    """:func:`regression_metrics` of the subset ``y[mask]``, plus the median
    absolute residual there, with static shapes."""
    w = mask.to(y_true.dtype)
    n = torch.sum(w, dim=-1)
    d = y_true - y_pred
    my = (torch.sum(w * y_true, dim=-1) / n)[..., None]
    mp = (torch.sum(w * y_pred, dim=-1) / n)[..., None]
    ss_res = torch.sum(w * d * d, dim=-1)
    ss_tot = torch.sum(w * (y_true - my) ** 2, dim=-1)
    rmse_m = torch.sqrt(ss_res / n)
    yt = y_true - my
    yp = y_pred - mp
    denom = torch.sqrt(torch.sum(w * yt * yt, dim=-1)) * torch.sqrt(torch.sum(w * yp * yp, dim=-1)) + 1e-18
    return {
        "rmse": rmse_m,
        "r2": 1.0 - ss_res / (ss_tot + 1e-18),
        "nrmse": rmse_m / (torch.sqrt(ss_tot / n) + 1e-12),
        "mae": torch.sum(w * torch.abs(d), dim=-1) / n,
        "corr": torch.sum(w * yt * yp, dim=-1) / denom,
        "resid_med_abs": _masked_median(torch.abs(d), mask.to(torch.bool)),
    }


def f1_support_score(est: Tensor, true: Tensor, tol: float = 1e-8) -> Tensor:
    """F1 score on coefficient support (notebook 10 compute_f1_score)."""
    est_active = torch.abs(est) > tol
    true_active = torch.abs(true) > tol
    tp, fp, fn = (
        torch.sum(a & b, dim=-1).to(est.dtype)
        for a, b in ((est_active, true_active), (est_active, ~true_active), (~est_active, true_active))
    )
    precision = tp / torch.clamp(tp + fp, min=1)
    recall = tp / torch.clamp(tp + fn, min=1)
    return 2.0 * precision * recall / torch.clamp(precision + recall, min=1e-12)


def coefficient_relative_errors(est: Tensor, true: Tensor) -> Tensor:
    """Per-term relative error in percent (ks2d_stridge_benchmark.py:1786-1791)."""
    return torch.abs(est - true) / (torch.abs(true) + 1e-12) * 100.0
