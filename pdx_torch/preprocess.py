"""Denoising / preprocessor bank and the preprocessing head of the
real-image pipelines (port of ``pdx/preprocess.py``).

The bank (comprehensive_benchmark.py:168-239): Gaussian, median, the
reference's TV iteration, the bilateral approximation, the clamped temporal
window mean, the per-frame z-score, the global exponential detrend, and the
adaptive policy; with them the Poisson-noise diagnostic. Every one acts on a
(T, H, W) stack, batched over frames. Standard deviations are the
population's (``correction=0``), as ``jnp.std``'s.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch import resolve_dtype
from pdx_torch.ops.filters import (
    gaussian_filter_reflect,
    median_filter_2d,
    median_filter_3x3,
    savgol_time,
    tv_denoise,
    tv_denoise_curvature,
)
from pdx_torch.ops.interp import resize_area


def resize_denoise_normalize(
    U_raw: Tensor, *, out_h: int, out_w: int, sigma: float, eps: float = 0.0,
    dtype_name: str = "float64",
) -> Tensor:
    """INTER_AREA downsample -> cast -> Gaussian denoise -> min-max normalise.

    The downsample runs at the input dtype before the cast, as in ``pdx``:
    for uint8 / uint16 frames the 2x block mean is exact in float32 (sums of
    at most four integers are representable), so the result equals the
    cast-first order while the first pass reads the raw bytes.
    """
    U = resize_area(U_raw, out_h, out_w).to(resolve_dtype(dtype_name))
    U = gaussian_filter_reflect(U, sigma)
    return (U - U.min()) / (U.max() - U.min() + eps)


def preprocess_none(U: Tensor) -> Tensor:
    return U


def preprocess_gaussian(U: Tensor, sigma: float = 1.0) -> Tensor:
    return gaussian_filter_reflect(U, sigma)


def preprocess_median(U: Tensor, size: int = 3) -> Tensor:
    """Odd-size median filter (the reference exposes ``size``; it only ever
    calls 3)."""
    return median_filter_2d(U, size)


def preprocess_tv(U: Tensor, weight: float = 0.1, n_iter: int = 50) -> Tensor:
    return tv_denoise(U, weight=weight, n_iter=n_iter)


def preprocess_bilateral(U: Tensor, sigma_s: float = 2.0, sigma_r: float = 0.1) -> Tensor:
    """Bilateral-like filtering (comprehensive_benchmark.py:204-212)."""
    smoothed = gaussian_filter_reflect(U, sigma_s)
    diff = U - smoothed
    w = torch.exp(-(diff**2) / (2.0 * sigma_r**2))
    return w * U + (1.0 - w) * smoothed


def preprocess_temporal(U: Tensor, window: int = 3) -> Tensor:
    """Clamped temporal window mean (comprehensive_benchmark.py:214-221):
    frame i averages frames [max(0, i - h), min(T, i + h + 1)), so the edge
    windows shrink rather than reflect. A difference of cumulative sums."""
    T = U.shape[0]
    half = window // 2
    cs = torch.cat([torch.zeros_like(U[:1]), torch.cumsum(U, dim=0)], dim=0)  # (T + 1, ...)
    i = torch.arange(T, device=U.device)
    lo = torch.clamp(i - half, min=0)
    hi = torch.clamp(i + half + 1, max=T)
    counts = (hi - lo).to(U.dtype).reshape((-1,) + (1,) * (U.ndim - 1))
    return (cs[hi] - cs[lo]) / counts


def preprocess_detrend(U: Tensor) -> Tensor:
    """Per-frame z-score (comprehensive_benchmark.py:223-229)."""
    mean = U.mean(dim=(-2, -1), keepdim=True)
    std = U.std(dim=(-2, -1), keepdim=True, correction=0)
    return (U - mean) / (std + 1e-10)


def preprocess_detrend_global(U: Tensor) -> Tensor:
    """Divide out a global exponential intensity trend fitted in log space
    (closed-form line), then z-score the whole stack
    (comprehensive_benchmark.py:231-239)."""
    T = U.shape[0]
    means = U.mean(dim=(-2, -1))
    t = torch.arange(T, dtype=U.dtype, device=U.device)
    log_means = torch.log(torch.abs(means) + 1e-10)
    tbar = t.mean()
    lbar = log_means.mean()
    slope = torch.sum((t - tbar) * (log_means - lbar)) / torch.sum((t - tbar) ** 2)
    intercept = lbar - slope * tbar
    trend = torch.exp(slope * t + intercept)
    out = U / (trend[:, None, None] + 1e-10)
    return (out - out.mean()) / (out.std(correction=0) + 1e-10)


def preprocess_adaptive(U: Tensor, noise_type: str = "gaussian", noise_level: float = 0.1) -> Tensor:
    """Adaptive denoising policy (notebook 08 ``denoise_adaptive``): from
    temporal Savitzky-Golay, to that plus a light spatial Gaussian, to that
    plus curvature TV as the noise level grows; median first for impulse
    noise."""
    if noise_type == "gaussian":
        if noise_level <= 0.1:
            return savgol_time(U, 5, 2)
        if noise_level <= 0.5:
            return gaussian_filter_reflect(savgol_time(U, 5, 2), 0.3)
        out = gaussian_filter_reflect(savgol_time(U, 7, 2), 0.5)
        return tv_denoise_curvature(out, weight=0.05, n_iter=2)
    # impulse (salt and pepper) noise
    if noise_level <= 0.1:
        return median_filter_3x3(U)
    return savgol_time(median_filter_3x3(U), 5, 2)


def _linspace(lo: Tensor, hi: Tensor, num: int) -> Tensor:
    """``jnp.linspace(lo, hi, num)``: lo * (1 - s) + hi * s with s = i / (num
    - 1), and hi itself as the last point (``torch.linspace`` rounds
    otherwise)."""
    div = num - 1
    step = torch.arange(div, dtype=lo.dtype, device=lo.device) / div
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def poisson_noise_check(U: Tensor, n_bins: int = 20) -> dict[str, Tensor]:
    """Photon-noise diagnostic (notebook 09): bin the pixels by their mean
    over frames and regress their variance over frames on it. A slope ~ 1
    (in photon units) points to Poisson noise, ~ 0 to additive Gaussian
    noise. Bins with 10 pixels or fewer are left out of the fit."""
    mean_px = torch.mean(U, dim=0).reshape(-1)
    var_px = torch.var(U, dim=0, correction=0).reshape(-1)
    q = torch.quantile(mean_px, torch.tensor([0.02, 0.98], dtype=mean_px.dtype, device=U.device))
    edges = _linspace(q[0], q[1], n_bins + 1)
    idx = torch.clamp(torch.searchsorted(edges, mean_px) - 1, 0, n_bins - 1)
    acc = torch.promote_types(U.dtype, torch.float64)

    def binned(v: Tensor) -> Tensor:
        return torch.zeros(n_bins, dtype=acc, device=U.device).index_add_(0, idx, v.to(acc))

    counts = binned(torch.ones_like(mean_px))
    mean_bin = binned(mean_px) / torch.clamp(counts, min=1)
    var_bin = binned(var_px) / torch.clamp(counts, min=1)
    valid = counts > 10
    zero = torch.zeros((), dtype=acc, device=U.device)
    x = torch.where(valid, mean_bin, zero)
    y = torch.where(valid, var_bin, zero)
    n = torch.sum(valid)
    xm = torch.sum(x) / n
    ym = torch.sum(y) / n
    cov = torch.sum(torch.where(valid, (x - xm) * (y - ym), zero))
    varx = torch.sum(torch.where(valid, (x - xm) ** 2, zero))
    slope = cov / (varx + 1e-30)
    return {
        "slope": slope,
        "intercept": ym - slope * xm,
        "mean_bins": mean_bin,
        "var_bins": var_bin,
        "bin_counts": counts,
    }


PREPROCESSORS = {
    "none": preprocess_none,
    "gaussian": preprocess_gaussian,
    "median": preprocess_median,
    "tv": preprocess_tv,
    "bilateral": preprocess_bilateral,
    "temporal": preprocess_temporal,
    "detrend": preprocess_detrend,
    "detrend_global": preprocess_detrend_global,
    "adaptive": preprocess_adaptive,
}
