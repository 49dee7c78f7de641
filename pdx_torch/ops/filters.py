"""Smoothing filters (port of ``pdx/ops/filters.py``).

``time_smooth_moving_average`` smooths along axis 0 with reflect padding;
``smooth_1d`` along the trailing axis with edge padding. Both sum a window
as a difference of cumulative sums, as ``pdx`` does.

``gaussian_filter_reflect`` and ``gaussian_filter1d_reflect`` are
scipy.ndimage's Gaussian filter with its default "reflect" border, which is
numpy's **symmetric** padding: the edge sample is repeated
(``torch.nn.functional.pad(mode="reflect")`` does not repeat it and is not
this border). Each axis pass is one gather of the padded line and one product
of its sliding windows with the taps, where ``pdx`` adds shifted copies tap by
tap; the two sum the same products in another order.

``savgol_time`` is scipy's Savitzky-Golay filter along axis 0 with
``mode="interp"`` edges; its taps and edge projectors are computed on the
host in float64, as ``pdx`` does.

The comprehensive benchmark's bank: ``median_filter_2d`` (scipy's median
filter with its "reflect" border: the k^2 shifted views of the symmetric pad,
sorted, the middle one taken), ``tv_denoise`` (re-anchored to the input
every step) and ``tv_denoise_curvature`` (``jnp.gradient``'s one-sided
first-order edges), each step in ``pdx``'s operation order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.fd import _gradient_edge1


def time_smooth_moving_average(U: Tensor, window: int) -> Tensor:
    """Centred moving average along axis 0 with reflect padding (numpy's
    ``mode="reflect"``: the edge frame is not repeated). Odd windows only."""
    window = int(window)
    if window <= 1:
        return U
    if window % 2 == 0:
        raise ValueError("temporal moving-average window must be an odd integer")
    pad = window // 2
    T = U.shape[0]
    # reflected frame index, period 2(T-1): ... 2 1 | 0 1 ... T-1 | T-2 ...
    idx = torch.arange(-pad, T + pad, device=U.device)
    if T > 1:
        idx = torch.remainder(idx, 2 * (T - 1))
        idx = torch.where(idx >= T, 2 * (T - 1) - idx, idx)
    else:
        idx = torch.zeros_like(idx)
    U_pad = U[idx]
    cs = torch.cat([torch.zeros_like(U_pad[:1]), torch.cumsum(U_pad, dim=0)], dim=0)
    return (cs[window:] - cs[:-window]) / float(window)


def smooth_1d(x: Tensor, window: int) -> Tensor:
    """Centred moving average on the trailing axis with edge padding; an
    even window is bumped to the next odd one."""
    w = int(window)
    if w <= 1:
        return x
    if w % 2 == 0:
        w += 1
    pad = w // 2
    n = x.shape[-1]
    idx = torch.clamp(torch.arange(-pad, n + pad, device=x.device), 0, n - 1)
    xp = x[..., idx]
    cs = torch.cat([torch.zeros_like(xp[..., :1]), torch.cumsum(xp, dim=-1)], dim=-1)
    return (cs[..., w:] - cs[..., :-w]) / float(w)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d semantics (order 0), float64."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    return phi / phi.sum()


def _reflect_sym_np(idx: np.ndarray, L: int) -> np.ndarray:
    """np.pad(mode="symmetric") index folding; folds again while any index
    is still outside [0, L), so taps that outnumber the pixels work."""
    idx = np.asarray(idx).copy()
    while ((idx < 0) | (idx >= L)).any():
        idx = np.where(idx < 0, -1 - idx, idx)
        idx = np.where(idx >= L, 2 * L - 1 - idx, idx)
    return idx


@lru_cache(maxsize=256)
def _sym_pad_index(L: int, n: int, device: torch.device) -> Tensor:
    """Indices of a line of length L padded by n on each side, symmetric."""
    return torch.as_tensor(_reflect_sym_np(np.arange(-n, L + n), L), device=device)


def symmetric_windows(x: Tensor, K: int, dim: int) -> Tensor:
    """Sliding windows of K samples along ``dim`` after symmetric padding by
    K // 2 on each side: x's shape with ``dim`` moved last, plus a trailing
    axis of K. A product with a (K,) kernel correlates; with a (K, C)
    matrix, C kernels at once."""
    xp = x.index_select(dim, _sym_pad_index(x.shape[dim], K // 2, x.device))
    return xp.movedim(dim, -1).unfold(-1, K, 1)


def correlate1d_symmetric(x: Tensor, k: Tensor, dim: int) -> Tensor:
    """``x`` correlated along ``dim`` with the odd-length kernel ``k`` under
    symmetric padding (scipy's "reflect"); same shape as ``x``."""
    return (symmetric_windows(x, k.shape[0], dim) @ k).movedim(-1, dim)


@lru_cache(maxsize=64)
def _gaussian_taps(sigma: float, truncate: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    radius = int(truncate * sigma + 0.5)
    return torch.as_tensor(_gaussian_kernel1d(sigma, radius), dtype=dtype, device=device)


def gaussian_filter_reflect(f: Tensor, sigma: float, truncate: float = 4.0) -> Tensor:
    """Separable Gaussian filter on the trailing two axes, matching
    scipy.ndimage.gaussian_filter's defaults: radius
    ``int(truncate * sigma + 0.5)``, symmetric border."""
    sigma = float(sigma)
    if sigma <= 0:
        return f
    k = _gaussian_taps(sigma, float(truncate), f.dtype, f.device)
    return correlate1d_symmetric(correlate1d_symmetric(f, k, f.ndim - 2), k, f.ndim - 1)


def gaussian_filter1d_reflect(x: Tensor, sigma: float, axis: int = -1, truncate: float = 4.0) -> Tensor:
    """1-D scipy-compatible Gaussian filter along ``axis``."""
    sigma = float(sigma)
    if sigma <= 0:
        return x
    k = _gaussian_taps(sigma, float(truncate), x.dtype, x.device)
    return correlate1d_symmetric(x, k, axis % x.ndim)


def _savgol_coeffs(window: int, polyorder: int) -> np.ndarray:
    """Savitzky-Golay smoothing coefficients (scipy.signal.savgol_coeffs,
    deriv=0): the least-squares fit of a degree-``polyorder`` polynomial over
    the centred window, evaluated at the centre."""
    if window % 2 == 0:
        raise ValueError("savgol window must be odd")
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)  # (window, p+1)
    rhs = np.zeros(polyorder + 1)
    rhs[0] = 1.0
    return A @ np.linalg.solve(A.T @ A, rhs)  # (window,)


@lru_cache(maxsize=32)
def _savgol_operators(T: int, window: int, polyorder: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host float64 (interior (T - 2h, T), first (h, window), last (h,
    window)): the interior taps laid out as a banded matrix over the frames,
    and the edge rows of the projector onto degree-``polyorder`` polynomials
    over the first / last ``window`` frames."""
    half = window // 2
    coeffs = _savgol_coeffs(window, polyorder)
    interior = np.zeros((T - 2 * half, T))
    for i in range(window):
        interior[np.arange(T - 2 * half), np.arange(T - 2 * half) + i] = coeffs[i]
    A = np.vander(np.arange(window, dtype=np.float64), polyorder + 1, increasing=True)
    proj = A @ np.linalg.solve(A.T @ A, A.T)  # (window, window)
    return interior, proj[:half], proj[window - half :]


def savgol_time(U: Tensor, window: int, polyorder: int) -> Tensor:
    """Savitzky-Golay filter along axis 0 with scipy's ``mode="interp"``
    edges: the interior is the correlation with the smoothing taps; the
    first and last ``window // 2`` frames are the exact polynomial
    least-squares fit over the first / last ``window`` frames, evaluated at
    their positions. Each part is one contraction over the frame axis."""
    window = int(window)
    polyorder = int(polyorder)
    T = U.shape[0]
    if window > T:
        raise ValueError("savgol window longer than sequence")
    interior, first, last = (
        torch.as_tensor(m, dtype=U.dtype, device=U.device) for m in _savgol_operators(T, window, polyorder)
    )
    flat = U.reshape(T, -1)
    out = torch.cat([first @ flat[:window], interior @ flat, last @ flat[T - window :]])
    return out.reshape(U.shape)


def gaussian_filter3d_reflect(U: Tensor, sigma_t: float, sigma_s: float, truncate: float = 4.0) -> Tensor:
    """Separable 3-D (t, y, x) Gaussian with scipy's reflect border: scipy's
    ``gaussian_filter`` with a (sigma_t, sigma_s, sigma_s) tuple."""
    out = U
    if sigma_t > 0:
        out = gaussian_filter1d_reflect(out, sigma_t, axis=0, truncate=truncate)
    if sigma_s > 0:
        out = gaussian_filter_reflect(out, sigma_s, truncate=truncate)
    return out


def median_filter_3x3(f: Tensor) -> Tensor:
    """3x3 median filter with scipy's "reflect" (symmetric) border."""
    return median_filter_2d(f, 3)


def median_filter_2d(f: Tensor, size: int = 3) -> Tensor:
    """Odd-size k x k median filter on the trailing two axes with scipy's
    "reflect" (symmetric) border, batched over the leading axes: the k^2
    shifted views of the padded field stacked on a trailing axis and sorted,
    the middle one taken (an odd count, so it is the median itself)."""
    k = int(size)
    if k < 1 or k % 2 == 0:
        raise ValueError(f"median filter size must be odd and >= 1, got {size}")
    if k == 1:
        return f
    n = k // 2
    H, W = f.shape[-2], f.shape[-1]
    p = f.index_select(f.ndim - 2, _sym_pad_index(H, n, f.device))
    p = p.index_select(f.ndim - 1, _sym_pad_index(W, n, f.device))
    stack = torch.stack([p[..., i : i + H, j : j + W] for i in range(k) for j in range(k)], dim=-1)
    return torch.sort(stack, dim=-1).values[..., (k * k) // 2]


def tv_denoise(f: Tensor, weight: float = 0.1, n_iter: int = 50) -> Tensor:
    """The reference's TV-flavoured smoothing on the trailing two axes:
    forward differences with wrap, the divergence of the normalised
    gradient, and ``u = f + weight * div``, which re-anchors to the input
    every step."""
    u = f
    for _ in range(int(n_iter)):
        gx = torch.roll(u, -1, -2) - u
        gy = torch.roll(u, -1, -1) - u
        norm = torch.sqrt(gx**2 + gy**2 + 1e-8)
        div = (gx - torch.roll(gx, 1, -2)) / norm + (gy - torch.roll(gy, 1, -1)) / norm
        u = f + weight * div
    return u


def tv_denoise_curvature(f: Tensor, weight: float = 0.05, n_iter: int = 3) -> Tensor:
    """Curvature-flow TV variant: ``img += weight * div(grad img / |grad
    img|)`` with ``jnp.gradient``'s derivatives (central inside, one-sided
    first order at the edges); unlike :func:`tv_denoise` it does not
    re-anchor to the input."""
    img = f
    for _ in range(int(n_iter)):
        gx = _gradient_edge1(img, 1.0, img.ndim - 2)
        gy = _gradient_edge1(img, 1.0, img.ndim - 1)
        mag = torch.sqrt(gx**2 + gy**2) + 1e-8
        div = _gradient_edge1(gx / mag, 1.0, img.ndim - 2) + _gradient_edge1(gy / mag, 1.0, img.ndim - 1)
        img = img + weight * div
    return img
