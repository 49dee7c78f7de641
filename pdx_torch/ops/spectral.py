"""Spectral (FFT) derivatives and periodic filters on the trailing two axes.

Port of ``pdx/ops/spectral.py``: wavenumber grids, radial low-pass
masks, spectral gradients / Laplacian / biharmonic and the periodic Gaussian
low-pass, batched over leading axes by one ``torch.fft.fft2`` call; and the
1-D derivative and low-pass on the trailing axis (``torch.fft.fft``). ``pdx``
leaves these to XLA's FFT (no Pallas kernel), so ``torch.fft`` is their
counterpart here.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor


def _fftfreq(n: int, d: float, device=None) -> Tensor:
    """``jnp.fft.fftfreq(n, d)`` in float64, computed as jax does:
    ((i + n//2) % n - n//2) / (d * n)."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return ((i + n // 2) % n - n // 2) / (d * n)


def spectral_wavenumbers(
    nx: int, ny: int, dx: float, dy: float, dtype: torch.dtype = torch.float64, device=None
) -> tuple[Tensor, Tensor]:
    """(KX, KY) wavenumber grids in rad per physical unit, 'ij' indexing."""
    kx = 2.0 * math.pi * _fftfreq(nx, dx, device).to(dtype)
    ky = 2.0 * math.pi * _fftfreq(ny, dy, device).to(dtype)
    return torch.meshgrid(kx, ky, indexing="ij")


def spectral_mask(KX: Tensor, KY: Tensor, cutoff_frac: float) -> Tensor:
    """Radial low-pass mask; cutoff_frac in (0, 1] (1.0 and above: no masking)."""
    cutoff_frac = float(cutoff_frac)
    if cutoff_frac >= 1.0:
        return torch.ones_like(KX)
    if cutoff_frac <= 0.0:
        raise ValueError("cutoff_frac must be positive")
    k_mag = torch.sqrt(KX**2 + KY**2)
    k_max = torch.max(k_mag)
    return (k_mag <= cutoff_frac * k_max).to(KX.dtype)


def _masked_fft2(f: Tensor, dx: float, dy: float, cutoff_frac: float) -> tuple[Tensor, Tensor, Tensor]:
    KX, KY = spectral_wavenumbers(f.shape[-2], f.shape[-1], dx, dy, dtype=f.dtype, device=f.device)
    F = torch.fft.fft2(f)
    if cutoff_frac < 1.0:
        F = F * spectral_mask(KX, KY, cutoff_frac)
    return F, KX, KY


def gradients_spectral(
    f: Tensor, dx: float, dy: float, *, cutoff_frac: float = 1.0
) -> tuple[Tensor, Tensor]:
    """Spectral gradient (d/dx along axis -2, d/dy along axis -1) with an
    optional radial low-pass."""
    F, KX, KY = _masked_fft2(f, dx, dy, cutoff_frac)
    gx = torch.fft.ifft2(1j * KX * F).real
    gy = torch.fft.ifft2(1j * KY * F).real
    return gx, gy


def laplacian_spectral(f: Tensor, dx: float, dy: float, *, cutoff_frac: float = 1.0) -> Tensor:
    """Spectral Laplacian with an optional radial low-pass."""
    F, KX, KY = _masked_fft2(f, dx, dy, cutoff_frac)
    return torch.fft.ifft2(-(KX**2 + KY**2) * F).real


def biharmonic_spectral(f: Tensor, dx: float, dy: float, *, cutoff_frac: float = 1.0) -> Tensor:
    """laplacian(laplacian(f)), the low-pass mask applied twice as in pdx."""
    return laplacian_spectral(
        laplacian_spectral(f, dx, dy, cutoff_frac=cutoff_frac), dx, dy, cutoff_frac=cutoff_frac
    )


def gaussian_smooth_periodic(f: Tensor, sigma_px: float) -> Tensor:
    """Periodic Gaussian low-pass via FFT, sigma in pixels: transfer function
    exp(-0.5 sigma^2 (KX^2 + KY^2)) with KX, KY in rad per pixel, built in
    the promotion of f's dtype with float32 (as pdx's ``result_type``)."""
    sigma_px = float(sigma_px)
    if sigma_px <= 0:
        return f
    dtype = torch.promote_types(f.dtype, torch.float32)
    KX, KY = spectral_wavenumbers(f.shape[-2], f.shape[-1], 1.0, 1.0, dtype=dtype, device=f.device)
    H = torch.exp(-0.5 * (sigma_px**2) * (KX**2 + KY**2))
    return torch.fft.ifft2(torch.fft.fft2(f) * H).real


def _integer_pow(x: Tensor, order: int) -> Tensor:
    """x ** order by binary exponentiation, in ``jax.lax.integer_pow``'s
    order of products (``torch.pow`` of a complex tensor goes through
    exp/log and is not exact for the powers of i k)."""
    acc = None
    while order > 0:
        if order & 1:
            acc = x if acc is None else acc * x
        order >>= 1
        if order > 0:
            x = x * x
    return acc if acc is not None else torch.ones_like(x)


def spectral_derivative_1d(f: Tensor, L: float, order: int = 1) -> Tensor:
    """n-th spectral derivative on a periodic 1-D grid of physical length L,
    on the trailing axis."""
    n = f.shape[-1]
    k = 2.0 * math.pi * _fftfreq(n, L / n, f.device)
    F = torch.fft.fft(f)
    return torch.fft.ifft(_integer_pow(1j * k, int(order)) * F).real


def lowpass_1d(f: Tensor, keep_frac: float) -> Tensor:
    """Zero the top (1 - keep_frac) share of the 1-D frequencies (in cycles
    per sample) on the trailing axis."""
    k = torch.abs(_fftfreq(f.shape[-1], 1.0, f.device))
    mask = (k <= keep_frac * torch.max(k)).to(f.dtype)
    return torch.fft.ifft(torch.fft.fft(f) * mask).real
