"""Synthetic laser-matter frame stacks, made on the device from a seed.

A torch copy of the repository's host generator (diffusion, drift, a
saturating nonlinearity and noise on a periodic grid, scaled to uint16).
The initial field is white noise smoothed by a periodic Gaussian in Fourier
space, where the host generator uses scipy's wrap-mode filter; every draw
comes from one ``torch.Generator`` on the device, in a few large calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def make_stack(
    T: int, H: int, W: int, *, seed: int, device, diffusion: float = 1.5, drift=(0.6, -0.4),
    saturation: float = 0.3, noise: float = 0.002, ic_sigma: float = 24.0, scale: float = 60000.0,
) -> np.ndarray:
    """(T, H, W) uint16 frames, a writable host array, the same for the
    same seed on the same kind of device."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2**63))
    f64 = torch.float64
    kx = 2 * math.pi * torch.fft.fftfreq(H, dtype=f64, device=dev)
    ky = 2 * math.pi * torch.fft.fftfreq(W, dtype=f64, device=dev)
    K2 = kx[:, None] ** 2 + ky[None, :] ** 2
    z = torch.randn((H, W), generator=g, dtype=f64, device=dev)
    u0 = torch.fft.ifft2(torch.fft.fft2(z) * torch.exp(-0.5 * ic_sigma**2 * K2)).real
    u0 = (u0 - u0.min()) / (u0.max() - u0.min())
    F0 = torch.fft.fft2(u0)
    vx, vy = drift
    U = torch.empty((T, H, W), dtype=f64, device=dev)
    for t in range(T):
        phase = torch.exp(-diffusion * K2 * t - 1j * (kx[:, None] * vx + ky[None, :] * vy) * t)
        U[t] = torch.fft.ifft2(F0 * phase).real
    U = U / (1.0 + saturation * torch.abs(U))
    U += noise * torch.randn((T, H, W), generator=g, dtype=f64, device=dev)
    U = (U - U.min()) / (U.max() - U.min())
    return (U * scale).to(torch.uint16).cpu().numpy()


def stack_pool(n: int, T: int, H: int, W: int, *, seed: int, device, dynamics: dict) -> list[np.ndarray]:
    """``n`` distinct stacks for one seed: member k draws from seed
    ``seed * n + k``."""
    return [make_stack(T, H, W, seed=seed * n + k, device=device, **dynamics) for k in range(n)]
