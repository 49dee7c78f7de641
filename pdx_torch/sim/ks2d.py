"""2-D Kuramoto-Sivashinsky simulators, explicit Euler and the spectral
integrating-factor stepper (port of ``pdx/sim/ks2d.py``).

  u_t = -lap(u) - lap^2(u) - 0.5 |grad u|^2   on a periodic box

The initial condition is drawn on the host with ``np.random.default_rng``,
exactly as ``pdx`` draws it. The time loop is an eager Python loop (``pdx``
uses ``lax.scan``) with the same per-step ``nan_to_num`` guard and the same
frame convention: frame 0 is the state after one Euler step. The spectral
stepper carries its state in Fourier space and saves a frame every
``save_every`` steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import math

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.fd import gradients_periodic, laplacian_periodic


@dataclass(frozen=True)
class Ks2dConfig:
    """Same fields and defaults as ``pdx.sim.ks2d.Ks2dConfig``."""

    Lx: float = 50.0
    Ly: float = 50.0
    Nx: int = 100
    Ny: int = 100
    dt: float = 1e-3
    n_seconds: float = 2.0
    save_every: int = 1
    seed: int = 42

    @property
    def dx(self) -> float:
        return self.Lx / self.Nx

    @property
    def dy(self) -> float:
        return self.Ly / self.Ny

    @property
    def total_steps(self) -> int:
        return int(self.n_seconds / self.dt)

    @property
    def n_frames(self) -> int:
        return self.total_steps // self.save_every

    @property
    def DT(self) -> float:
        return self.dt * self.save_every


def ks_rhs(u: Tensor, dx: float, dy: float) -> Tensor:
    """KS right-hand side via periodic FD stencils."""
    lap = laplacian_periodic(u, dx, dy)
    bih = laplacian_periodic(lap, dx, dy)
    ux, uy = gradients_periodic(u, dx, dy)
    return -lap - bih - 0.5 * (ux**2 + uy**2)


def initial_condition(cfg: Ks2dConfig, dtype=None) -> np.ndarray:
    """Host-side IC: uniform(-0.1, 0.1) from np.random.default_rng(seed)."""
    rng = np.random.default_rng(cfg.seed)
    u0 = rng.uniform(-0.1, 0.1, size=(cfg.Nx, cfg.Ny))
    return u0.astype(dtype or np.float64)


def simulate_ks2d(
    cfg: Ks2dConfig,
    u0: Tensor | np.ndarray | None = None,
    dtype: torch.dtype = torch.float64,
    device: str | torch.device = "cpu",
) -> tuple[Tensor, float, float, float]:
    """Explicit-Euler KS-2D. Returns (U[(n_frames, Nx, Ny)], dx, dy, DT).

    The state is advanced, nan_to_num-guarded, and saved whenever
    ``step % save_every == 0``.
    """
    if u0 is None:
        u0 = initial_condition(cfg)
    u = torch.as_tensor(u0, dtype=dtype, device=device)
    dx, dy, dt, se = cfg.dx, cfg.dy, cfg.dt, cfg.save_every

    U = torch.empty((cfg.n_frames, cfg.Nx, cfg.Ny), dtype=dtype, device=device)
    for frame in range(cfg.n_frames):
        for k in range(se):
            u = torch.nan_to_num(u + dt * ks_rhs(u, dx, dy))
            if k == 0:
                U[frame] = u
    return U, dx, dy, cfg.DT


def simulate_ks2d_spectral(
    cfg: Ks2dConfig,
    u0: Tensor | np.ndarray | None = None,
    dtype: torch.dtype = torch.float64,
    device: str | torch.device = "cpu",
) -> tuple[Tensor, float, float, float]:
    """Integrating-factor Euler: the exact linear step exp((k^2 - k^4) dt) in
    Fourier space plus the pseudospectral nonlinear term. The stiff
    fourth-order operator is handled exactly, so dt can be much larger than
    the explicit Euler stepper tolerates. Returns (U[(n_frames, Nx, Ny)],
    dx, dy, DT); frame j is the state after (j + 1) * save_every steps."""
    if u0 is None:
        u0 = initial_condition(cfg)
    u0 = torch.as_tensor(u0, dtype=dtype, device=device)
    dx, dy, nx, ny = cfg.dx, cfg.dy, cfg.Nx, cfg.Ny
    kx = 2.0 * math.pi * torch.fft.fftfreq(nx, d=dx, dtype=dtype, device=device)
    ky = 2.0 * math.pi * torch.fft.rfftfreq(ny, d=dy, dtype=dtype, device=device)
    KX, KY = torch.meshgrid(kx, ky, indexing="ij")
    K2 = KX**2 + KY**2
    E = torch.exp(cfg.dt * (K2 - K2**2))  # linear symbol of -lap - lap^2

    def step(uh: Tensor) -> Tensor:
        # through physical space and back, as pdx does: irfft2 drops what is
        # not Hermitian in uh, so the gradients see the real field's spectrum
        uf = torch.fft.rfft2(torch.fft.irfft2(uh, s=(nx, ny)))
        ux = torch.fft.irfft2(1j * KX * uf, s=(nx, ny))
        uy = torch.fft.irfft2(1j * KY * uf, s=(nx, ny))
        Nh = torch.fft.rfft2(-0.5 * (ux**2 + uy**2))
        return E * (uh + cfg.dt * Nh)

    uh = torch.fft.rfft2(u0)
    U = torch.empty((cfg.n_frames, nx, ny), dtype=dtype, device=device)
    for frame in range(cfg.n_frames):
        for _ in range(cfg.save_every):
            uh = step(uh)
        U[frame] = torch.fft.irfft2(uh, s=(nx, ny))
    return U, dx, dy, cfg.DT
