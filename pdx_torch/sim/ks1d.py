"""1-D Kuramoto-Sivashinsky ETD simulator and the corrupted-data
generators (port of ``pdx/sim/ks1d.py``; notebooks 10/06 cell 0).

Exponential time differencing in rfft space: the exact linear factor
exp(dt (a (-k^2) + b k^4)), the ETD1 nonlinear coefficient (e^{dt L} - 1) /
L, 2/3-rule dealiasing (``freqs < 2/3 max``), (a, b, c) = (-1, -1, -0.5) for
u_t = -u_xx - u_xxxx + c (u^2)_x; the transforms in complex128 for float64
states. The trajectory holds u0 and one row a step; ``u0`` may carry leading
batch axes, which step together. The corruption generators draw on the host
(numpy ``default_rng``), as ``pdx`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor


@dataclass(frozen=True)
class Ks1dConfig:
    L: float = 100.0
    N: int = 200
    dt: float = 0.05
    a: float = -1.0
    b: float = -1.0
    c: float = -0.5
    n_steps: int = 2000


def _rfftfreq(n: int, d: float, device=None) -> Tensor:
    """``jnp.fft.rfftfreq(n, d)`` in float64, as jax computes it: i / (d n)."""
    return torch.arange(n // 2 + 1, dtype=torch.float64, device=device) / (d * n)


def _operators(cfg: Ks1dConfig, dtype: torch.dtype, device=None) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(i k, exp(dt L), the ETD1 coefficient, the 2/3 dealiasing mask)."""
    dx = cfg.L / cfg.N
    freqs = _rfftfreq(cfg.N, dx, device)
    k = 2 * math.pi * freqs
    deriv_op = 1j * k
    linear = cfg.a * (-(k**2)) + cfg.b * (k**4)
    exp_term = torch.exp(cfg.dt * linear)
    coef = torch.where(linear == 0.0, torch.full_like(linear, cfg.dt), (exp_term - 1.0) / linear)
    alias_mask = (freqs < 2.0 / 3.0 * torch.max(freqs)).to(dtype)
    return deriv_op, exp_term, coef, alias_mask


def default_ic(cfg: Ks1dConfig, dtype: torch.dtype = torch.float64, device=None) -> Tensor:
    """u0 = sin(16 pi x / L) on ``jnp.linspace(0, L, N, endpoint=False)``'s
    grid (L * i / N)."""
    mesh = cfg.L * (torch.arange(cfg.N, dtype=torch.float64, device=device) / cfg.N)
    return torch.sin(16 * math.pi * mesh / cfg.L).to(dtype)


def _stepper(cfg: Ks1dConfig, dtype: torch.dtype, device):
    deriv_op, exp_term, coef, alias_mask = _operators(cfg, dtype, device)

    def step(u: Tensor) -> Tensor:
        u_nonlin_hat = alias_mask * torch.fft.rfft(cfg.c * u**2)
        u_next_hat = exp_term * torch.fft.rfft(u) + coef * (deriv_op * u_nonlin_hat)
        return torch.fft.irfft(u_next_hat, n=cfg.N)

    return step


def ks1d_step(cfg: Ks1dConfig, u: Tensor) -> Tensor:
    """One ETD1 step of u (..., N)."""
    return _stepper(cfg, u.dtype, u.device)(u)


def simulate_ks1d(cfg: Ks1dConfig, u0: Tensor | None = None, device=None) -> Tensor:
    """(n_steps + 1, ..., N) trajectory including u0 (``default_ic`` on
    ``device`` when u0 is None)."""
    if u0 is None:
        u0 = default_ic(cfg, device=device)
    step = _stepper(cfg, u0.dtype, u0.device)
    traj = torch.empty((cfg.n_steps + 1,) + tuple(u0.shape), dtype=u0.dtype, device=u0.device)
    traj[0] = u = u0
    for i in range(cfg.n_steps):
        u = step(u)
        traj[i + 1] = u
    return traj


def spatially_shifted_data(cfg: Ks1dConfig, seed: int = 42, device=None) -> tuple[Tensor, np.ndarray]:
    """The clean trajectory with each frame rolled by an integer in [-3, 3]
    from ``default_rng(seed)`` (generate_spatially_shifted_data), as one
    gather. Returns (shifted trajectory, true shifts)."""
    traj = simulate_ks1d(cfg, device=device)
    shifts = np.random.default_rng(seed).integers(-3, 4, size=traj.shape[0])
    x = torch.arange(cfg.N, device=traj.device)
    cols = torch.remainder(x[None, :] - torch.as_tensor(shifts).to(traj.device)[:, None], cfg.N)
    return torch.gather(traj, 1, cols), shifts


def varying_ic_data(cfg: Ks1dConfig, seed: int = 42, noise_level: float = 0.02, device=None) -> Tensor:
    """Frame i is i steps of evolution from its own perturbed initial
    condition (generate_varying_ic_data). All n + 1 perturbed ICs step
    together as one (n + 1, N) batch; row i is captured before step i."""
    base = default_ic(cfg, device=device)
    n = cfg.n_steps
    noise = np.random.default_rng(seed).normal(0, 1, size=(n + 1, cfg.N))
    ics = base.cpu().numpy()[None, :] + noise_level * noise
    states = torch.as_tensor(ics, dtype=base.dtype).to(base.device)
    step = _stepper(cfg, base.dtype, base.device)
    frames = torch.empty_like(states)
    for i in range(n + 1):
        frames[i] = states[i]
        if i < n:  # the state after the last capture is never read
            states = step(states)
    return frames
