"""Measurement-corruption (perturbation) suite N1-N7.

Port of ``pdx/sim/perturb.py``: subpixel periodic shifts (constant drift or
per-frame jitter), additive Gaussian noise relative to the field's std, a
periodic Gaussian blur and an intensity drift, composed as the reference's
dispatch table.

Random draws are always made on the host with
``np.random.default_rng(cfg.noise_seed)``, in the reference's draw order, and
then copied to the field's device. ``pdx`` takes the same branch on the CPU
(``_use_host_rng``), so the port matches ``pdx``-on-CPU draw for draw, and a
run on the card gets the very noise that a run on the CPU gets. ``pdx``'s
device-RNG branch existed only to spare the TPU's slow host link and is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.interp import shift_periodic
from pdx_torch.ops.spectral import gaussian_smooth_periodic


@dataclass(frozen=True)
class PerturbConfig:
    """Same fields and defaults as ``pdx.sim.perturb.PerturbConfig``."""

    perturbation: str = "none"  # none | N1_shifts | ... | N7_all
    noise_rel: float = 0.0
    noise_seed: int = 999
    shift_max_px: float = 1.5
    shift_mode: str = "constant"  # constant | jitter
    blur_sigma: float = 1.5
    drift_per_frame: float = 0.02


def _add_noise(U: Tensor, rng: np.random.Generator, noise_rel: float) -> Tensor:
    """sigma = noise_rel * std(U), the population std (ddof 0) as np.std."""
    if noise_rel <= 0:
        return U
    sigma0 = float(torch.std(U, correction=0))
    sigma = float(noise_rel) * sigma0
    noise = rng.normal(0.0, sigma, size=tuple(U.shape))
    return U + torch.from_numpy(noise).to(dtype=U.dtype).to(U.device)


def _add_shifts(U: Tensor, rng: np.random.Generator, shift_max_px: float, mode: str) -> Tensor:
    """Constant drift or per-frame jitter subpixel wrap shifts."""
    if shift_max_px <= 0:
        return U
    T = U.shape[0]
    if mode not in {"constant", "jitter"}:
        raise ValueError("unknown shift_mode: use 'constant' or 'jitter'")
    if mode == "constant":
        sx = float(rng.uniform(-shift_max_px, shift_max_px))
        sy = float(rng.uniform(-shift_max_px, shift_max_px))
        draws = np.array([[sx, sy]] * T)
    else:
        # reference draw order: per frame, sx then sy
        draws = np.asarray([[rng.uniform(-shift_max_px, shift_max_px) for _ in range(2)] for _ in range(T)])
    d = torch.as_tensor(draws, dtype=U.dtype, device=U.device)
    return shift_periodic(U, d[:, 0], d[:, 1])


def _add_blur(U: Tensor, blur_sigma: float) -> Tensor:
    """Periodic Gaussian blur of every frame (the FFT Gaussian, as pdx)."""
    if blur_sigma <= 0:
        return U
    return gaussian_smooth_periodic(U, blur_sigma)


def _add_drift(U: Tensor, drift_per_frame: float) -> Tensor:
    """Intensity decay (1 - d)^t."""
    if drift_per_frame <= 0:
        return U
    T = U.shape[0]
    factors = torch.pow(1.0 - float(drift_per_frame), torch.arange(T, dtype=U.dtype, device=U.device))
    return U * factors[:, None, None]


def apply_perturbation_suite(U_clean: Tensor, cfg: PerturbConfig) -> Tensor:
    """N1-N7 on a (T, H, W) stack, on the stack's device."""
    U = U_clean
    rng = np.random.default_rng(cfg.noise_seed)
    p = cfg.perturbation
    if p == "none":
        return U
    if p == "N1_shifts":
        return _add_shifts(U, rng, cfg.shift_max_px, cfg.shift_mode)
    if p == "N2_noise":
        return _add_noise(U, rng, cfg.noise_rel)
    if p == "N3_blur":
        return _add_blur(U, cfg.blur_sigma)
    if p == "N4_drift":
        return _add_drift(U, cfg.drift_per_frame)
    if p == "N5_shifts_noise":
        return _add_noise(_add_shifts(U, rng, cfg.shift_max_px, cfg.shift_mode), rng, cfg.noise_rel)
    if p == "N6_blur_noise":
        return _add_noise(_add_blur(U, cfg.blur_sigma), rng, cfg.noise_rel)
    if p == "N7_all":
        return _add_noise(
            _add_blur(_add_drift(_add_shifts(U, rng, cfg.shift_max_px, cfg.shift_mode), cfg.drift_per_frame), cfg.blur_sigma),
            rng,
            cfg.noise_rel,
        )
    raise ValueError(f"Unknown perturbation: {p}")
