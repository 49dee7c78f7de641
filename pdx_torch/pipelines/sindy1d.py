"""1-D SINDy on noisy / shifted / varying-IC KS-1D data (port of
``pdx/pipelines/sindy1d.py``; notebooks 06/07/10).

Spectral or finite-difference derivatives; the denoising bank (spectral
low-pass, Gaussian, Savitzky-Golay); integer 1-D registration
(cross-correlation or phase correlation against the mean frame); Lasso,
STRidge or least squares on the KS library [u_xx, u_xxxx, (u^2)_x]; the
ensemble over initial conditions; the MAD noise estimate; F1 support
recovery against (a, b, c) = (-1, -1, -0.5).

``pdx`` builds its data in the default float type whatever ``cfg.dtype``
says (it validates the name only); so does the port: float64. Noise, the
shift draws and the subsample come from numpy generators on the host, so
card and CPU fit the same rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import Tensor

from pdx_torch import resolve_device, resolve_dtype
from pdx_torch.ops.fd import d4_1d_periodic
from pdx_torch.ops.filters import gaussian_filter1d_reflect, savgol_time
from pdx_torch.ops.linalg import gram_stats
from pdx_torch.ops.metrics import f1_support_score, r2_score
from pdx_torch.ops.spectral import lowpass_1d, spectral_derivative_1d
from pdx_torch.sim.ks1d import Ks1dConfig, simulate_ks1d, spatially_shifted_data, varying_ic_data
from pdx_torch.solve.lasso import lasso_ista
from pdx_torch.solve.robust import median
from pdx_torch.solve.stridge import stridge_from_stats
from pdx_torch.utils.profiling import null_stage

KS1D_TRUE = np.array([-1.0, -1.0, -0.5])  # [u_xx, u_xxxx, (u^2)_x]


@dataclass(frozen=True)
class Sindy1dConfig:
    L: float = 100.0
    N: int = 200
    dt: float = 0.05
    n_steps: int = 2000
    scenario: str = "clean"  # clean | noisy | shifted | varying_ic
    noise_rel: float = 0.05
    noise_seed: int = 0
    derivative: str = "spectral"  # spectral | finite
    denoise: str = "none"  # none | spectral | gaussian | savgol
    denoise_keep_frac: float = 0.33
    denoise_sigma: float = 1.0
    savgol_window: int = 7
    savgol_poly: int = 3
    register: bool = False
    register_method: str = "crosscorr"  # crosscorr | phasecorr
    regressor: str = "lasso"  # lasso | stridge | lstsq
    lasso_alpha: float = 1e-3
    stridge_alpha: float = 1e-6
    stridge_threshold: float = 1e-3
    subsample: int = 50_000
    dtype: str = "float64"


def build_library_1d(U: Tensor, L: float, dt: float, derivative: str) -> tuple[Tensor, Tensor]:
    """X = [u_xx, u_xxxx, (u^2)_x] on frames U[..., :-1, :] (n, 3) and the
    forward-difference u_t (n,); leading axes before the frames are a
    batch."""
    Uk = U[..., :-1, :]
    ut = (U[..., 1:, :] - Uk) / dt
    if derivative == "spectral":
        uxx = spectral_derivative_1d(Uk, L, order=2)
        uxxxx = spectral_derivative_1d(Uk, L, order=4)
        u2x = spectral_derivative_1d(Uk**2, L, order=1)
    else:
        dx = L / U.shape[-1]
        ux_m = torch.roll(Uk, 1, -1)
        ux_p = torch.roll(Uk, -1, -1)
        uxx = (ux_p - 2 * Uk + ux_m) / dx**2
        uxxxx = d4_1d_periodic(Uk, dx)
        u2 = Uk**2
        u2x = (torch.roll(u2, -1, -1) - torch.roll(u2, 1, -1)) / (2 * dx)
    lead = U.shape[:-2]
    X = torch.stack([f.reshape(lead + (-1,)) for f in (uxx, uxxxx, u2x)], dim=-1)
    return X, ut.reshape(lead + (-1,))


def register_1d(U: Tensor, method: str = "crosscorr") -> Tensor:
    """Integer alignment of each frame to the mean frame: the argmax (the
    first maximum) of the periodic cross-correlation by FFT, or of the
    normalised cross-power spectrum (``phasecorr``); shifts above n / 2
    wrap to negative; each frame is rolled by minus its shift."""
    ref = torch.mean(U, dim=0)
    cross = torch.fft.fft(U) * torch.conj(torch.fft.fft(ref))
    if method == "phasecorr":
        cross = cross / (torch.abs(cross) + 1e-12)
    corr = torch.fft.ifft(cross).real  # corr[s] = sum u(x) ref(x - s)
    n = U.shape[-1]
    shift = torch.argmax(corr, dim=-1)
    shift = torch.where(shift > n // 2, shift - n, shift)
    cols = torch.remainder(torch.arange(n, device=U.device)[None, :] + shift[:, None], n)
    return torch.gather(U, 1, cols)


def estimate_noise_mad(U: Tensor) -> Tensor:
    """sigma ~ 1.4826 MAD(u[t+1] - 2 u[t] + u[t-1]) / sqrt(6), the median
    over every entry, averaging the middle pair of an even count as
    ``jnp.median`` does. The second temporal difference carries O(dt^2) of
    signal, so this stays near zero on clean data and tracks the noise."""
    d2 = U[2:] - 2 * U[1:-1] + U[:-2]
    return 1.4826 * median(torch.abs(d2).reshape(-1)) / np.sqrt(6.0)


def run(cfg: Sindy1dConfig, device: str | torch.device | None = None, timer=None) -> dict[str, Any]:
    """One discovery on the CUDA card unless ``device="cpu"``; raises
    without a card otherwise. ``timer`` (a
    :class:`pdx_torch.utils.profiling.StageTimer`) times the stages."""
    dev = resolve_device(device)
    resolve_dtype(cfg.dtype)  # validated only, as in pdx
    st = timer.stage if timer is not None else null_stage
    sim = Ks1dConfig(L=cfg.L, N=cfg.N, dt=cfg.dt, n_steps=cfg.n_steps)

    with st("simulate"):
        if cfg.scenario == "shifted":
            U, _true_shifts = spatially_shifted_data(sim, device=dev)
        elif cfg.scenario == "varying_ic":
            U = varying_ic_data(sim, device=dev)
        else:
            U = simulate_ks1d(sim, device=dev)
            if cfg.scenario == "noisy":
                rng = np.random.default_rng(cfg.noise_seed)
                sigma = cfg.noise_rel * float(torch.std(U, correction=0))
                U = U + torch.as_tensor(rng.normal(0, sigma, size=tuple(U.shape)), dtype=U.dtype).to(dev)
    with st("preprocess"):
        noise_est = estimate_noise_mad(U)
        if cfg.register:
            U = register_1d(U, cfg.register_method)
        if cfg.denoise == "spectral":
            U = lowpass_1d(U, cfg.denoise_keep_frac)
        elif cfg.denoise == "gaussian":
            U = gaussian_filter1d_reflect(U, cfg.denoise_sigma, axis=-1)
        elif cfg.denoise == "savgol":
            U = savgol_time(U, cfg.savgol_window, cfg.savgol_poly)
    with st("library"):
        X, y = build_library_1d(U, cfg.L, cfg.dt, cfg.derivative)
        n_total = int(y.shape[0])
        if n_total > cfg.subsample:
            idx = torch.as_tensor(np.random.default_rng(0).choice(n_total, cfg.subsample, replace=False)).to(dev)
            X, y = X[idx], y[idx]
    with st("fit"):
        if cfg.regressor == "lasso":
            coef, _b = lasso_ista(X, y, cfg.lasso_alpha, max_iter=5000, fit_intercept=False)
        elif cfg.regressor == "stridge":
            coef = stridge_from_stats(gram_stats(X, y), alpha=cfg.stridge_alpha, threshold=cfg.stridge_threshold).coeffs
        else:
            stats = gram_stats(X, y)
            coef = torch.linalg.solve(stats["G"] + 1e-12 * torch.eye(3, dtype=X.dtype, device=dev), stats["b"])
        r2 = r2_score(y, X @ coef)
        coef_np = coef.cpu().numpy()
    rel_err = np.abs(coef_np - KS1D_TRUE) / np.abs(KS1D_TRUE) * 100.0
    return {
        "config": dataclasses.asdict(cfg),
        "term_names": ["u_xx", "u_xxxx", "(u^2)_x"],
        "coeffs": coef_np,
        "true_coeffs": KS1D_TRUE,
        "rel_err_pct": rel_err,
        "r2": float(r2),
        "f1_support": float(f1_support_score(torch.as_tensor(coef_np), torch.as_tensor(KS1D_TRUE), tol=1e-2)),
        "noise_mad_estimate": float(noise_est),
    }


def ensemble_over_ics(cfg: Sindy1dConfig, n_ics: int = 5, seed: int = 0,
                      device: str | torch.device | None = None) -> dict[str, Any]:
    """Discovery over random initial conditions (notebook 10's ensemble-IC
    study): median and std of the STRidge coefficients. The ICs are drawn
    one after another from ``default_rng(seed)`` and simulated together as
    one batch."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sim = Ks1dConfig(L=cfg.L, N=cfg.N, dt=cfg.dt, n_steps=cfg.n_steps)
    u0 = np.stack([rng.normal(0, 1, cfg.N) * 0.1 for _ in range(n_ics)])
    U = simulate_ks1d(sim, u0=torch.as_tensor(u0).to(dev))  # (n_steps + 1, n_ics, N)
    X, y = build_library_1d(U.movedim(1, 0), cfg.L, cfg.dt, cfg.derivative)  # (n_ics, n, 3)
    C = stridge_from_stats(gram_stats(X, y), alpha=1e-8, threshold=1e-3).coeffs.cpu().numpy()
    return {"median": np.median(C, axis=0), "std": C.std(axis=0), "all": C}


def cmd_sindy1d(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch sindy1d")
    parser.add_argument("--scenario", choices=["clean", "noisy", "shifted", "varying_ic"], default="clean")
    parser.add_argument("--noise-rel", type=float, default=0.05)
    parser.add_argument("--derivative", choices=["spectral", "finite"], default="spectral")
    parser.add_argument("--denoise", choices=["none", "spectral", "gaussian", "savgol"], default="none")
    parser.add_argument("--register", action="store_true")
    parser.add_argument("--regressor", choices=["lasso", "stridge", "lstsq"], default="lasso")
    parser.add_argument("--n-steps", type=int, default=2000)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    out = run(
        Sindy1dConfig(
            scenario=args.scenario, noise_rel=args.noise_rel, derivative=args.derivative,
            denoise=args.denoise, register=args.register, regressor=args.regressor,
            n_steps=args.n_steps,
        ),
        args.device,
    )
    print(f"Estimated noise (MAD): {out['noise_mad_estimate']:.4g}")
    for n, c, t, e in zip(out["term_names"], out["coeffs"], out["true_coeffs"], out["rel_err_pct"]):
        print(f"  {n:9s}: est={c:+.6f}  true={t:+.2f}  rel_err={e:.2f}%")
    print(f"R2={out['r2']:.6f}  F1(support)={out['f1_support']:.3f}")
    return 0
