"""Registration-method comparison (Farnebäck against DIS) and a 13-term
SINDy fit (port of ``pdx/pipelines/improved_registration.py``;
scripts/pde_discovery_improved_registration.py).

load -> Gaussian denoise, min-max normalise -> register with the improved
Farnebäck chain AND the DIS chain -> residual-flow quality of each -> pick
the better -> Savitzky-Golay along time (window 7, poly 3) -> crop and
subsample -> sliced central differences (truncated to a common shape from
the start, as in ``analyze``) -> 13-term library -> STRidge -> equation,
metrics, ``registration_study.json`` and SLIDE1-4.

The reference smooths each pixel's time series in a Python loop; here it is
one contraction over the frame axis. The quality of both registrations is
measured against one sweep of the unregistered stack (``pdx`` measures it
twice, with the same result).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import Tensor

from pdx_torch import resolve_device, resolve_dtype
from pdx_torch.io_host.artifacts import write_json
from pdx_torch.io_host.images import device_stack, load_images
from pdx_torch.ops.filters import gaussian_filter_reflect, savgol_time
from pdx_torch.ops.interp import warp_flow
from pdx_torch.ops.linalg import gram_stats
from pdx_torch.ops.metrics import r2_score
from pdx_torch.register.dis import dis_flow
from pdx_torch.register.farneback import _blur, farneback_flow, farneback_register_sequence
from pdx_torch.register.quality import improvement, mean_flow_magnitude
from pdx_torch.solve.stridge import stridge_from_stats, stridge_qr
from pdx_torch.utils.profiling import null_stage, span

TERM_NAMES = [
    "1", "u", "u_x", "u_y", "u_xx", "u_yy", "lap(u)", "u^2", "u*u_x", "u*u_y", "u^3", "u_x^2", "u_y^2",
]


@dataclass(frozen=True)
class ImprovedRegistrationConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/registration"
    max_images: int = 51
    denoise_sigma: float = 1.0
    savgol_window: int = 7
    savgol_poly: int = 3
    skip: int = 25
    subsample: int = 12
    dx: float = 0.1
    dy: float = 0.1
    dt: float = 1.0
    alpha: float = 0.01
    threshold: float = 1e-5
    reference_compat_warp: bool = False
    dtype: str = "float64"
    write_artifacts: bool = True


def _dis_step(ref: Tensor, mov: Tensor, sign: float) -> Tensor:
    """mov warped onto ref by their DIS flow, smoothed 11x11 / sigma 2."""
    fx, fy = dis_flow(ref, mov)
    fs = _blur(torch.stack([fx, fy]), 11, 2.0, True)
    return warp_flow(mov, sign * fs[0], sign * fs[1], border="reflect")


def dis_register_sequence(U: Tensor, *, warp_sign: float = 1.0) -> Tensor:
    """Sequential warp-to-previous DIS registration of a (T, H, W) stack with
    11x11 / sigma-2 flow smoothing (pde_discovery_improved_registration.py:
    107-145): a host loop, each step needing the previous registered frame."""
    out = torch.empty_like(U)
    out[0] = U[0]
    for i in range(1, U.shape[0]):
        out[i] = _dis_step(out[i - 1], U[i], warp_sign)
    return out


def sliced_library(cfg: ImprovedRegistrationConfig, U_crop: Tensor):
    """The sliced central differences truncated to a common shape from the
    start, and the 13-term library: (X (n, 13), y (n,), u_t, lap, u_x, u_y,
    (mt, mh, mw))."""
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    u_x = (U_crop[:, :, 2:] - U_crop[:, :, :-2]) / (2 * dx)
    u_y = (U_crop[:, 2:, :] - U_crop[:, :-2, :]) / (2 * dy)
    u_xx = (U_crop[:, :, 2:] - 2 * U_crop[:, :, 1:-1] + U_crop[:, :, :-2]) / dx**2
    u_yy = (U_crop[:, 2:, :] - 2 * U_crop[:, 1:-1, :] + U_crop[:, :-2, :]) / dy**2
    u_t = (U_crop[2:] - U_crop[:-2]) / (2 * dt)
    parts = (u_x, u_y, u_xx, u_yy, u_t)
    mt, mh, mw = (min(a.shape[i] for a in parts) for i in range(3))
    u, u_x, u_y, u_xx, u_yy, u_t = (a[:mt, :mh, :mw] for a in (U_crop,) + parts)
    lap = u_xx + u_yy
    terms = [torch.ones_like(u), u, u_x, u_y, u_xx, u_yy, lap, u**2, u * u_x, u * u_y, u**3, u_x**2, u_y**2]
    X = torch.stack([t.reshape(-1) for t in terms], dim=1)
    return X, u_t.reshape(-1), u_t, lap, u_x, u_y, (mt, mh, mw)


def fit(cfg: ImprovedRegistrationConfig, X: Tensor, y: Tensor) -> Tensor:
    """STRidge on the Gram statistics in float64; in float32 by QR on the
    standardised rows (the 13-term library is too ill-conditioned for
    float32 normal equations)."""
    if X.dtype.itemsize < 8:
        return stridge_qr(X, y, alpha=cfg.alpha, threshold=cfg.threshold, max_iter=20)
    return stridge_from_stats(gram_stats(X, y), alpha=cfg.alpha, threshold=cfg.threshold, max_iter=20).coeffs


def _equation(coeffs: np.ndarray) -> str:
    parts = []
    for c, n in zip(coeffs, TERM_NAMES):
        if abs(c) > 1e-5:
            sign_str = "+" if c > 0 and parts else ""
            parts.append(f"{sign_str}{c:.6f}·{n}")
    return "u_t = " + " ".join(parts) if parts else "u_t = 0"


def preprocess(cfg: ImprovedRegistrationConfig, U_raw: np.ndarray, device: torch.device) -> Tensor:
    """``U_raw`` (T, H, W) on ``device`` in ``cfg.dtype``, Gaussian-denoised
    (sigma ``cfg.denoise_sigma``) and min-max normalised to [0, 1]."""
    U = gaussian_filter_reflect(device_stack(U_raw, resolve_dtype(cfg.dtype), device=device), cfg.denoise_sigma)
    return (U - U.min()) / (U.max() - U.min())


def _warp_sign(cfg: ImprovedRegistrationConfig) -> float:
    return -1.0 if cfg.reference_compat_warp else 1.0


def register_farneback(cfg: ImprovedRegistrationConfig, U: Tensor) -> Tensor:
    """The Farnebäck warp-to-previous chain of the preprocessed stack, in a
    span ``register`` as the patch pipeline's chain."""
    with span("register"):
        return farneback_register_sequence(U, warp_sign=_warp_sign(cfg))


def register_dis(cfg: ImprovedRegistrationConfig, U: Tensor) -> Tensor:
    """The DIS warp-to-previous chain of the preprocessed stack."""
    return dis_register_sequence(U, warp_sign=_warp_sign(cfg))


def registration_quality(U: Tensor, U_fb: Tensor, U_dis: Tensor, *, stage=null_stage):
    """The mean residual flow of the unregistered stack and of each
    registration (three sweeps, one host read) and the method whose
    improvement is larger, Farnebäck on a tie: (Farnebäck metrics, DIS
    metrics, "Farneback" or "DIS"). ``stage``: a timer's ``stage``, entered
    once a sweep (``quality_before``, ``quality_farneback``, ``quality_dis``,
    the last with the read)."""
    with stage("quality_before"):
        before = mean_flow_magnitude(U)
    with stage("quality_farneback"):
        q_fb = improvement(before, mean_flow_magnitude(U_fb))
    with stage("quality_dis"):
        q_dis = improvement(before, mean_flow_magnitude(U_dis))
        keys = list(q_fb)
        host = torch.stack([q_fb[k] for k in keys] + [q_dis[k] for k in keys]).tolist()  # one read
    m_fb = dict(zip(keys, host[:3]))
    m_dis = dict(zip(keys, host[3:]))
    method = "DIS" if m_dis["improvement_pct"] > m_fb["improvement_pct"] else "Farneback"
    return m_fb, m_dis, method


def fit_registered(cfg: ImprovedRegistrationConfig, U_reg: Tensor) -> dict[str, Any]:
    """Savitzky-Golay along time, crop and subsample, the sliced 13-term
    library, STRidge and R^2 of the registered stack, with one host read:
    ``coeffs`` (13,), ``r2``, ``working_shape`` and ``fields`` (u_t, lap,
    u_x, u_y, y, y_pred on the device, which SLIDE3-4 draw)."""
    U_smooth = savgol_time(U_reg, cfg.savgol_window, cfg.savgol_poly)
    s, sub = cfg.skip, cfg.subsample
    U_crop = U_smooth[:, s:-s:sub, s:-s:sub]
    X, y, u_t, lap, u_x, u_y, working_shape = sliced_library(cfg, U_crop)
    coeffs_t = fit(cfg, X, y)
    y_pred = X @ coeffs_t
    host = torch.cat([coeffs_t, r2_score(y, y_pred)[None]]).cpu().numpy()  # one read
    return {"coeffs": host[:-1], "r2": float(host[-1]), "working_shape": working_shape,
            "fields": (u_t, lap, u_x, u_y, y, y_pred)}


def run(
    cfg: ImprovedRegistrationConfig,
    U_raw: np.ndarray | None = None,
    timer=None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """The registration study on ``U_raw`` (a (T, H, W) stack), or on the
    first ``cfg.max_images`` TIFFs of ``cfg.data_dir``. Runs on the CUDA card
    unless ``device="cpu"``; raises without a card otherwise. ``timer`` (a
    :class:`pdx_torch.utils.profiling.StageTimer`) times the stages.

    The stages in turn: :func:`preprocess`, :func:`register_farneback`,
    :func:`register_dis`, :func:`registration_quality`, :func:`fit_registered`."""
    dev = resolve_device(device)
    st = timer.stage if timer is not None else null_stage
    if U_raw is None:
        with st("load_images"):
            U_raw = load_images(cfg.data_dir, max_images=cfg.max_images)
    with st("denoise_normalize"):
        U = preprocess(cfg, U_raw, dev)
    with st("farneback_chain"):
        U_fb = register_farneback(cfg, U)
    with st("dis_chain"):
        U_dis = register_dis(cfg, U)
    m_fb, m_dis, method = registration_quality(U, U_fb, U_dis, stage=st)
    U_reg = U_dis if method == "DIS" else U_fb
    with st("fit"):
        res = fit_registered(cfg, U_reg)
    coeffs, r2 = res["coeffs"], res["r2"]

    out = {
        "config": dataclasses.asdict(cfg),
        "farneback_metrics": m_fb,
        "dis_metrics": m_dis,
        "selected_method": method,
        "term_names": TERM_NAMES,
        "coeffs": coeffs,
        "r2": r2,
        "equation": _equation(coeffs),
        "working_shape": res["working_shape"],
    }
    if cfg.write_artifacts:
        out_dir = Path(cfg.output_dir)
        with st("artifacts"):
            write_json(out_dir / "registration_study.json", {k: v for k, v in out.items() if k != "config"})
            # SLIDE1-4 (pde_discovery_improved_registration.py:254,347,532,592):
            # the flows and host reads run outside the guard; only the
            # drawing may be skipped, as the reference's figure guard does
            data = slide_data(U, U_fb, U_dis, U_reg, *res["fields"])
            try:
                _render_slides(out_dir, data, m_fb, m_dis, method, coeffs, r2, res["working_shape"])
            except Exception as e:  # pragma: no cover - parity with the reference guard
                print(f"   (skipped slide rendering: {e})")
    if timer is not None:
        out["stage_seconds"] = dict(timer.stages)
    return out


def slide_flows(U: Tensor) -> tuple[Tensor, Tensor, int]:
    """The two flow fields SLIDE2 shows, at frame ``min(15, T-2)``: the
    Farnebäck flow (its defaults) and the DIS flow of that pair, each
    smoothed 11x11 / sigma 2: ((2, H, W), (2, H, W), frame)."""
    fi = min(15, U.shape[0] - 2)
    fb = _blur(torch.stack(farneback_flow(U[fi], U[fi + 1])), 11, 2.0, True)
    dz = _blur(torch.stack(dis_flow(U[fi], U[fi + 1])), 11, 2.0, True)
    return fb, dz, fi


def slide_data(U, U_fb, U_dis, U_reg, u_t, lap, u_x, u_y, y, y_pred) -> dict[str, np.ndarray | int]:
    """Everything SLIDE1-4 draw, computed on the stack's device and read to
    the host."""
    fb, dz, fi = slide_flows(U)
    names = ("U", "U_fb", "U_dis", "u_t", "lap", "u_x", "u_y", "y", "y_pred", "flow_fb", "flow_dis")
    arrays = (U, U_fb, U_dis, u_t, lap, u_x, u_y, y, y_pred, fb, dz)
    data: dict[str, np.ndarray | int] = {n: a.cpu().numpy() for n, a in zip(names, arrays)}
    data["U_reg"] = data["U_dis"] if U_reg is U_dis else data["U_fb"]  # the selected stack, read once
    data["frame_idx"] = fi
    return data


def _render_slides(out_dir: Path, d: dict, m_fb, m_dis, method, coeffs, r2, working_shape) -> None:
    from pdx_torch.report.pipeline_figures import (
        slide1_registration_quality,
        slide2_flow_fields,
        slide3_pde_results,
        slide4_spatiotemporal,
    )

    slide1_registration_quality(out_dir, d["U"], d["U_fb"], d["U_dis"], m_fb, m_dis)
    slide2_flow_fields(out_dir, d["U"], d["flow_fb"], d["flow_dis"], frame_idx=d["frame_idx"])
    sel = m_dis if method == "DIS" else m_fb
    slide3_pde_results(
        out_dir, coeffs, TERM_NAMES, d["y"], d["y_pred"], r2, method, sel["improvement_pct"], working_shape,
    )
    slide4_spatiotemporal(out_dir, d["U_reg"], d["u_t"], d["lap"], d["u_x"], d["u_y"])


def parse_args(argv: list[str]) -> tuple[ImprovedRegistrationConfig, str]:
    """(configuration, device) from ``pdx improved-registration``'s flags
    plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch improved-registration")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/registration")
    parser.add_argument("--max-images", type=int, default=51)
    parser.add_argument("--skip", type=int, default=25)
    parser.add_argument("--subsample", type=int, default=12)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = ImprovedRegistrationConfig(
        data_dir=args.data_dir, output_dir=args.output_dir,
        max_images=args.max_images, skip=args.skip, subsample=args.subsample,
    )
    return cfg, args.device


def cmd_improved_registration(argv: list[str]) -> int:
    cfg, device = parse_args(argv)
    out = run(cfg, device=device)
    print(f"Farneback: {out['farneback_metrics']['improvement_pct']:.1f}% improvement")
    print(f"DIS:       {out['dis_metrics']['improvement_pct']:.1f}% improvement")
    print(f"Selected:  {out['selected_method']}")
    print(f"R2 = {out['r2']:.6f}")
    print(out["equation"])
    return 0
