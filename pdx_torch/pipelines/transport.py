"""Transport-form (continuity-equation) PDE discovery on real images
(port of ``pdx/pipelines/transport.py``).

load -> max-normalise -> 4x bilinear downsample -> Farnebäck flows of all
consecutive pairs (one batch of pairs, in the stack's float64) -> the
13-term transport library with ``np.gradient(edge_order=2)`` derivatives ->
light Gaussian smoothing -> Lasso over alpha in {0.001, 0.01, 0.1}, all
alphas one FISTA batch on the Gram matrix
(scripts/transport_pde_discovery.py).
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
from pdx_torch.ops.fd import gradient_edge2
from pdx_torch.ops.filters import gaussian_filter_reflect
from pdx_torch.ops.interp import resize_bilinear
from pdx_torch.register.farneback import farneback_flow_pairs
from pdx_torch.solve.lasso import lasso_fista, lstsq_solve
from pdx_torch.utils.profiling import null_stage

TERM_NAMES = [
    "constant", "rho", "drho_dx", "drho_dy", "laplacian", "transport",
    "rho_div", "advection", "rho_u", "rho_v", "rho_squared", "u_drho_dx", "v_drho_dy",
]


@dataclass(frozen=True)
class TransportConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/transport"
    max_images: int = 51
    downsample: int = 4
    dt: float = 1.0
    dx: float = 1.0
    dy: float = 1.0
    spatial_smooth: float = 0.5
    alphas: tuple[float, ...] = (0.001, 0.01, 0.1)
    # flow parameters (transport_pde_discovery.py:68-78)
    flow_levels: int = 3
    flow_winsize: int = 15
    flow_iterations: int = 3
    flow_poly_n: int = 5
    flow_poly_sigma: float = 1.2
    dtype: str = "float64"
    write_artifacts: bool = True


def build_transport_library(
    rho: Tensor, flow_u: Tensor, flow_v: Tensor, dt: float = 1.0, dx: float = 1.0, dy: float = 1.0
) -> tuple[dict[str, Tensor], Tensor]:
    """The 13-term library and the target (transport_pde_discovery.py:85-147).
    Convention: x = columns (axis 2), y = rows (axis 1); ``flow_u`` is the
    column displacement, ``flow_v`` the row displacement."""
    drho_dt = gradient_edge2(rho, dt, 0)
    drho_dx = gradient_edge2(rho, dx, 2)
    drho_dy = gradient_edge2(rho, dy, 1)
    laplacian = gradient_edge2(drho_dx, dx, 2) + gradient_edge2(drho_dy, dy, 1)
    divergence = gradient_edge2(flow_u, dx, 2) + gradient_edge2(flow_v, dy, 1)
    advection = flow_u * drho_dx[:-1] + flow_v * drho_dy[:-1]
    rho_div = rho[:-1] * divergence
    library = {
        "constant": torch.ones_like(rho[:-1]),
        "rho": rho[:-1],
        "drho_dx": drho_dx[:-1],
        "drho_dy": drho_dy[:-1],
        "laplacian": laplacian[:-1],
        "transport": rho_div + advection,
        "rho_div": rho_div,
        "advection": advection,
        "rho_u": rho[:-1] * flow_u,
        "rho_v": rho[:-1] * flow_v,
        "rho_squared": rho[:-1] ** 2,
        "u_drho_dx": flow_u * drho_dx[:-1],
        "v_drho_dy": flow_v * drho_dy[:-1],
    }
    return library, drho_dt[:-1]


def _discover(imgs_ds: Tensor, flow_u: Tensor, flow_v: Tensor, alphas: Tensor, *, dt, dx, dy, spatial_smooth):
    """Library, finite-row mask, the Lasso sweep over ``alphas`` as one
    batch, and the fit metrics, all on the stack's device. Returns
    (coefs (A, p), intercepts, ss_res, mae, ss_tot, n_eff, FISTA iterations
    (A,), the sweep's host syncs)."""
    library, target = build_transport_library(imgs_ds, flow_u, flow_v, dt, dx, dy)
    L = torch.stack([library[n] for n in TERM_NAMES] + [target])  # (p + 1, T - 1, H, W)
    if spatial_smooth > 0:
        L = gaussian_filter_reflect(L, spatial_smooth)
    L = L.reshape(L.shape[0], -1)
    X, y = L[:-1].T, L[-1]
    finite = torch.isfinite(X).all(dim=1) & torch.isfinite(y)
    mask = finite.to(X.dtype)
    X = torch.where(finite[:, None], X, 0.0)
    y = torch.where(finite, y, 0.0)
    n_eff = torch.sum(mask)
    y_mean = torch.sum(y * mask) / n_eff
    ss_tot = torch.sum(((y - y_mean) * mask) ** 2)
    coefs, intercepts, n_iter, syncs = lasso_fista(X, y, alphas, max_iter=5000, row_mask=mask)
    resid = (y[:, None] - (X @ coefs.T + intercepts)) * mask[:, None]  # (n, A)
    ss_res = torch.sum(resid**2, dim=0)
    mae = torch.sum(torch.abs(resid), dim=0) / n_eff
    return coefs, intercepts, ss_res, mae, ss_tot, n_eff, n_iter, syncs


def _mean_speed(fu: Tensor, fv: Tensor) -> Tensor:
    return torch.mean(torch.sqrt(fu**2 + fv**2))


def _normalized_pairs_input(cfg: TransportConfig, images: Tensor) -> tuple[Tensor, Tensor]:
    """(downsampled frames, the same min-max normalised per frame for the
    flow: the reference scales each frame to 0-255 before Farnebäck)."""
    T, H, W = images.shape
    imgs_ds = resize_bilinear(images, H // cfg.downsample, W // cfg.downsample)
    mn = torch.amin(imgs_ds, dim=(1, 2), keepdim=True)
    mx = torch.amax(imgs_ds, dim=(1, 2), keepdim=True)
    return imgs_ds, (imgs_ds - mn) / (mx - mn + 1e-12)


def _pair_flows(cfg: TransportConfig, imgs_n: Tensor) -> tuple[Tensor, Tensor]:
    """(flow_u, flow_v): the column and row components of every pair's flow."""
    flow_r, flow_c = farneback_flow_pairs(
        imgs_n, pyr_scale=0.5, levels=cfg.flow_levels, winsize=cfg.flow_winsize,
        iterations=cfg.flow_iterations, poly_n=cfg.flow_poly_n, poly_sigma=cfg.flow_poly_sigma,
        gaussian_win=False,
    )
    return flow_c, flow_r


def run(
    cfg: TransportConfig, U_raw: np.ndarray | None = None, timer=None, device: str | torch.device | None = None
) -> dict[str, Any]:
    """Transport discovery on ``U_raw`` (a (T, H, W) frame stack), or on the
    first ``cfg.max_images`` TIFFs of ``cfg.data_dir``. Runs on the CUDA
    card unless ``device="cpu"``; raises without a card otherwise.
    ``timer`` (a :class:`pdx_torch.utils.profiling.StageTimer`) times the
    stages."""
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    st = timer.stage if timer is not None else null_stage
    with st("load_images"):
        if U_raw is None:
            U_raw = load_images(cfg.data_dir, max_images=cfg.max_images, dtype=np.uint16)
    with st("ship_normalize_resize"):
        images = device_stack(U_raw, dtype, device=dev)
        images = images / images.max()
        imgs_ds, imgs_n = _normalized_pairs_input(cfg, images)
    with st("pair_flows"):
        flow_u, flow_v = _pair_flows(cfg, imgs_n)
    with st("discover_lasso_sweep"):
        alphas = torch.as_tensor(cfg.alphas, dtype=imgs_ds.dtype, device=dev)
        coefs, intercepts, ss_res_v, mae_v, ss_tot, n_eff, _, _ = _discover(
            imgs_ds, flow_u, flow_v, alphas, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy, spatial_smooth=cfg.spatial_smooth,
        )
    with st("host_readback"):
        # one read of everything the host needs
        A, p = coefs.shape
        host = torch.cat([
            coefs.reshape(-1), intercepts, ss_res_v, mae_v, torch.stack([ss_tot, n_eff, _mean_speed(flow_u, flow_v)])
        ]).cpu().numpy()
        coefs, rest = host[: A * p].reshape(A, p), host[A * p :]
        intercepts, ss_res_v, mae_v = rest[: 3 * A].reshape(3, A)
        ss_tot, n_eff, mean_speed = (float(v) for v in rest[3 * A :])

    results = {}
    for ai, alpha in enumerate(cfg.alphas):
        coef = coefs[ai]
        active = [(n, float(c)) for n, c in zip(TERM_NAMES, coef) if abs(float(c)) > 1e-10]
        results[float(alpha)] = {
            "coefficients": coef,
            "intercept": float(intercepts[ai]),
            "active_terms": active,
            "r2": 1.0 - float(ss_res_v[ai]) / ss_tot,
            "mse": float(ss_res_v[ai]) / n_eff,
            "mae": float(mae_v[ai]),
        }

    out = {
        "config": dataclasses.asdict(cfg),
        "term_names": TERM_NAMES,
        "results": results,
        "mean_flow_speed": mean_speed,
        "n_samples": int(n_eff),
    }
    if cfg.write_artifacts:
        with st("artifacts"):
            write_json(
                Path(cfg.output_dir) / "transport_results.json",
                {
                    "mean_flow_speed": mean_speed,
                    "term_names": TERM_NAMES,
                    "results": {str(a): dict(r) for a, r in results.items()},
                },
            )
    if timer is not None:
        out["stage_seconds"] = dict(timer.stages)
    return out


def mass_conservation_drift(U) -> float:
    """Relative drift of total intensity over the sequence in percent (the
    transport-form premise, transport_pde_discovery.py:10). A tensor is
    reduced on its device; the host reads only the (T,) sums."""
    if isinstance(U, Tensor):
        sums = torch.sum(U, dim=(1, 2)).cpu().numpy()
    else:
        sums = np.asarray(U).sum(axis=(1, 2))
    return float((sums.max() - sums.min()) / (sums.mean() + 1e-12) * 100.0)


def quick_run(
    cfg: TransportConfig, U_raw: np.ndarray | None = None, device: str | torch.device | None = None
) -> dict[str, Any]:
    """Smoke version: few frames, heavy downsample, plain least squares, and
    the physics check (transport_quick_test.py: 10 frames, 8x downsample,
    lstsq, 'transport coefficient should be ~ -1')."""
    dev = resolve_device(device)
    if U_raw is None:
        U_raw = load_images(cfg.data_dir, max_images=cfg.max_images, dtype=np.uint16)
    images = torch.as_tensor(np.asarray(U_raw), device=dev).to(torch.float64)
    images = images / images.max()
    imgs_ds, imgs_n = _normalized_pairs_input(cfg, images)
    flow_c, flow_r = _pair_flows(cfg, imgs_n)
    library, target = build_transport_library(imgs_ds, flow_c, flow_r, cfg.dt, cfg.dx, cfg.dy)
    X = torch.stack([library[n].reshape(-1) for n in TERM_NAMES], dim=1)
    y = target.reshape(-1)
    coef = lstsq_solve(X, y)
    resid = y - X @ coef
    r2 = 1.0 - float(torch.sum(resid**2)) / float(torch.sum((y - torch.mean(y)) ** 2))
    coef = coef.cpu().numpy()
    transport_coef = float(coef[TERM_NAMES.index("transport")])
    return {
        "coefficients": coef,
        "term_names": TERM_NAMES,
        "r2": r2,
        "transport_coef": transport_coef,
        "physics_check": (
            "continuity form predicts transport coefficient ~ -1; "
            f"got {transport_coef:+.4f}"
        ),
        "mean_flow_speed": float(_mean_speed(flow_r, flow_c)),
    }


def cmd_transport(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch transport")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/transport")
    parser.add_argument("--max-images", type=int, default=51)
    parser.add_argument("--downsample", type=int, default=4)
    parser.add_argument("--quick", action="store_true", help="10-frame 8x-downsample lstsq smoke test")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = TransportConfig(
        data_dir=args.data_dir, output_dir=args.output_dir,
        max_images=args.max_images, downsample=args.downsample,
    )
    if args.quick:
        cfg = dataclasses.replace(cfg, max_images=min(cfg.max_images, 10), downsample=8)
        q = quick_run(cfg, device=args.device)
        print(f"Mean optical-flow speed: {q['mean_flow_speed']:.3f} px/frame")
        print(f"R2 (lstsq, all terms): {q['r2']:.6f}")
        print(q["physics_check"])
        return 0
    out = run(cfg, device=args.device)
    print(f"Mean optical-flow speed: {out['mean_flow_speed']:.3f} px/frame")
    for alpha, r in out["results"].items():
        print(f"\nalpha={alpha}: R2={r['r2']:.6f}, active={len(r['active_terms'])}/{len(out['term_names'])}")
        for n, c in r["active_terms"]:
            print(f"  {c:+.6e} * {n}")
    return 0
