"""Patch-based SINDy with optional per-patch registration (port of
``pdx/pipelines/patch_sindy.py``; scripts/patch_based_sindy.py).

pre-denoise (spatial Gaussian, temporal Savitzky-Golay) -> overlapping patch
grid -> optional per-patch ECC or optical-flow registration, or one
optical-flow registration of the whole frames -> per-patch 11-term library
ridge fit (fit_intercept=False) over boundary-masked, subsampled points ->
quality = max(0, R^2) x registration quality -> quality-weighted ensemble
with high-variance terms suppressed.

The patches are one gather of the stack (``unfold``); the libraries are
built at the fitted points only, and all per-patch fits are one batch over
the patch axis, where ``pdx`` vmaps. Registration schedules:

  * ``ecc``: all patches as one batch, a host loop over time (each step
    registers to the previous registered frame), each step's ECC loop
    freezing every patch at its own stop (``register/ecc.py``);
  * ``optical_flow``, per patch: the compose path (all P(T-1) pair flows as
    batched pyramids, composed into to-first flows, one warp), or the chain
    (one batched flow over every patch a time step; ``flow_batch=False``: a
    chain a patch, as the reference structures it);
  * ``optical_flow`` with ``flow_scope="frame"``: the Farnebäck chain of the
    whole frames before the patches are cut.

``flow_compose=None`` composes on the card and chains on the CPU;
``flow_downsample=None`` computes the compose path's flows at 1/4 or 1/2
resolution on the card (the largest that keeps a 64 px flow grid) and at
full resolution on the CPU. Both policies read the tensor's device and no
environment variable. ``cfg.mesh`` splits the patch fits over the mesh that
``run`` takes (``pdx/shard/mesh.py``'s rule).
"""

from __future__ import annotations

import dataclasses
import random
import warnings
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
from pdx_torch.ops.interp import resize_bilinear, warp_flow_batch
from pdx_torch.ops.linalg import gram_stats, masked_ridge_solve, standardized_stats
from pdx_torch.ops.metrics import r2_score
from pdx_torch.register.ecc import register_sequence_info
from pdx_torch.register.farneback import (
    _FLOW_CHUNK_ELEMS,
    batched_pair_flows,
    compose_flow_chain,
    farneback_flow,
    farneback_register_sequence,
)
from pdx_torch.report.pipeline_figures import patch_sindy_figure_frame_indices
from pdx_torch.shard.mesh import Mesh, default_mesh, gather_leading, map_shards, maybe_shard_leading
from pdx_torch.utils.profiling import null_stage

TERM_NAMES = ["1", "u", "u_x", "u_y", "u_xx", "u_yy", "∇²u", "u²", "u·u_x", "u·u_y", "u·∇²u"]

# the per-patch flows' Farnebäck parameters (patch_based_sindy.py:198-221);
# refine=1, as pdx's chain and compose schedules use it
PATCH_FLOW = dict(levels=3, winsize=15, iterations=5, poly_n=7, poly_sigma=1.5, gaussian_win=False, refine=1)


@dataclass(frozen=True)
class PatchSindyConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/patch_sindy"
    max_images: int | None = None
    dt: float = 1.0
    dx: float = 0.1
    dy: float = 0.1
    patch_size: int = 256
    overlap: int = 64
    spatial_sigma: float = 0.3
    temporal_window: int = 3
    skip_boundary: int = 5
    subsample: int = 4
    alpha: float = 0.01
    min_patches: int = 5
    registration_method: str = "none"  # none | ecc | optical_flow
    # optical_flow scope: 'patch' = per-patch flows (reference parity);
    # 'frame' = register the whole frames once before the patches are cut
    flow_scope: str = "patch"  # patch | frame
    # per-patch chain: one batched flow over every patch a time step
    # (False: a chain a patch)
    flow_batch: bool = True
    # per-patch flows as batched pair flows composed into to-first flows;
    # None = compose on the card, chain on the CPU
    flow_compose: bool | None = None
    # compose path: flows at patch_size / flow_downsample; None = 4 or 2 on
    # the card (a flow grid >= 64 px), 1 on the CPU
    flow_downsample: int | None = None
    max_patches: int | None = None
    var_suppress_factor: float = 2.0
    dtype: str = "float64"
    write_artifacts: bool = True
    mesh: str = "auto"  # auto | off | on: split the patch fits over run's mesh


def _grid_coords(H: int, W: int, patch_size: int, stride: int) -> list[tuple[int, int]]:
    return [
        (y, x)
        for y in range(0, H - patch_size + 1, stride)
        for x in range(0, W - patch_size + 1, stride)
    ]


def extract_patch_sequences(U: Tensor, patch_size: int, stride: int) -> tuple[Tensor, list[tuple[int, int]]]:
    """(n_patches, T, ps, ps) patch sequences and their top-left corners,
    rows first: one gather of the stack."""
    T, H, W = U.shape
    coords = _grid_coords(H, W, patch_size, stride)
    if not coords:
        return U.new_zeros((0, T, patch_size, patch_size)), coords
    win = U.unfold(1, patch_size, stride).unfold(2, patch_size, stride)  # (T, nH, nW, ps, ps)
    return win.flatten(1, 2).movedim(1, 0).contiguous(), coords


def _point_index(ps: int, sb: int, sub: int) -> np.ndarray:
    """Flat indices of the fitted points of a (ps, ps) patch: the boundary
    of ``sb`` cut, every ``sub``-th row and column kept
    (patch_based_sindy.py:265-290)."""
    mask2 = np.zeros((ps, ps), dtype=bool)
    mask2[sb:-sb:1, sb:-sb:1] = True
    submask = np.zeros_like(mask2)
    submask[::sub, ::sub] = True
    return np.where((mask2 & submask).reshape(-1))[0]


def _patch_library(seqs: Tensor, idx: np.ndarray, dx: float, dy: float) -> Tensor:
    """The 11-term library of every frame of ``seqs`` (..., ps, ps) at the
    flat points ``idx``, with periodic central differences
    (patch_based_sindy.py:229-268; "x" is axis 1, the columns): (..., n, 11)."""
    ps = seqs.shape[-1]
    rows = torch.as_tensor(idx // ps, device=seqs.device)
    cols = torch.as_tensor(idx % ps, device=seqs.device)

    def at(dr: int, dc: int) -> Tensor:  # u shifted, as jnp.roll(u, (-dr, -dc)) reads it
        return seqs[..., torch.remainder(rows + dr, ps), torch.remainder(cols + dc, ps)]

    u, right, left, down, up = at(0, 0), at(0, 1), at(0, -1), at(1, 0), at(-1, 0)
    ux = (right - left) / (2 * dx)
    uy = (down - up) / (2 * dy)
    uxx = (right - 2 * u + left) / dx**2
    uyy = (down - 2 * u + up) / dy**2
    lap = uxx + uyy
    return torch.stack([torch.ones_like(u), u, ux, uy, uxx, uyy, lap, u**2, u * ux, u * uy, u * lap], dim=-1)


def discover_patches(seqs: Tensor, reg_quality: Tensor, cfg: PatchSindyConfig) -> tuple[Tensor, Tensor]:
    """Every patch's central-difference dataset over frames 1..T-2 and its
    standardised ridge fit, fit_intercept=False (patch_based_sindy.py:
    265-364), as one batch over the patch axis. Returns (coeffs (P, 11),
    quality (P,))."""
    P, T, ps, _ = seqs.shape
    idx = _point_index(ps, cfg.skip_boundary, cfg.subsample)
    lib = _patch_library(seqs[:, 1:-1], idx, cfg.dx, cfg.dy)  # (P, T-2, n, 11)
    cols = torch.as_tensor(idx, device=seqs.device)
    flat = seqs.flatten(-2)
    ut = (flat[:, 2:, cols] - flat[:, :-2, cols]) / (2 * cfg.dt)  # (P, T-2, n)
    X = lib.reshape(P, -1, len(TERM_NAMES))
    y = ut.reshape(P, -1)

    # sklearn: StandardScaler -> Ridge(fit_intercept=False) -> / scale_;
    # X_scaled^T y uses the raw y, as standardized_stats' bs does
    Gs, bs, _mean, scale = standardized_stats(gram_stats(X, y))
    full = torch.ones((P, X.shape[-1]), dtype=X.dtype, device=X.device)
    coeffs = masked_ridge_solve(Gs, bs, full, cfg.alpha) / scale
    y_pred = (X @ coeffs[..., None])[..., 0]
    r2 = r2_score(y, y_pred)
    return coeffs, torch.clamp(r2, min=0.0) * reg_quality


def _flow_warp_step(prev: Tensor, cur: Tensor) -> tuple[Tensor, Tensor]:
    """One step of the per-patch chain for a batch of patches (P, ps, ps):
    the float32 flow from the previous registered patch to the current one
    warps the current one (no flow smoothing); quality 1 / (1 + mean|flow|)
    a patch."""
    f32 = torch.float32 if cur.dtype == torch.float64 else cur.dtype
    fx, fy = farneback_flow(prev.to(f32), cur.to(f32), **PATCH_FLOW)
    fx, fy = fx.to(cur.dtype), fy.to(cur.dtype)
    q = 1.0 / (torch.mean(torch.sqrt(fx**2 + fy**2), dim=(-2, -1)) + 1.0)
    return warp_flow_batch(cur, fx, fy), q


def _flow_register_chain(seqs: Tensor) -> tuple[Tensor, Tensor]:
    """Warp-to-previous chain of every patch of ``seqs`` (P, T, ps, ps), one
    batched step a time step; per-patch quality averaged over the steps."""
    prev = seqs[:, 0]
    frames, qs = [prev], []
    for t in range(1, seqs.shape[1]):
        prev, q = _flow_warp_step(prev, seqs[:, t])
        frames.append(prev)
        qs.append(q)
    return torch.stack(frames, dim=1), torch.mean(torch.stack(qs), dim=0)


def _compose_all_prep(seqs: Tensor, ds: int = 1) -> tuple[Tensor, Tensor]:
    """The P(T-1) consecutive-pair operands of (P, T, ph, pw) patches, in
    float32, at 1/ds resolution (bilinear) when ds > 1."""
    P, T, ph, pw = seqs.shape
    f32 = torch.float32 if seqs.dtype == torch.float64 else seqs.dtype
    Sf = seqs.to(f32)
    prev = Sf[:, :-1].reshape(P * (T - 1), ph, pw)
    cur = Sf[:, 1:].reshape(P * (T - 1), ph, pw)
    if ds > 1:
        prev = resize_bilinear(prev, ph // ds, pw // ds)
        cur = resize_bilinear(cur, ph // ds, pw // ds)
    return prev, cur


def _compose_all_finish(seqs: Tensor, fx: Tensor, fy: Tensor) -> tuple[Tensor, Tensor]:
    """Compose the pair flows into to-first flows at the flow's resolution,
    upsample them once if needed, and warp every frame at full resolution.
    Quality a patch: mean over t of 1 / (1 + mean|f_t|) in full-resolution
    pixels."""
    P, T, ph, pw = seqs.shape
    hs, ws = fx.shape[-2], fx.shape[-1]
    sr, sc = ph / hs, pw / ws
    mag = torch.sqrt((sr * fx) ** 2 + (sc * fy) ** 2).reshape(P, T - 1, hs, ws)
    q = torch.mean(1.0 / (torch.mean(mag, dim=(-2, -1)) + 1.0), dim=1).to(seqs.dtype)
    Fx, Fy = compose_flow_chain(fx.reshape(P, T - 1, hs, ws), fy.reshape(P, T - 1, hs, ws), batched=True)
    Fx = Fx.reshape(P * (T - 1), hs, ws)
    Fy = Fy.reshape(P * (T - 1), hs, ws)
    if (hs, ws) != (ph, pw):
        Fx = resize_bilinear(Fx, ph, pw) * sr
        Fy = resize_bilinear(Fy, ph, pw) * sc
    # the warp in chunks of frames: its gather indices take 16 bytes a pixel
    # and corner, ~15 GB at once for 1,500 frames of 256 x 256
    frames = seqs[:, 1:].reshape(P * (T - 1), ph, pw)
    Fx, Fy = Fx.to(seqs.dtype), Fy.to(seqs.dtype)
    step = max(1, _FLOW_CHUNK_ELEMS // (ph * pw))
    warped = torch.cat([
        warp_flow_batch(frames[s : s + step], Fx[s : s + step], Fy[s : s + step]) for s in range(0, frames.shape[0], step)
    ]).reshape(P, T - 1, ph, pw)
    return torch.cat([seqs[:, :1], warped], dim=1), q


def _flow_register_compose_all(seqs: Tensor, flow_ds: int = 1) -> tuple[Tensor, Tensor]:
    """Per-patch registration with the patch and time axes batched: all
    P(T-1) pair flows as batched pyramids (``batched_pair_flows``), composed
    per patch into to-first flows, one batched warp."""
    prev, cur = _compose_all_prep(seqs, ds=flow_ds)
    fx, fy = batched_pair_flows(prev, cur, flow_static=PATCH_FLOW)
    return _compose_all_finish(seqs, fx, fy)


def _resolve_flow_compose(flow_compose: bool | None, device: torch.device) -> bool:
    """``flow_compose`` None: compose on the card, chain on the CPU."""
    if flow_compose is not None:
        return flow_compose
    return torch.device(device).type != "cpu"


def _resolve_flow_ds(flow_downsample: int | None, patch_size: int, device: torch.device) -> int:
    """The compose path's flow resolution. None: on the card the largest ds
    in {4, 2} that keeps the flow grid >= 64 px, on the CPU 1. An explicit
    value is honoured down to a 32 px grid."""
    if flow_downsample is not None:
        ds = int(flow_downsample)
    elif torch.device(device).type == "cpu":
        ds = 1
    else:
        return 4 if patch_size // 4 >= 64 else (2 if patch_size // 2 >= 64 else 1)
    while ds > 1 and patch_size // ds < 32:
        ds //= 2
    return max(1, ds)


def register_patches(cfg: PatchSindyConfig, seqs: Tensor) -> tuple[Tensor, Tensor]:
    """The per-patch registration schedule of ``cfg`` (patch_sindy.py:
    504-578 in pdx): (registered patches, registration quality a patch)."""
    P = seqs.shape[0]
    ones = torch.ones((P,), dtype=seqs.dtype, device=seqs.device)
    method = cfg.registration_method
    if method == "optical_flow" and cfg.flow_scope == "frame":
        return seqs, ones  # the frames were registered before the cut
    if method == "ecc":
        out, ccs, _iters, _syncs = register_sequence_info(seqs, motion="euclidean", gauss_sigma=1.0)
        return out, torch.mean(ccs, dim=-1)
    if method == "optical_flow" and cfg.flow_batch and _resolve_flow_compose(cfg.flow_compose, seqs.device):
        ps = seqs.shape[-1]
        return _flow_register_compose_all(seqs, flow_ds=_resolve_flow_ds(cfg.flow_downsample, ps, seqs.device))
    if method == "optical_flow" and cfg.flow_batch:
        return _flow_register_chain(seqs)
    if method == "optical_flow":  # a chain a patch, as the reference structures it
        outs = [_flow_register_chain(seqs[pi : pi + 1]) for pi in range(P)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    return seqs, ones


def _select_frames_f32(U: Tensor, idxs: list[int], ds: int = 1) -> np.ndarray:
    """The figure's frames in float32, downsampled on the device to display
    resolution before the host read."""
    F = U[torch.as_tensor(idxs, device=U.device)].to(torch.float32)
    if ds > 1:
        F = resize_bilinear(F, U.shape[-2] // ds, U.shape[-1] // ds)
    return F.cpu().numpy()


def run(
    cfg: PatchSindyConfig,
    U_raw: np.ndarray | None = None,
    timer=None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> dict[str, Any]:
    """Patch SINDy on ``U_raw`` (a (T, H, W) stack, used as it is), or on
    the TIFFs of ``cfg.data_dir`` read as 8-bit grayscale and scaled by
    1/255. Runs on the CUDA card unless ``device="cpu"``; raises without a
    card otherwise. ``timer`` (a :class:`pdx_torch.utils.profiling.
    StageTimer`) times the stages. ``mesh`` (default: every visible card on
    a CUDA device, the one device on the CPU, where ``pdx`` takes every JAX
    device) carries the patch fits."""
    dev = resolve_device(device)
    mesh = default_mesh(dev) if mesh is None else mesh
    dtype = resolve_dtype(cfg.dtype)
    st = timer.stage if timer is not None else null_stage
    if U_raw is None:
        with st("load_images"):
            U_raw = load_images(
                cfg.data_dir, max_images=cfg.max_images or 10**9, mode="grayscale_u8", dtype=np.uint8,
            )
            U = device_stack(U_raw, device=dev).to(dtype) / 255.0
    else:
        U = device_stack(U_raw, dtype, device=dev)

    with st("denoise"):  # patch_based_sindy.py:88-119
        U = gaussian_filter_reflect(U, cfg.spatial_sigma)
        if U.shape[0] >= cfg.temporal_window:
            U = savgol_time(U, cfg.temporal_window, 2)

    # the reference's 256 px patches assume ~1024 px frames; smaller frames
    # would give an empty grid
    T_, H_, W_ = U.shape
    patch_size = min(cfg.patch_size, H_, W_)
    overlap = min(cfg.overlap, patch_size - 1) if patch_size < cfg.patch_size else cfg.overlap
    if patch_size != cfg.patch_size:
        warnings.warn(f"patch_size {cfg.patch_size} exceeds frame size {H_}x{W_}; clamped to {patch_size}")
    stride = patch_size - overlap
    if cfg.registration_method == "optical_flow" and cfg.flow_scope == "frame":
        with st("frame_registration"):
            U = farneback_register_sequence(
                U, levels=3, winsize=15, iterations=5, poly_n=7, poly_sigma=1.5, gaussian_win=False,
            )
    with st("extract_patches"):
        seqs, coords = extract_patch_sequences(U, patch_size, stride)
        if seqs.shape[0] == 0:
            raise RuntimeError(f"patch grid is empty for patch_size={patch_size}, frames {H_}x{W_}")
        if cfg.max_patches is not None and seqs.shape[0] > cfg.max_patches:
            random.seed(0)  # pdx's host draw: both packages keep the same patches
            keep = sorted(random.sample(range(seqs.shape[0]), cfg.max_patches))
            seqs = seqs[torch.as_tensor(keep, device=dev)]
            coords = [coords[i] for i in keep]

    with st("registration"):
        seqs, qualities = register_patches(cfg, seqs)
    with st("discovery"):
        # the patch axis split over the mesh; results sliced back to the true
        # patch count before the quality clamp, as in pdx
        (seqs_s, qual_s), P_orig = maybe_shard_leading((seqs, qualities.to(seqs.dtype)), cfg.mesh, mesh)
        parts = map_shards(lambda s, q: discover_patches(s, q, cfg), (seqs_s, qual_s), mesh)
        n_shard_devices = len(parts)  # shards the patch axis was split into
        coeffs, qual = gather_leading(parts, mesh)
        host = torch.cat([coeffs, qual[:, None]], dim=1)[:P_orig].cpu().numpy()  # one read
    C, Q = host[:, :-1], np.maximum(host[:, -1], 0.0)

    valid = Q > -0.5
    C, Q = C[valid], Q[valid]
    if C.shape[0] < cfg.min_patches:
        raise RuntimeError(f"Too few valid patches ({C.shape[0]} < {cfg.min_patches})")

    # quality-weighted aggregation + variance suppression (patch_based_sindy.py:450-467)
    w = Q / (Q.sum() + 1e-12)
    ens = np.average(C, axis=0, weights=w) if Q.sum() > 0 else C.mean(axis=0)
    std = np.sqrt(np.average((C - ens) ** 2, axis=0, weights=w)) if Q.sum() > 0 else C.std(axis=0)
    thr = np.median(std) * cfg.var_suppress_factor
    ens = np.where(std > thr, 0.0, ens)

    out = {
        "config": dataclasses.asdict(cfg),
        "term_names": TERM_NAMES,
        "coeffs": ens,
        "coeffs_std": std,
        "patch_coeffs": C,
        "n_patches": int(C.shape[0]),
        "n_shard_devices": n_shard_devices,
        "avg_quality": float(Q.mean()),
        "quality_std": float(Q.std()),
    }
    if cfg.write_artifacts:
        out_dir = Path(cfg.output_dir)
        with st("artifacts"):
            write_json(
                out_dir / "patch_sindy_results.json",
                {k: v for k, v in out.items() if k not in ("config", "patch_coeffs")},
            )
            # patch_based_sindy_results.png (patch_based_sindy.py:641-642 via
            # :525-572): its 4 frames are gathered and downsampled on the
            # device outside the guard; only the drawing may be skipped
            fig_idx = patch_sindy_figure_frame_indices(T_)
            fig_ds = 1
            while (H_ // (2 * fig_ds)) >= 512:
                fig_ds *= 2
            fig_frames = _select_frames_f32(U, fig_idx, ds=fig_ds)
            try:
                from pdx_torch.report.pipeline_figures import patch_sindy_results

                patch_sindy_results(
                    out_dir, fig_frames, coords, patch_size, ens, std, TERM_NAMES, int(C.shape[0]),
                    frame_indices=fig_idx, full_shape=(H_, W_),
                )
            except Exception as e:  # pragma: no cover - keep discovery results robust
                print(f"   (skipped patch_based_sindy_results.png: {e})")
    if timer is not None:
        out["stage_seconds"] = dict(timer.stages)
    return out


def parse_args(argv: list[str]) -> tuple[PatchSindyConfig, str]:
    """(configuration, device) from ``pdx patch-sindy``'s flags plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch patch-sindy")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/patch_sindy")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--patch-size", type=int, default=256)
    parser.add_argument("--overlap", type=int, default=64)
    parser.add_argument("--registration", choices=["none", "ecc", "optical_flow"], default="none")
    parser.add_argument("--flow-scope", choices=["patch", "frame"], default="patch",
                        help="optical_flow granularity: per-patch (reference parity) or whole-frame")
    parser.add_argument("--max-patches", type=int, default=None)
    parser.add_argument("--flow-impl", choices=["auto", "compose", "chain"], default="auto",
                        help="per-patch flow execution: batched pair flows composed, or the per-time-step "
                        "chain (auto = compose on the card, chain on the CPU)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = PatchSindyConfig(
        data_dir=args.data_dir, output_dir=args.output_dir, max_images=args.max_images,
        patch_size=args.patch_size, overlap=args.overlap,
        registration_method=args.registration, max_patches=args.max_patches,
        flow_scope=args.flow_scope,
        flow_compose={"auto": None, "compose": True, "chain": False}[args.flow_impl],
    )
    return cfg, args.device


def cmd_patch_sindy(argv: list[str]) -> int:
    cfg, device = parse_args(argv)
    out = run(cfg, device=device)
    print(f"Valid patches: {out['n_patches']}  avg quality: {out['avg_quality']:.4f}")
    terms = [f"{c:+.6e}·{n}" for c, n in zip(out["coeffs"], out["term_names"]) if abs(c) > 1e-7]
    print("u_t = " + ("  ".join(terms) if terms else "0"))
    return 0
