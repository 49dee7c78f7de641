"""Patch-based PDE discovery on a real image stack (port of
``pdx/pipelines/patch_discovery.py``).

load -> downsample, denoise, normalise -> [Farnebäck registration] ->
smooth -> crop and subsample -> overlapping patch grid -> per-patch sampled
local-polynomial derivative datasets -> per-patch STRidge -> stability
aggregation (median, IQR, frequency, sign; keep frequency >= 0.6) -> held-out
evaluation and a one-step check -> CSV, report, JSON and figure.

The sample points are drawn on the host with numpy in ``pdx``'s order, so
both packages fit the same rows. All patches' derivatives are one gather and
one product (``library/localpoly.py``); all per-patch fits are one batch over
the patch axis (``gram_stats`` and ``stridge_from_stats`` take leading batch
axes), where ``pdx`` vmaps; ``cfg.mesh`` splits that patch axis over the
mesh that ``run`` and :func:`discover` take (``pdx/shard/mesh.py``'s rule).

:func:`run` is the entry point; its stages (:func:`preprocess_head`,
:func:`register`, :func:`discover`) can be called apart, so that a test can
feed another package's registered stack to :func:`discover`.
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
from pdx_torch.io_host.artifacts import write_json, write_patch_csv
from pdx_torch.io_host.images import device_stack, load_images
from pdx_torch.library.localpoly import local_poly_derivatives_batch
from pdx_torch.ops.filters import gaussian_filter_reflect
from pdx_torch.ops.linalg import gram_stats
from pdx_torch.ops.metrics import regression_metrics
from pdx_torch.preprocess import resize_denoise_normalize
from pdx_torch.register.farneback import register_sequence_dispatch
from pdx_torch.shard.mesh import Mesh, default_mesh, gather_leading, map_shards, maybe_shard_leading
from pdx_torch.solve.robust import median
from pdx_torch.solve.stridge import stridge_from_stats
from pdx_torch.utils.profiling import StageTimer, null_stage, span

FULL_TERMS = ["one", "u", "ux", "uy", "lap", "u2", "u_ux", "u_uy"]
MODEL4_TERMS = ["one", "u", "ux", "uy", "lap", "u2"]
DISPLAY = {"one": "1", "u": "u", "ux": "u_x", "uy": "u_y", "lap": "lap(u)", "u2": "u^2", "u_ux": "u*u_x", "u_uy": "u*u_y"}
METRIC_KEYS = ("rmse", "r2", "nrmse", "mae", "corr")


@dataclass(frozen=True)
class PatchDiscoveryConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/patch_pde"
    max_images: int = 51
    seed: int = 0
    registration: bool = True
    register_mode: str = "auto"  # auto | compose | chain | to_first
    register_refine: int = 1  # re-warp refinement passes per flow
    rt: int = 2
    rs: int = 3
    deg: int = 3
    patch: int = 21
    overlap: int = 10
    samples_per_patch: int = 120
    train_frac: float = 0.7
    alpha: float = 0.01
    threshold: float = 1e-5
    stability_freq: float = 0.6
    model: str = "full"  # full | model4
    # preprocessing constants (patch_based_pde_discovery.py:332-352)
    downsample: int = 2
    denoise_sigma1: float = 1.0
    denoise_sigma2: float = 1.2
    skip: int = 25
    subsample: int = 12
    dx: float = 0.1
    dy: float = 0.1
    dt: float = 1.0
    reference_compat_warp: bool = False
    dtype: str = "float64"
    write_artifacts: bool = True
    mesh: str = "auto"  # auto | off | on: split the patch fits over the mesh


def patch_grid(h: int, w: int, patch: int, overlap: int) -> list[tuple[int, int]]:
    """Top-left corners of the overlapping patch grid
    (patch_based_pde_discovery.py:283-289)."""
    stride = max(1, patch - overlap)
    return [(y0, x0) for y0 in range(0, h - patch + 1, stride) for x0 in range(0, w - patch + 1, stride)]


def feature_matrix(derivs: Tensor, names: list[str]) -> Tensor:
    """(..., N, 6) local-poly derivatives -> (..., N, p) library rows
    (patch_based_pde_discovery.py:156-173)."""
    u, _ut, ux, uy, uxx, uyy = derivs.unbind(-1)
    fields = {
        "one": torch.ones_like(u),
        "u": u,
        "ux": ux,
        "uy": uy,
        "lap": uxx + uyy,
        "u2": u**2,
        "u_ux": u * ux,
        "u_uy": u * uy,
    }
    return torch.stack([fields[n] for n in names], dim=-1)


def _term_names(cfg: PatchDiscoveryConfig) -> list[str]:
    return MODEL4_TERMS if cfg.model == "model4" else FULL_TERMS


def preprocess_head(cfg: PatchDiscoveryConfig, U_raw: np.ndarray, device: torch.device, timer=None) -> Tensor:
    """The raw (T, H, W) stack shipped as it is (uint16 camera frames move
    4x fewer bytes than float64), downsampled, cast, denoised, normalised.
    Stage ``preprocess`` of ``timer``, with the spans ``patch.upload`` and
    ``patch.resize_denoise``."""
    T0, H0, W0 = U_raw.shape
    st = timer.stage if timer is not None else null_stage
    with st("preprocess"):
        with span("patch.upload"):
            U = device_stack(U_raw, device=device)
        with span("patch.resize_denoise"):
            return resize_denoise_normalize(
                U, out_h=H0 // cfg.downsample, out_w=W0 // cfg.downsample,
                sigma=cfg.denoise_sigma1, eps=1e-12, dtype_name=cfg.dtype,
            )


def register(cfg: PatchDiscoveryConfig, U: Tensor, timer=None) -> Tensor:
    """Farnebäck registration of the working stack, when configured: stage
    ``register`` of ``timer`` (the chain's spans are
    :func:`~pdx_torch.register.farneback.farneback_register_sequence`'s)."""
    if not cfg.registration:
        return U
    st = timer.stage if timer is not None else null_stage
    with st("register"):
        return register_sequence_dispatch(
            U, mode=cfg.register_mode, refine=cfg.register_refine, reference_compat_warp=cfg.reference_compat_warp,
        )


def working_stack(cfg: PatchDiscoveryConfig, U: Tensor) -> Tensor:
    """Smooth the registered stack, crop ``skip`` pixels a side and keep
    every ``subsample``-th pixel."""
    U = gaussian_filter_reflect(U, cfg.denoise_sigma2)
    s, sub = cfg.skip, cfg.subsample
    return U[:, s:-s:sub, s:-s:sub].contiguous()


def sample_patch_points(cfg: PatchDiscoveryConfig, shape: tuple[int, int, int]):
    """The host draws of the per-patch sample points, in ``pdx``'s order.
    Returns (rng, train points (P, n, 3), test points (P, n_te, 3),
    t_valid, t_test); the rng goes on to the held-out draws."""
    t_len, h, w = shape
    rt, rs = cfg.rt, cfg.rs
    t_min, t_max = rt, t_len - rt - 1
    if t_max <= t_min + 2:
        raise RuntimeError("too few frames for the local-poly time radius")
    t_valid = np.arange(t_min, t_max + 1)
    split = int(np.floor(cfg.train_frac * len(t_valid)))
    t_train, t_test = t_valid[:split], t_valid[split:]
    if len(t_test) < 3:
        raise RuntimeError("Test set too small.")
    coords = patch_grid(h, w, cfg.patch, cfg.overlap)
    if not coords:
        raise RuntimeError(
            f"Patch grid is empty: working grid {h}x{w} is smaller than patch={cfg.patch}. "
            "Reduce --patch or --subsample/--skip."
        )

    rng = np.random.default_rng(cfg.seed)
    n_s = cfg.samples_per_patch
    n_te = max(30, n_s // 3)
    train_pts, test_pts = [], []
    for (y0, x0) in coords:
        ys_low, ys_high = max(rs, y0 + rs), min(h - rs, y0 + cfg.patch - rs)
        xs_low, xs_high = max(rs, x0 + rs), min(w - rs, x0 + cfg.patch - rs)
        if ys_high <= ys_low or xs_high <= xs_low:
            continue
        ys = rng.integers(ys_low, ys_high, size=n_s)
        xs = rng.integers(xs_low, xs_high, size=n_s)
        ts = rng.choice(t_train, size=n_s, replace=True)
        train_pts.append(np.stack([ts, ys, xs], axis=1))
        ys2 = rng.integers(ys_low, ys_high, size=n_te)
        xs2 = rng.integers(xs_low, xs_high, size=n_te)
        ts2 = rng.choice(t_test, size=n_te, replace=True)
        test_pts.append(np.stack([ts2, ys2, xs2], axis=1))
    return rng, np.stack(train_pts), np.stack(test_pts), t_valid, t_test


def _local_poly(cfg: PatchDiscoveryConfig, U: Tensor, pts: np.ndarray) -> Tensor:
    return local_poly_derivatives_batch(
        U, pts.reshape(-1, 3), rt=cfg.rt, rs=cfg.rs, deg=cfg.deg, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy
    ).reshape(pts.shape[:-1] + (6,))


def patch_datasets(cfg: PatchDiscoveryConfig, U: Tensor, train_pts: np.ndarray, test_pts: np.ndarray):
    """Every patch's train and test derivative rows, (P, n, 6) each: one
    gather and one product per set."""
    return _local_poly(cfg, U, train_pts), _local_poly(cfg, U, test_pts)


def all_patch_fits(d_tr: Tensor, d_te: Tensor, *, names: list[str], alpha: float, threshold: float):
    """Per-patch STRidge on the train rows, as one batch over the patch
    axis, and each patch's train and test metrics. Returns (coeffs (P, p),
    train metrics, test metrics), the metrics as dicts of (P,) tensors."""
    X_tr, y_tr = feature_matrix(d_tr, names), d_tr[..., 1]
    X_te, y_te = feature_matrix(d_te, names), d_te[..., 1]
    c = stridge_from_stats(gram_stats(X_tr, y_tr), alpha=alpha, threshold=threshold, max_iter=25).coeffs
    m_tr = regression_metrics(y_tr, (X_tr @ c[..., None])[..., 0])
    m_te = regression_metrics(y_te, (X_te @ c[..., None])[..., 0])
    return c, m_tr, m_te


def heldout_eval(U: Tensor, Xg: Tensor, yg: Tensor, Xs: Tensor, spts: Tensor, agg: Tensor, dt: float):
    """Held-out metrics of the aggregated model and the one-step RMSE of
    the frame differences (reference :446-465). ``resid_med_abs`` averages
    the middle pair, as ``jnp.median`` does."""
    pred_g = Xg @ agg
    m = regression_metrics(yg, pred_g)
    m["resid_med_abs"] = median(torch.abs(yg - pred_g))
    t, y, x = spts.unbind(-1)
    du = U[t + 1, y, x] - U[t, y, x]
    one_step = torch.sqrt(torch.mean((du - dt * (Xs @ agg)) ** 2))
    return m, one_step


def discover(cfg: PatchDiscoveryConfig, U: Tensor, mesh: Mesh | None = None, timer=None) -> dict[str, Any]:
    """Everything after registration, on the registered (T, H, W) stack.
    The patch fits split over ``mesh`` (default: :func:`~pdx_torch.shard.
    mesh.default_mesh` of the stack's device) as ``cfg.mesh`` says. Stage
    ``discover`` of ``timer``, with the spans ``patch.datasets``,
    ``patch.fits``, ``patch.readback``, ``patch.aggregate`` and
    ``patch.heldout``."""
    st = timer.stage if timer is not None else null_stage
    with st("discover"):
        return _discover(cfg, U, default_mesh(U.device) if mesh is None else mesh)


def _discover(cfg: PatchDiscoveryConfig, U: Tensor, mesh: Mesh) -> dict[str, Any]:
    with span("patch.datasets"):
        U = working_stack(cfg, U)
        t_len, h, w = U.shape
        names = _term_names(cfg)
        rng, train_pts, test_pts, t_valid, t_test = sample_patch_points(cfg, (t_len, h, w))
        P, p = train_pts.shape[0], len(names)
        d_tr, d_te = patch_datasets(cfg, U, train_pts, test_pts)

    with span("patch.fits"):
        # the patch axis split over the mesh: padding repeats the last patch and
        # is sliced off below, so results are the single-device ones
        (d_tr, d_te), P = maybe_shard_leading((d_tr, d_te), cfg.mesh, mesh)
        parts = map_shards(
            lambda a, b: all_patch_fits(a, b, names=names, alpha=cfg.alpha, threshold=cfg.threshold),
            (d_tr, d_te), mesh,
        )
        n_shard_devices = len(parts)  # shards the patch axis was split into
        coeffs, m_tr_v, m_te_v = gather_leading(parts, mesh)
    with span("patch.readback"):
        # one read of the whole fit result
        host = torch.cat(
            [coeffs] + [torch.stack([m[k] for k in METRIC_KEYS], dim=-1) for m in (m_tr_v, m_te_v)], dim=-1
        )[:P].cpu().numpy()
    C = host[:, :p]
    m_tr_np, m_te_np = host[:, p : p + 5], host[:, p + 5 :]
    patch_train_metrics = [dict(zip(METRIC_KEYS, map(float, row))) for row in m_tr_np]
    patch_test_metrics = [dict(zip(METRIC_KEYS, map(float, row))) for row in m_te_np]

    with span("patch.aggregate"):
        # stability aggregation (reference :434-443: a plain median for the aggregate)
        nonzero = np.abs(C) > cfg.threshold
        freq = nonzero.mean(axis=0)
        med = np.median(C, axis=0)
        q25 = np.percentile(C, 25, axis=0)
        q75 = np.percentile(C, 75, axis=0)
        sign_stability = np.mean(np.sign(C) == np.sign(med + 1e-12), axis=0)
        keep = freq >= cfg.stability_freq
        agg = np.where(keep, med, 0.0)

    with span("patch.heldout"):
        # held-out evaluation (reference :446-465)
        rs = cfg.rs
        gpts = _safe_sample_points(rng, t_test, h, w, rs, 800)
        dg = _local_poly(cfg, U, gpts)
        spts = _safe_sample_points(rng, t_valid[:-1], h, w, rs, 1200)
        ds = _local_poly(cfg, U, spts)
        m_test, one_step = heldout_eval(
            U, feature_matrix(dg, names), dg[:, 1], feature_matrix(ds, names),
            torch.as_tensor(spts, device=U.device), torch.as_tensor(agg, dtype=U.dtype, device=U.device), cfg.dt,
        )
        keys = list(m_test)
        vals = torch.stack([m_test[k] for k in keys] + [one_step]).cpu().tolist()
    m_test = dict(zip(keys, vals[:-1]))
    one_step_rmse = vals[-1]

    eq_parts = []
    for coef, n in zip(agg, names):
        if abs(coef) > cfg.threshold:
            sign = "+" if coef > 0 and eq_parts else ""
            eq_parts.append(f"{sign}{coef:.4g}·{DISPLAY.get(n, n)}")
    equation = "u_t = " + (" ".join(eq_parts) if eq_parts else "0")

    stats = {
        "median": med, "q25": q25, "q75": q75, "freq": freq,
        "sign_stability": sign_stability, "keep": keep, "coeffs": agg,
    }
    out = {
        "config": dataclasses.asdict(cfg),
        "names": [DISPLAY.get(n, n) for n in names],
        "patch_coeffs": C,
        "stats": stats,
        "n_patches": P,
        "n_shard_devices": n_shard_devices,
        "working_shape": (t_len, h, w),
        "patch_train_metrics": patch_train_metrics,
        "patch_test_metrics": patch_test_metrics,
        "global_test_metrics": m_test,
        "one_step_rmse": one_step_rmse,
        "equation": equation,
    }
    if cfg.write_artifacts:
        _write_artifacts(cfg, out)
    return out


def run(
    cfg: PatchDiscoveryConfig,
    U_raw: np.ndarray | None = None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
    timer=None,
) -> dict[str, Any]:
    """Patch discovery on ``U_raw`` (a (T, H, W) frame stack), or on the
    first ``cfg.max_images`` TIFFs of ``cfg.data_dir``. Runs on the CUDA
    card unless ``device="cpu"``; raises without a card otherwise. ``mesh``
    (default: every visible card on a CUDA device, the one device on the
    CPU, where ``pdx`` takes every JAX device) carries the patch fits.
    ``timer`` (a :class:`pdx_torch.utils.profiling.StageTimer`) times the
    stages ``load_images`` (without ``U_raw``), ``preprocess``, ``register``
    and ``discover``."""
    dev = resolve_device(device)
    resolve_dtype(cfg.dtype)  # refuse an unknown dtype before any work
    if U_raw is None:
        st = timer.stage if timer is not None else null_stage
        with st("load_images"):
            U_raw = load_images(cfg.data_dir, max_images=cfg.max_images, dtype=np.uint16)
    return discover(cfg, register(cfg, preprocess_head(cfg, U_raw, dev, timer), timer), mesh, timer)


def _safe_sample_points(rng, t_indices, h, w, rs, n) -> np.ndarray:
    """patch_based_pde_discovery.py:249-260."""
    ys = rng.integers(rs, h - rs, size=n)
    xs = rng.integers(rs, w - rs, size=n)
    ts = rng.choice(t_indices, size=n, replace=True)
    return np.stack([ts, ys, xs], axis=1)


def _write_artifacts(cfg: PatchDiscoveryConfig, out: dict) -> None:
    out_dir = Path(cfg.output_dir)
    stats, m_test = out["stats"], out["global_test_metrics"]
    write_patch_csv(out_dir / "PATCH_PDE_COEFFS.csv", out["names"], stats)
    _write_report(out_dir / "PATCH_PDE_REPORT.txt", cfg, out)
    write_json(out_dir / "patch_pde_summary.json", {
        "equation": out["equation"], "global_test_metrics": m_test,
        "one_step_rmse": out["one_step_rmse"], "n_patches": out["n_patches"],
        "terms": out["names"], "agg_coeffs": stats["coeffs"],
    })
    # PATCH_PDE_SUMMARY.png (patch_based_pde_discovery.py:564-565); an
    # optional artifact, skipped as in pdx when matplotlib cannot draw it
    try:
        from pdx_torch.report.pipeline_figures import patch_pde_summary

        patch_pde_summary(out_dir, out["names"], stats, m_test, out["one_step_rmse"], cfg.stability_freq)
    except Exception as e:  # pragma: no cover - keep discovery results robust
        print(f"   (skipped PATCH_PDE_SUMMARY.png: {e})")


def _write_report(path: Path, cfg: PatchDiscoveryConfig, out: dict) -> None:
    from datetime import datetime

    path.parent.mkdir(parents=True, exist_ok=True)

    def summarize(ms):
        return {
            "r2_mean": float(np.mean([m["r2"] for m in ms])),
            "r2_median": float(np.median([m["r2"] for m in ms])),
            "rmse_mean": float(np.mean([m["rmse"] for m in ms])),
            "rmse_median": float(np.median([m["rmse"] for m in ms])),
            "nrmse_mean": float(np.mean([m["nrmse"] for m in ms])),
        }

    tr, te = summarize(out["patch_train_metrics"]), summarize(out["patch_test_metrics"])
    m = out["global_test_metrics"]
    t_len, h, w = out["working_shape"]
    with path.open("w", encoding="utf-8") as f:
        f.write("PATCH-BASED PDE DISCOVERY REPORT (ROBUST)\n")
        f.write(f"Generated: {datetime.now():%Y-%m-%d %H:%M:%S}\n\n")
        f.write(f"Frames used: {cfg.max_images}\n")
        f.write(f"Grid after preprocessing: T={t_len}, H={h}, W={w}\n")
        f.write(f"Registration: {'ON' if cfg.registration else 'OFF'}\n")
        f.write(f"Local derivative neighborhood: rt={cfg.rt}, rs={cfg.rs}, degree={cfg.deg}\n")
        f.write(f"Patch grid: patch={cfg.patch}, overlap={cfg.overlap}, patches_fit={out['n_patches']}\n")
        f.write(f"Model term set: {cfg.model}\n")
        f.write(f"STRidge: alpha={cfg.alpha}, threshold={cfg.threshold}\n")
        f.write(f"Stability keep rule: nonzero_freq >= {cfg.stability_freq}\n\n")
        f.write("Per-patch metrics (train) summary:\n")
        f.write(f"  R2 mean={tr['r2_mean']:.4f}, median={tr['r2_median']:.4f}\n")
        f.write(f"  RMSE mean={tr['rmse_mean']:.6f}, median={tr['rmse_median']:.6f}\n\n")
        f.write("Per-patch metrics (test) summary:\n")
        f.write(f"  R2 mean={te['r2_mean']:.4f}, median={te['r2_median']:.4f}\n")
        f.write(f"  RMSE mean={te['rmse_mean']:.6f}, median={te['rmse_median']:.6f}\n\n")
        f.write("Aggregated model (test samples) metrics:\n")
        f.write(f"  R2={m['r2']:.6f}\n  RMSE={m['rmse']:.6f}\n  nRMSE={m['nrmse']:.3f}\n")
        f.write(f"  one-step RMSE (sampled)={out['one_step_rmse']:.6f}\n\n")
        f.write(f"Aggregated PDE:\n  {out['equation']}\n")


def cmd_patch_discover(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch patch-discover")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/patch_pde")
    parser.add_argument("--max-images", type=int, default=51)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-registration", action="store_true")
    parser.add_argument("--register-mode", choices=["auto", "compose", "chain", "to_first"], default="auto")
    parser.add_argument("--register-refine", type=int, default=1,
                        help="re-warp refinement passes per flow (0 = strict cv2-equivalent, 2 = max quality)")
    parser.add_argument("--rt", type=int, default=2)
    parser.add_argument("--rs", type=int, default=3)
    parser.add_argument("--deg", type=int, default=3)
    parser.add_argument("--patch", type=int, default=21)
    parser.add_argument("--overlap", type=int, default=10)
    parser.add_argument("--samples-per-patch", type=int, default=120)
    parser.add_argument("--model", choices=["full", "model4"], default="full")
    parser.add_argument("--skip", type=int, default=25, help="crop margin in working pixels")
    parser.add_argument("--subsample", type=int, default=12, help="spatial subsample stride")
    parser.add_argument("--profile", action="store_true", help="print the stages' seconds and the program's spans")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = PatchDiscoveryConfig(
        data_dir=args.data_dir, output_dir=args.output_dir, max_images=args.max_images,
        seed=args.seed, registration=not args.no_registration,
        register_mode=args.register_mode, register_refine=args.register_refine,
        rt=args.rt, rs=args.rs, deg=args.deg, patch=args.patch, overlap=args.overlap,
        samples_per_patch=args.samples_per_patch, model=args.model,
        skip=args.skip, subsample=args.subsample,
    )
    timer = StageTimer() if args.profile else None
    out = run(cfg, device=args.device, timer=timer)
    if timer is not None:
        print(timer.report())
    print(f"Patches fit: {out['n_patches']}")
    print(f"Aggregated PDE: {out['equation']}")
    m = out["global_test_metrics"]
    print(f"Test: R2={m['r2']:.6f} RMSE={m['rmse']:.6f} nRMSE={m['nrmse']:.3f}")
    return 0
