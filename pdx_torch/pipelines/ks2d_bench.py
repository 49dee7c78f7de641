"""KS-2D ground-truth STRidge benchmark.

Port of ``pdx/pipelines/ks2d_bench.py``: simulate (explicit Euler) ->
perturb -> stabilise -> denoise -> {pointwise | blockwise | weakform}
dataset -> {standard | huber | trimmed | sign_constrained | ensemble |
robust} STRidge, optionally over the 5 x 6 alpha x threshold grid with
host-side selection by (R^2, -n_active, -rmse) -> ground-truth errors and a
rollout. :func:`run` accepts every configuration that ``pdx``'s accepts.

The grid-search fast path (pointwise, or blockwise with the streaming
kernels; standard regression) has three branches:

* ``solver="auto"`` / ``"gram"`` / ``"qr"``: a 50k-sample pointwise dataset
  drawn with the reference's host numpy RNG (seed 0), a 70/30 split, the grid
  on the train Gram statistics (or by QR of the train rows: ``"qr"``, and
  ``"auto"`` for the rich dictionary in float32), scored on the test rows;
* ``solver="pallas"``: the full-field statistics from kernel K1
  (:func:`~pdx_torch.ops.kernels.fused_gram.fused_ks_gram`) for the true
  library [lap, bih, gradsq], or K2
  (:func:`~pdx_torch.ops.kernels.fused_gram.fused_ks_gram_terms`) for any
  other term list (the rich library, advection);
* ``solver="pallas", method="blockwise"``: the blockwise statistics from
  kernel K3 (:func:`~pdx_torch.ops.kernels.fused_blockwise.fused_blockwise_gram`)
  or K4 (:func:`~pdx_torch.ops.kernels.fused_blockwise.fused_blockwise_gram_terms`).

Every other configuration goes through :func:`build_dataset` and
:func:`run_regression`; ``pdx`` runs that branch with no kernel of its own
(its matrix products, FFTs, QR and solves are library calls there and here).
Host RNG draws are numpy draws in ``pdx``'s order, so both fit the same rows.
The standard single fit there takes the Gram statistics sample-sharded over
``run``'s mesh when ``cfg.mesh`` says so (:func:`_maybe_sharded_gram`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from pdx_torch import resolve_device, resolve_dtype
from pdx_torch.library.dictionaries import (
    build_dictionary_rich,
    build_dictionary_true,
    display_names,
)
from pdx_torch.library.blockwise import build_blockwise_dataset
from pdx_torch.library.pointwise import build_pointwise_dataset, forward_difference_ut
from pdx_torch.library.weakform import build_weakform_dataset
from pdx_torch.ops.fd import gradients_periodic
from pdx_torch.ops.filters import smooth_1d, time_smooth_moving_average
from pdx_torch.ops.kernels.fused_blockwise import fused_blockwise_gram, fused_blockwise_gram_terms
from pdx_torch.ops.kernels.fused_gram import fused_ks_gram, fused_ks_gram_terms
from pdx_torch.ops.linalg import gram_stats, standardized_stats
from pdx_torch.ops.metrics import r2_score, rmse
from pdx_torch.ops.spectral import gaussian_smooth_periodic, gradients_spectral
from pdx_torch.register.phasecorr import estimate_interframe_shifts, stabilize_translation_sequence
from pdx_torch.shard.mesh import Mesh, default_mesh, shard_batch, sharded_gram_stats
from pdx_torch.sim.ks2d import Ks2dConfig, simulate_ks2d
from pdx_torch.sim.perturb import PerturbConfig, apply_perturbation_suite
from pdx_torch.solve.robust import (
    ensemble_stridge,
    robust_stridge,
    stridge_huber,
    stridge_sign_constrained,
    trimmed_stridge,
)
from pdx_torch.solve.stridge import stridge_from_stats, stridge_grid, stridge_qr, stridge_qr_grid
from pdx_torch.utils.profiling import null_stage, span
from pdx_torch.validate.rollout import rollout_rmse_curve_named

KS_GT = {"lap": -1.0, "bih": -1.0, "gradsq": -0.5}

GRID_ALPHAS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)
GRID_THRESHOLDS = (1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5)

TRUE_NAMES = ["lap", "bih", "gradsq"]
RICH_NAMES = ["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"]


@dataclass(frozen=True)
class Ks2dBenchConfig:
    """Same fields and defaults as ``pdx.pipelines.ks2d_bench.Ks2dBenchConfig``
    (which mirrors the reference CLI)."""

    # simulation
    Nx: int = 100
    Ny: int = 100
    n_seconds: float = 2.0
    dt: float = 1e-3
    save_every: int = 1
    # dataset method
    method: str = "pointwise"  # pointwise | blockwise | weakform
    dictionary: str = "true"  # true | rich
    derivatives: str = "finite"  # finite | spectral
    spectral_cutoff: float = 1.0
    include_advection: bool = False
    enforce_no_advection: bool = False
    n_sample: int = 50_000
    # perturbation
    perturbation: str = "none"
    noise_rel: float = 0.0
    noise_seed: int = 999
    shift_max: float = 1.5
    shift_mode: str = "constant"
    blur_sigma: float = 1.5
    drift: float = 0.02
    # stabilization / u_t correction
    stabilize_shifts: bool = False
    stabilize_mode: str = "to_first"
    stabilize_est_sigma: float = 0.0
    correct_shift_ut: bool = False
    ut_shift_smooth: int = 7
    ut_adv_deriv: str = "spectral"
    ut_adv_cutoff: float = 0.5
    # denoising
    denoise_time_window: int = 1
    denoise_space_sigma: float = 0.0
    denoise_space_on: str = "features"  # features | all
    # weak form
    weak_max_k: int = 3
    weak_basis: str = "gaussian"
    weak_n_phi: int = 64
    weak_sigma_px: float = 6.0
    weak_grad_cutoff: float | None = None
    weak_motion_correct: bool = False
    weak_motion_est_sigma: float = 0.0
    weak_motion_smooth: int = 7
    weak_motion_clip_px: float = -1.0
    weak_operator: str = "spectral"
    # blockwise
    block_t: int = 3
    block_x: int = 8
    block_y: int = 8
    # regression
    regression: str = "standard"  # standard | huber | trimmed | sign_constrained | ensemble
    robust: bool = False
    grid_search: bool = False
    alpha: float = 1e-6
    threshold: float = 1e-10
    huber_delta: float = 1.35
    trim_frac: float = 0.05
    n_bootstrap: int = 30
    sign_constraints: tuple[int, ...] = ()
    # rollout
    rollout_steps: int = 50
    # numerics
    dtype: str = "float64"
    # auto | gram | qr | pallas; 'pallas' = the fused streaming kernels over
    # the FULL field (K1) or every block (K3), selection by train R^2
    solver: str = "auto"
    mesh: str = "auto"  # auto | off | on: shard the single fit's Gram over run's mesh


def _effective_noise_rel(cfg: Ks2dBenchConfig) -> float:
    """N2/N5/N6/N7 default to 3% noise when unspecified."""
    noise_rel = float(cfg.noise_rel)
    if cfg.perturbation in {"N2_noise", "N5_shifts_noise", "N6_blur_noise", "N7_all"} and noise_rel == 0.0:
        return 0.03
    return noise_rel


def prepare_frames(cfg: Ks2dBenchConfig, device: str | torch.device | None = None, timer=None) -> dict[str, Any]:
    """simulate -> perturb -> stabilise -> denoise, on ``device`` (default:
    the CUDA card; raises without one). Returns the field dict of
    ``pdx.pipelines.ks2d_bench.prepare_frames``. Stage ``prepare_frames``
    of ``timer``, with the spans ``ks2d.sim`` (and the Euler-step count)
    and ``ks2d.perturb_denoise``."""
    sim = Ks2dConfig(
        Nx=cfg.Nx, Ny=cfg.Ny, dt=cfg.dt, n_seconds=cfg.n_seconds, save_every=cfg.save_every
    )
    st = timer.stage if timer is not None else null_stage
    with st("prepare_frames"):
        with span("ks2d.sim"):
            U_clean, dx, dy, DT = simulate_ks2d(
                sim, dtype=resolve_dtype(cfg.dtype), device=resolve_device(device)
            )
        with span("ks2d.perturb_denoise"):
            U, U_for_ut, U_for_features = _perturb_denoise(cfg, U_clean)
    return {
        "U_clean": U_clean, "U": U, "U_for_ut": U_for_ut, "U_for_features": U_for_features,
        "dx": dx, "dy": dy, "DT": DT, "sim": sim,
    }


def _perturb_denoise(cfg: Ks2dBenchConfig, U_clean: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """perturb -> stabilise -> denoise: (U, U_for_ut, U_for_features)."""
    perturb = PerturbConfig(
        perturbation=cfg.perturbation,
        noise_rel=_effective_noise_rel(cfg),
        noise_seed=cfg.noise_seed,
        shift_max_px=cfg.shift_max,
        shift_mode=cfg.shift_mode,
        blur_sigma=cfg.blur_sigma,
        drift_per_frame=cfg.drift,
    )
    U = apply_perturbation_suite(U_clean, perturb)

    if cfg.stabilize_shifts:
        U = stabilize_translation_sequence(
            U, mode=cfg.stabilize_mode, estimate_sigma_px=cfg.stabilize_est_sigma, border="wrap"
        )

    U_for_ut = U
    if cfg.denoise_time_window > 1:
        U_for_ut = time_smooth_moving_average(U_for_ut, cfg.denoise_time_window)
    U_for_features = U_for_ut
    if cfg.denoise_space_sigma > 0:
        if cfg.denoise_space_on == "all":
            U_for_ut = gaussian_smooth_periodic(U_for_ut, cfg.denoise_space_sigma)
            U_for_features = U_for_ut
        else:
            U_for_features = gaussian_smooth_periodic(U_for_features, cfg.denoise_space_sigma)
    return U, U_for_ut, U_for_features


def build_dataset(cfg: Ks2dBenchConfig, fr: dict[str, Any], rng: np.random.Generator):
    """Dataset branch dispatch. Returns (names, X, y) on the frames' device;
    the row subsample is drawn from ``rng`` on the host."""
    dx, dy, DT = fr["dx"], fr["dy"], fr["DT"]
    U_for_ut, U_for_features = fr["U_for_ut"], fr["U_for_features"]
    dev = U_for_ut.device

    if cfg.method == "weakform":
        clip_px = float(cfg.weak_motion_clip_px)
        if clip_px <= 0:
            clip_px = (
                float(cfg.shift_max)
                if cfg.perturbation in {"N1_shifts", "N5_shifts_noise", "N7_all"}
                else 0.0
            )
        names, X_all, y_all = build_weakform_dataset(
            U_for_ut,
            dx=dx,
            dy=dy,
            dt_frame=DT,
            lx=float(cfg.Nx * dx),
            ly=float(cfg.Ny * dy),
            max_k=cfg.weak_max_k,
            basis=cfg.weak_basis,
            n_phi=cfg.weak_n_phi,
            sigma_px=cfg.weak_sigma_px,
            grad_cutoff=cfg.weak_grad_cutoff,
            motion_correct=cfg.weak_motion_correct,
            motion_est_sigma_px=cfg.weak_motion_est_sigma,
            motion_smooth_window=cfg.weak_motion_smooth,
            motion_clip_px=clip_px if clip_px > 0 else None,
            dictionary=cfg.dictionary,
            operator=cfg.weak_operator,
        )
        n_total = int(y_all.shape[0])
        n_sample = int(min(cfg.n_sample, n_total))
        idx = torch.as_tensor(rng.choice(n_total, size=n_sample, replace=False), device=dev)
        return names, X_all[idx], y_all[idx]

    U_frames = U_for_features[:-1]
    Ut = forward_difference_ut(U_for_ut, DT)

    if cfg.correct_shift_ut:
        # add the advection that the frame-to-frame translation put into u_t
        sx_px, sy_px = estimate_interframe_shifts(U_for_ut, estimate_sigma_px=cfg.stabilize_est_sigma)
        sx_px = smooth_1d(sx_px, window=cfg.ut_shift_smooth)
        sy_px = smooth_1d(sy_px, window=cfg.ut_shift_smooth)
        U_adv = U_for_ut[:-1]
        if cfg.ut_adv_deriv == "spectral":
            ux_adv, uy_adv = gradients_spectral(U_adv, dx, dy, cutoff_frac=cfg.ut_adv_cutoff)
        else:
            ux_adv, uy_adv = gradients_periodic(U_adv, dx, dy)
        vx = (-sx_px * dx) / DT
        vy = (-sy_px * dy) / DT
        Ut = Ut + vx[:, None, None] * ux_adv + vy[:, None, None] * uy_adv

    if cfg.dictionary == "true":
        names, terms = build_dictionary_true(
            U_frames, dx, dy, deriv=cfg.derivatives, spectral_cutoff=cfg.spectral_cutoff,
            include_advection=cfg.include_advection and not cfg.enforce_no_advection,
        )
    else:
        names, terms = build_dictionary_rich(
            U_frames, dx, dy, deriv=cfg.derivatives, spectral_cutoff=cfg.spectral_cutoff,
            drop_advection=cfg.enforce_no_advection,
        )

    if cfg.method == "blockwise":
        X_all, y_all = build_blockwise_dataset(
            Ut, terms, block_t=cfg.block_t, block_x=cfg.block_x, block_y=cfg.block_y
        )
        return names, X_all, y_all

    n_total = int(np.prod(Ut.shape))
    n_sample = int(min(cfg.n_sample, n_total))
    flat_idx = rng.choice(n_total, size=n_sample, replace=False)
    X_all, y_all = build_pointwise_dataset(Ut, terms, flat_idx)
    return names, X_all, y_all


def _rms_scale(X_tr: Tensor, names) -> Tensor:
    """Per-column RMS scaling on the train split; the constant column unscaled."""
    scale = torch.sqrt(torch.mean(X_tr**2, dim=0)) + 1e-12
    const = torch.tensor([n == "one" for n in names], device=X_tr.device)
    return torch.where(const, torch.ones_like(scale), scale)


def _grid_tensors(dtype: torch.dtype, device: torch.device) -> tuple[Tensor, Tensor]:
    """The alpha and threshold grids as tensors."""
    return (
        torch.tensor(GRID_ALPHAS, dtype=dtype, device=device),
        torch.tensor(GRID_THRESHOLDS, dtype=dtype, device=device),
    )


def _fused_pointwise_grid(
    U_for_ut, U_for_features, flat_idx, tr_idx, te_idx, DT, dx, dy,
    alphas, thresholds, names, deriv, use_qr,
):
    """Pointwise grid core: forward-difference target -> dictionary -> row
    gather -> train/test split -> RMS scaling -> alpha x threshold STRidge
    grid -> test metrics."""
    with span("ks2d.stats"):
        Ut = forward_difference_ut(U_for_ut, DT)
        U_frames = U_for_features[:-1]
        if set(names) <= {"lap", "bih", "gradsq", "ux", "uy"}:
            _n, terms = build_dictionary_true(
                U_frames, dx, dy, deriv=deriv, include_advection="ux" in names
            )
        else:
            _n, terms = build_dictionary_rich(
                U_frames, dx, dy, deriv=deriv, drop_advection="ux" not in names
            )
        p = terms.shape[0]
        X_all = terms.reshape(p, -1)[:, flat_idx].T
        y_all = Ut.reshape(-1)[flat_idx]
        X_tr, y_tr = X_all[tr_idx], y_all[tr_idx]
        X_te, y_te = X_all[te_idx], y_all[te_idx]

        scale = _rms_scale(X_tr, names)
    return _grid_solve_and_score(X_tr / scale, y_tr, X_te, y_te, scale, alphas, thresholds, use_qr)


def _fused_fullfield_grid(U_for_ut, U_for_features, DT, dx, dy, alphas, thresholds):
    """Full-field grid: kernel K1 accumulates the true library's statistics
    over EVERY sample (no subsample, no materialised design matrix); the
    grid is scored by full-field train R^2 from the same statistics."""
    with span("ks2d.stats"):
        Ut = forward_difference_ut(U_for_ut, DT)
        stats = fused_ks_gram(U_for_features[:-1], Ut, dx=dx, dy=dy)
    return _grid_from_stats(stats, alphas, thresholds)


def _fused_blockwise_grid(U_for_ut, U_for_features, DT, dx, dy, alphas, thresholds, bt, bx, by):
    """Blockwise grid: kernel K3 accumulates the blockwise dataset's
    statistics over every block; scored by train R^2 over all blocks."""
    with span("ks2d.stats"):
        Ut = forward_difference_ut(U_for_ut, DT)
        stats = fused_blockwise_gram(
            U_for_features[:-1], Ut, dx=dx, dy=dy, block_t=bt, block_x=bx, block_y=by
        )
    return _grid_from_stats(stats, alphas, thresholds)


def _fused_fullfield_grid_terms(U_for_ut, U_for_features, DT, dx, dy, alphas, thresholds, names):
    """:func:`_fused_fullfield_grid` for any other stencil term list (the
    rich 9-term library and its advection subsets): kernel K2."""
    with span("ks2d.stats"):
        Ut = forward_difference_ut(U_for_ut, DT)
        stats = fused_ks_gram_terms(U_for_features[:-1], Ut, dx=dx, dy=dy, names=names)
    return _grid_from_stats(stats, alphas, thresholds)


def _fused_blockwise_grid_terms(U_for_ut, U_for_features, DT, dx, dy, alphas, thresholds, bt, bx, by, names):
    """:func:`_fused_blockwise_grid` for any other stencil term list: kernel K4."""
    with span("ks2d.stats"):
        Ut = forward_difference_ut(U_for_ut, DT)
        stats = fused_blockwise_gram_terms(
            U_for_features[:-1], Ut, dx=dx, dy=dy, names=names, block_t=bt, block_x=bx, block_y=by
        )
    return _grid_from_stats(stats, alphas, thresholds)


def _grid_from_stats(stats, alphas, thresholds):
    """RMS-scaled alpha x threshold STRidge grid + full-set metrics, all from
    (p, p) sufficient statistics (in their dtype: float64 from the kernels)."""
    with span("ks2d.grid"):
        s = torch.sqrt(torch.diagonal(stats["G"]) / stats["n"]) + 1e-12
        sstats = {
            "G": stats["G"] / (s[:, None] * s[None, :]),
            "b": stats["b"] / s,
            "sx": stats["sx"] / s,
            "n": stats["n"],
            "sy": stats["sy"],
            "syy": stats["syy"],
        }
        coeffs_s, _masks = stridge_grid(sstats, alphas, thresholds, max_iter=25)
        coeffs_grid = coeffs_s / s
        # full-set metrics from raw statistics: ||y - Xc||^2 = syy - 2c.b + c'Gc
        resid2 = (
            stats["syy"]
            - 2.0 * torch.einsum("atp,p->at", coeffs_grid, stats["b"])
            + torch.einsum("atp,pq,atq->at", coeffs_grid, stats["G"], coeffs_grid)
        )
        resid2 = torch.clamp(resid2, min=0.0)
        sst = stats["syy"] - stats["sy"] ** 2 / stats["n"]
        r2 = 1.0 - resid2 / (sst + 1e-18)
        err = torch.sqrt(resid2 / stats["n"])
        n_active = torch.sum(torch.abs(coeffs_grid) > 0, dim=-1)
        return coeffs_grid, r2, err, n_active


def _grid_solve_and_score(X_tr_s, y_tr, X_te, y_te, scale, alphas, thresholds, use_qr=False):
    """The STRidge grid on RMS-scaled train rows, on their Gram statistics
    or (``use_qr``) by QR of the rows themselves, scored on the test rows.
    Returns (coeffs[(A,T,p)], r2[(A,T)], rmse[(A,T)], n_active[(A,T)])."""
    with span("ks2d.grid"):
        if use_qr:
            coeffs_grid = stridge_qr_grid(X_tr_s, y_tr, alphas, thresholds, max_iter=25)
        else:
            coeffs_grid, _masks = stridge_grid(gram_stats(X_tr_s, y_tr), alphas, thresholds, max_iter=25)
        return _score_grid(coeffs_grid / scale, X_te, y_te)


def _score_grid(coeffs_grid, X_te, y_te):
    preds = torch.einsum("atp,np->atn", coeffs_grid, X_te)
    resid2 = torch.sum((preds - y_te[None, None, :]) ** 2, dim=-1)
    sst = torch.sum((y_te - torch.mean(y_te)) ** 2)
    r2 = 1.0 - resid2 / (sst + 1e-18)
    err = torch.sqrt(resid2 / y_te.shape[0])
    n_active = torch.sum(torch.abs(coeffs_grid) > 0, dim=-1)
    return coeffs_grid, r2, err, n_active


def _term_names(cfg: Ks2dBenchConfig) -> list[str]:
    if cfg.dictionary == "true":
        adv = cfg.include_advection and not cfg.enforce_no_advection
        return TRUE_NAMES + (["ux", "uy"] if adv else [])
    if cfg.enforce_no_advection:
        return [n for n in RICH_NAMES if n not in ("ux", "uy")]
    return list(RICH_NAMES)


def _use_qr(cfg: Ks2dBenchConfig, auto: Callable[[], bool]) -> bool:
    """QR inner solves: ``solver="qr"`` yes, ``"gram"`` no, else what
    ``auto()`` decides."""
    if cfg.solver == "qr":
        return True
    if cfg.solver == "gram":
        return False
    return auto()


def _select_best(grid) -> dict[str, Any]:
    """Host-side selection over an (A, T) grid of (coeffs, r2, rmse,
    n_active) tensors by (R^2, -n_active, -rmse), first best in grid order.
    One bundled device->host read."""
    with span("ks2d.select"):
        coeffs_np, r2_np, rmse_np, nact_np = (t.cpu().numpy() for t in grid)
        best = None
        for ai, a in enumerate(GRID_ALPHAS):
            for ti, t in enumerate(GRID_THRESHOLDS):
                key = (float(r2_np[ai, ti]), -int(nact_np[ai, ti]), -float(rmse_np[ai, ti]))
                if best is None or key > best["key"]:
                    best = {
                        "key": key, "alpha": a, "threshold": t, "coeffs": coeffs_np[ai, ti],
                        "r2_test": key[0], "rmse_test": -key[2], "n_active": -key[1],
                    }
        return best


def _grid_best(best: dict[str, Any]) -> dict[str, Any]:
    return {k: v for k, v in best.items() if k not in ("coeffs", "key")}


def _maybe_sharded_gram(cfg: Ks2dBenchConfig, X: Tensor, y: Tensor, mesh: Mesh) -> dict[str, Tensor]:
    """Gram sufficient statistics, sample-sharded over ``mesh`` when it has
    more than one device (cfg.mesh='auto') or when forced (cfg.mesh='on').

    Rows are zero-weight-padded to a device-count multiple, so the sharded
    statistics are the single-device ones up to the order of the sums."""
    n_dev = len(mesh)
    use_mesh = cfg.mesh == "on" or (cfg.mesh == "auto" and n_dev > 1)
    if not use_mesh or n_dev < 2:
        return gram_stats(X, y)
    n, n_pad = X.shape[0], (-X.shape[0]) % n_dev
    w = torch.cat([torch.ones(n, dtype=X.dtype, device=X.device), torch.zeros(n_pad, dtype=X.dtype, device=X.device)])
    Xp = torch.cat([X, X.new_zeros((n_pad, X.shape[1]))])
    yp = torch.cat([y, y.new_zeros(n_pad)])
    stats = sharded_gram_stats(shard_batch(Xp, mesh), shard_batch(yp, mesh), mesh, weights=shard_batch(w, mesh))
    return {k: v.to(X.device) for k, v in stats.items()}


def run_regression(cfg: Ks2dBenchConfig, names, X_tr, y_tr, X_te, y_te, mesh: Mesh | None = None):
    """Regression dispatch incl. grid search. Returns (coeffs, info): info is
    ``{"grid_best": ...}`` with grid search, else ``{"robust_info": ...}``.
    ``mesh`` (default: :func:`~pdx_torch.shard.mesh.default_mesh` of the
    rows' device) carries the standard single fit's sharded Gram."""
    mesh = default_mesh(X_tr.device) if mesh is None else mesh
    scale = _rms_scale(X_tr, names)
    X_tr_s = X_tr / scale

    signs = list(cfg.sign_constraints) if cfg.sign_constraints else None
    if signs is not None and len(signs) != X_tr.shape[1]:
        signs = None

    def probe() -> bool:
        # auto: in float32, QR only when the standardized Gram is conditioned
        # badly enough for the normal equations to lose accuracy
        # (cond(G) * eps_f32 would pass ~1e-3 of coefficient error)
        if resolve_dtype(cfg.dtype) == torch.float64:
            return False
        Gs_probe, _, _, _ = standardized_stats(gram_stats(X_tr_s, y_tr))
        return float(torch.linalg.cond(Gs_probe.to(torch.float32))) > 1e4

    use_qr = _use_qr(cfg, probe)
    robust_info = None

    def do_regression(alpha: float, threshold: float) -> Tensor:
        nonlocal robust_info
        kw = dict(alpha=alpha, threshold=threshold, max_iter=25)
        if cfg.robust:
            c_s, robust_info = robust_stridge(
                X_tr_s, y_tr, use_huber=True, huber_delta=cfg.huber_delta, trim_frac=cfg.trim_frac,
                n_bootstrap=cfg.n_bootstrap, signs=signs, **kw,
            )
            return c_s
        if cfg.regression == "huber":
            return stridge_huber(X_tr_s, y_tr, huber_delta=cfg.huber_delta, **kw)
        if cfg.regression == "trimmed":
            return trimmed_stridge(X_tr_s, y_tr, trim_frac=cfg.trim_frac, **kw)
        if cfg.regression == "sign_constrained":
            return stridge_sign_constrained(X_tr_s, y_tr, signs=signs, **kw)
        if cfg.regression == "ensemble":
            mean_c, std_c = ensemble_stridge(
                X_tr_s, y_tr, n_bootstrap=cfg.n_bootstrap, use_huber=True, huber_delta=cfg.huber_delta, **kw
            )
            robust_info = {"std": std_c}
            return mean_c
        if use_qr:
            return stridge_qr(X_tr_s, y_tr, **kw)
        # standard STRidge on sufficient statistics, the sample axis sharded
        # over the mesh when cfg.mesh says so
        return stridge_from_stats(_maybe_sharded_gram(cfg, X_tr_s, y_tr, mesh), **kw).coeffs

    if cfg.grid_search and cfg.regression == "standard" and not cfg.robust:
        # batched grid: all 30 hyperparameter points in one batch, metrics on
        # the device, one host read for the selection
        best = _select_best(
            _grid_solve_and_score(X_tr_s, y_tr, X_te, y_te, scale, *_grid_tensors(X_tr.dtype, X_tr.device), use_qr)
        )
        return torch.as_tensor(best["coeffs"], device=X_tr.device), {"grid_best": _grid_best(best)}

    if cfg.grid_search:
        best = None
        for a in GRID_ALPHAS:
            for t in GRID_THRESHOLDS:
                c = do_regression(a, t) / scale
                y_pred = X_te @ c
                r2 = float(r2_score(y_te, y_pred))
                err = float(rmse(y_te, y_pred))
                n_active = int(torch.sum(torch.abs(c) > 0))
                key = (r2, -n_active, -err)
                if best is None or key > best["key"]:
                    best = {
                        "key": key, "alpha": a, "threshold": t, "coeffs": c,
                        "r2_test": r2, "rmse_test": err, "n_active": n_active,
                    }
        # pdx leaves its sort key in this branch's grid_best; so does the port
        return best["coeffs"], {"grid_best": {k: v for k, v in best.items() if k != "coeffs"}}

    c = do_regression(float(cfg.alpha), float(cfg.threshold)) / scale
    return c, {"robust_info": robust_info}


def _result(cfg: Ks2dBenchConfig, fr: dict[str, Any], names, coeffs: np.ndarray, fit, info) -> dict[str, Any]:
    """Ground-truth errors, the rollout from the first frame and the result
    dict, for host-side coefficients."""
    gt_errors = {}
    for key, v in KS_GT.items():
        if key in names:
            est = float(coeffs[names.index(key)])
            gt_errors[key] = {
                "gt": v, "est": est, "rel_err_pct": abs(est - v) / (abs(v) + 1e-12) * 100.0,
            }
    U = fr["U"]
    n_roll = int(min(cfg.rollout_steps, U.shape[0] - 1))
    with span("ks2d.rollout"):
        # the whole curve in one device->host read
        errs = rollout_rmse_curve_named(
            U, coeffs, names, n_roll, fr["DT"], fr["dx"], fr["dy"]
        ).cpu().numpy()
    return {
        "config": dataclasses.asdict(cfg),
        "names": names,
        "display_names": display_names(names),
        "coeffs": [float(c) for c in coeffs],
        "gt_errors": gt_errors,
        "fit": fit,
        "rollout": {
            "first": float(errs[0]), "last": float(errs[-1]),
            "mean": float(errs.mean()), "n_steps": n_roll,
        },
        **info,
    }


def _run_fast_pointwise_grid(
    cfg: Ks2dBenchConfig, fr: dict[str, Any], rng: np.random.Generator, timer=None
) -> dict[str, Any]:
    """Grid-search benchmark on prepared frames ``fr`` (see ``prepare_frames``
    or :func:`pdx_torch.interop.frames_from_numpy`). Stage ``fit`` of
    ``timer``, with the spans ``ks2d.stats`` (u_t and the statistics, or the
    sampled dataset), ``ks2d.grid`` (the STRidge grid), ``ks2d.select`` (its
    host read) and ``ks2d.rollout``."""
    st = timer.stage if timer is not None else null_stage
    with st("fit"):
        names = _term_names(cfg)
        U_ut, U_feat = fr["U_for_ut"], fr["U_for_features"]
        dev = U_ut.device

        if cfg.solver == "pallas":
            if cfg.derivatives != "finite":
                raise ValueError(
                    "solver='pallas' streams finite-difference stencil terms; "
                    "set derivatives='finite'"
                )
            # kernel statistics are float64, so the grid runs in float64
            alphas, thresholds = _grid_tensors(torch.float64, dev)
            DT, dx, dy = float(fr["DT"]), float(fr["dx"]), float(fr["dy"])
            args = (U_ut, U_feat, DT, dx, dy, alphas, thresholds)
            blocks = (int(cfg.block_t), int(cfg.block_x), int(cfg.block_y))
            # [lap, bih, gradsq] keeps its own kernels (K1/K3), as in pdx
            if cfg.method == "blockwise":
                if names == TRUE_NAMES:
                    grid = _fused_blockwise_grid(*args, *blocks)
                else:
                    grid = _fused_blockwise_grid_terms(*args, *blocks, tuple(names))
            elif names == TRUE_NAMES:
                grid = _fused_fullfield_grid(*args)
            else:
                grid = _fused_fullfield_grid_terms(*args, tuple(names))
        else:
            Ut_size = (U_ut.shape[0] - 1) * cfg.Nx * cfg.Ny
            n_sample = int(min(cfg.n_sample, Ut_size))
            flat_idx = rng.choice(Ut_size, size=n_sample, replace=False)
            perm = rng.permutation(n_sample)  # all-finite by construction (nan guards)
            split = int(0.7 * n_sample)
            dtype = resolve_dtype(cfg.dtype)
            # 'auto' without a condition probe: the true dictionary is
            # well-conditioned (Gram path); rich dictionaries take QR in float32
            use_qr = _use_qr(cfg, lambda: cfg.dictionary != "true" and dtype != torch.float64)

            def idx(a):
                return torch.as_tensor(a, device=dev)

            grid = _fused_pointwise_grid(
                U_ut, U_feat, idx(flat_idx), idx(perm[:split]), idx(perm[split:]),
                fr["DT"], fr["dx"], fr["dy"],
                *_grid_tensors(dtype, dev),
                tuple(names), cfg.derivatives, use_qr,
            )
        best = _select_best(grid)
        fit = {
            "test_r2": best["r2_test"], "test_rmse": best["rmse_test"], "n_active": int(best["n_active"]),
        }
        return _result(cfg, fr, names, best["coeffs"], fit, {"grid_best": _grid_best(best)})


VALID_METHODS = {"pointwise", "blockwise", "weakform"}
VALID_REGRESSIONS = {"standard", "huber", "trimmed", "sign_constrained", "ensemble"}


def run(
    cfg: Ks2dBenchConfig, device: str | torch.device | None = None, mesh: Mesh | None = None, timer=None
) -> dict[str, Any]:
    """Run the benchmark on ``device`` (default: the CUDA card; without one
    this raises unless ``device="cpu"`` is given). ``mesh`` carries the
    sample-sharded Gram of the standard single fit; by default it is every
    visible card on a CUDA device and the one device on the CPU, where
    ``pdx`` takes every JAX device (its tests' 8 virtual CPU devices too).
    ``timer`` (a :class:`pdx_torch.utils.profiling.StageTimer`) times the
    stages ``prepare_frames`` and ``fit``; under a ``torch.profiler``
    session they are spans without it."""
    if cfg.method not in VALID_METHODS:
        raise ValueError(f"method must be one of {sorted(VALID_METHODS)}, got '{cfg.method}'")
    if cfg.regression not in VALID_REGRESSIONS:
        raise ValueError(
            f"regression must be one of {sorted(VALID_REGRESSIONS)}, got '{cfg.regression}'"
        )
    # fast path: the grid-search benchmark on sufficient statistics
    fast = (
        (
            cfg.method == "pointwise"
            or (cfg.method == "blockwise" and cfg.solver == "pallas")
        )
        and cfg.regression == "standard"
        and not cfg.robust
        and cfg.grid_search
        and not cfg.correct_shift_ut
    )
    if cfg.solver == "pallas" and not fast:
        raise ValueError(
            "solver='pallas' is the fused streaming grid path: requires "
            "method='pointwise' or 'blockwise', regression='standard', "
            "grid_search=True, robust=False, correct_shift_ut=False"
        )
    fr = prepare_frames(cfg, device, timer)
    rng = np.random.default_rng(0)  # reference: main:1470
    if fast:
        return _run_fast_pointwise_grid(cfg, fr, rng, timer)

    st = timer.stage if timer is not None else null_stage
    with st("fit"):
        names, X_all, y_all = build_dataset(cfg, fr, rng)

        # finite filter (the reference's boolean filtering), then the split: the
        # permutation is drawn after build_dataset's choice, over the valid rows
        valid = torch.isfinite(X_all).all(dim=1) & torch.isfinite(y_all)
        if not bool(valid.all()):
            X_all, y_all = X_all[valid], y_all[valid]
        n_rows = int(X_all.shape[0])
        perm = rng.permutation(n_rows)
        split = int(0.7 * n_rows)
        tr = torch.as_tensor(perm[:split], device=X_all.device)
        te = torch.as_tensor(perm[split:], device=X_all.device)
        X_tr, y_tr = X_all[tr], y_all[tr]
        X_te, y_te = X_all[te], y_all[te]

        coeffs, reg_info = run_regression(cfg, names, X_tr, y_tr, X_te, y_te, mesh)
        coeffs_np = coeffs.cpu().numpy()  # single transfer; host scalar reads below

        y_pred_tr = X_tr @ coeffs
        y_pred_te = X_te @ coeffs
        fit = {
            "train_r2": float(r2_score(y_tr, y_pred_tr)),
            "train_rmse": float(rmse(y_tr, y_pred_tr)),
            "test_r2": float(r2_score(y_te, y_pred_te)),
            "test_rmse": float(rmse(y_te, y_pred_te)),
            "n_active": int((np.abs(coeffs_np) > 0).sum()),
        }
        return _result(cfg, fr, names, coeffs_np, fit, reg_info)
