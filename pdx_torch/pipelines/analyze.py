"""Real-image analysis pipeline, the source of truth for model selection
(port of ``pdx/pipelines/analyze.py``; scripts/analyze_results.py).

load TIFFs -> 2x INTER_AREA downsample -> Gaussian denoise -> min-max
normalise -> [phase-correlation stabilisation] -> Farnebäck registration ->
Gaussian smooth -> crop and subsample -> sliced central differences ->
Models 1-6 (and optionally Model 7, the 25-term 4th-order library) by
STRidge -> metrics, one-step checks, k-step rollouts, spatial holdouts ->
weighted-rank selection -> best_model.json, models_comparison.json,
best_model_baseline.json and two figures.

The reference's quirks are kept: Models 1 and 2 are the same term set, and
the sliced derivative fields are truncated to a common shape from the
START, so u_x, u_y and u_t sit one grid point off u.

Structure: the six models are column subsets of one 13-term superset, so
the standard path is one shared Gram, STRidge over a (6, 13) batch of
masks, batched metrics and one-step checks, and one rollout trajectory per
split for every model and horizon (``validate/rollout.py``). The robust
path and Model 7 fit model by model, as ``pdx`` does.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import Tensor

from pdx_torch import resolve_device, resolve_dtype
from pdx_torch.io_host.artifacts import write_best_model, write_json, write_models_comparison
from pdx_torch.io_host.images import device_stack, load_images
from pdx_torch.library.dictionaries import FOURTH_ORDER_TERMS, fourth_order_term_fields
from pdx_torch.ops.filters import gaussian_filter_reflect
from pdx_torch.ops.linalg import gram_stats
from pdx_torch.ops.metrics import masked_regression_metrics, regression_metrics
from pdx_torch.preprocess import resize_denoise_normalize
from pdx_torch.register.farneback import register_sequence_dispatch
from pdx_torch.register.phasecorr import stabilize_translation_sequence
from pdx_torch.report.figures import NothingToDraw, draw_fig4_snapshots, fig4_snapshot_data, model_comparison_figure
from pdx_torch.solve.robust import median, robust_stridge
from pdx_torch.solve.stridge import stridge_from_stats
from pdx_torch.utils.profiling import null_stage
from pdx_torch.validate.holdout import split_time
from pdx_torch.validate.rollout import ANALYZE13, dense_coeffs, one_step_prediction_rmse, rollout_curve_bundle
from pdx_torch.validate.selection import select_best

# display names matching the reference's real-image term strings
ANALYZE_DISPLAY = {
    "one": "1",
    "u": "u",
    "ux": "u_x",
    "uy": "u_y",
    "uxx": "u_xx",
    "uyy": "u_yy",
    "lap": "lap(u)",
    "u2": "u^2",
    "u3": "u^3",
    "u_ux": "u*u_x",
    "u_uy": "u*u_y",
    "ux2": "u_x^2",
    "uy2": "u_y^2",
    # 4th-order extended terms (Model 7, notebook 02)
    "u_uxx": "u*u_xx",
    "u_uyy": "u*u_yy",
    "u_lap": "u*lap(u)",
    "u2_ux": "u^2*u_x",
    "u2_uy": "u^2*u_y",
    "uxxx": "u_xxx",
    "uyyy": "u_yyy",
    "uxxxx": "u_xxxx",
    "uyyyy": "u_yyyy",
    "bih": "biharm(u)",
    "u_uxxxx": "u*u_xxxx",
    "u_uyyyy": "u*u_yyyy",
}

MODELS: dict[str, list[str]] = {
    "Model 1: Diffusion only": ["one", "u", "lap"],
    "Model 2: Diffusion + Linear Growth": ["one", "u", "lap"],
    "Model 3: + First order spatial": ["one", "u", "ux", "uy", "lap"],
    "Model 4: + Nonlinear (u^2)": ["one", "u", "ux", "uy", "lap", "u2"],
    "Model 5: + Advection (u*grad(u))": ["one", "u", "ux", "uy", "lap", "u2", "u_ux", "u_uy"],
    "Model 6: Full (original)": [
        "one", "u", "ux", "uy", "uxx", "uyy", "lap", "u2", "u_ux", "u_uy", "u3", "ux2", "uy2",
    ],
}
MODEL7 = "Model 7: 4th-order extended (25 terms)"


@dataclass(frozen=True)
class AnalyzeConfig:
    data_dir: str = "data/Real-Images"
    output_dir: str = "outputs/latest/slides"
    max_images: int = 51
    train_frac: float = 0.7
    space_train_frac: float = 0.7
    rollout_steps: tuple[int, ...] = tuple(range(1, 11))
    stabilize_translation: bool = False
    stabilize_mode: str = "to_prev"
    stabilize_est_sigma: float = 2.0
    robust_regression: bool = False
    alpha: float = 0.01
    threshold: float = 1e-5
    # preprocessing constants (analyze_results.py:213-255)
    downsample: int = 2
    denoise_sigma1: float = 1.0
    denoise_sigma2: float = 1.5
    skip: int = 25
    subsample: int = 12
    dx: float = 0.1
    dy: float = 0.1
    dt: float = 1.0
    # reference-compat toggles
    reference_compat_warp: bool = False  # reproduce the x - flow warp bug (forces the chain)
    registration: bool = True
    register_mode: str = "auto"  # auto (= chain) | compose | chain | to_first
    register_refine: int = 1  # re-warp refinement passes per flow
    # extension: add the 25-term 4th-order library (notebook 02) as Model 7
    include_fourth_order: bool = False
    dtype: str = "float64"
    write_artifacts: bool = True


def preprocess(cfg: AnalyzeConfig, U_raw: np.ndarray, timer=None, device: str | torch.device | None = None) -> Tensor:
    """Downsample -> denoise -> normalise -> [stabilise] -> register ->
    smooth -> crop and subsample (analyze_results.py:213-251)."""
    dev = resolve_device(device)
    st = timer.stage if timer is not None else null_stage
    with st("denoise_normalize"):
        T, H, W = U_raw.shape
        U = resize_denoise_normalize(
            device_stack(U_raw, device=dev), out_h=H // cfg.downsample, out_w=W // cfg.downsample,
            sigma=cfg.denoise_sigma1, dtype_name=cfg.dtype,
        )
    if cfg.stabilize_translation:
        with st("stabilize"):
            U = stabilize_translation_sequence(
                U, mode=cfg.stabilize_mode, estimate_sigma_px=cfg.stabilize_est_sigma,
                border="reflect", smooth="reflect",
            )
    if cfg.registration:
        with st("registration"):
            U = register_sequence_dispatch(
                U, mode=cfg.register_mode, refine=cfg.register_refine,
                reference_compat_warp=cfg.reference_compat_warp,
            )
    with st("smooth_crop"):
        U = gaussian_filter_reflect(U, cfg.denoise_sigma2)
        s, sub = cfg.skip, cfg.subsample
        U = U[:, s:-s:sub, s:-s:sub].contiguous()
    return U


def sliced_fields(cfg: AnalyzeConfig, U: Tensor) -> tuple[dict[str, Tensor], Tensor, tuple[int, int, int]]:
    """The reference's sliced central differences, truncated to a common
    shape from the start (analyze_results.py:257-274): the documented
    off-by-one quirk. u_x differentiates along the last axis (columns),
    u_y along the rows."""
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    u_x = (U[:, :, 2:] - U[:, :, :-2]) / (2 * dx)
    u_y = (U[:, 2:, :] - U[:, :-2, :]) / (2 * dy)
    u_xx = (U[:, :, 2:] - 2 * U[:, :, 1:-1] + U[:, :, :-2]) / (dx**2)
    u_yy = (U[:, 2:, :] - 2 * U[:, 1:-1, :] + U[:, :-2, :]) / (dy**2)
    u_t = (U[2:, :, :] - U[:-2, :, :]) / (2 * dt)
    parts = (u_x, u_y, u_xx, u_yy, u_t)
    mt, mh, mw = (min(f.shape[i] for f in parts) for i in range(3))

    u, u_x, u_y, u_xx, u_yy, u_t = (f[:mt, :mh, :mw] for f in (U,) + parts)
    lap = u_xx + u_yy
    fields = {
        "one": torch.ones_like(u),
        "u": u,
        "ux": u_x,
        "uy": u_y,
        "uxx": u_xx,
        "uyy": u_yy,
        "lap": lap,
        "u2": u**2,
        "u3": u**3,
        "u_ux": u * u_x,
        "u_uy": u * u_y,
        "ux2": u_x**2,
        "uy2": u_y**2,
    }
    return fields, u_t, (mt, mh, mw)


def _fit(cfg: AnalyzeConfig, X: Tensor, y: Tensor) -> Tensor:
    """Standard (sklearn-Ridge-equivalent) or robust STRidge
    (analyze_results.py:547-587): alpha 0.01, threshold 1e-5, max_iter 20."""
    if cfg.robust_regression:
        coeffs, _info = robust_stridge(
            X, y, alpha=cfg.alpha, threshold=cfg.threshold, max_iter=20,
            use_huber=True, huber_delta=1.35, trim_frac=0.05, n_bootstrap=30,
        )
        return coeffs
    return stridge_from_stats(gram_stats(X, y), alpha=cfg.alpha, threshold=cfg.threshold, max_iter=20).coeffs


def _equation(coeffs, names, tol=1e-5) -> str:
    parts = []
    for c, n in zip(np.asarray(coeffs), names):
        if abs(c) > tol:
            sign = "+" if c > 0 and parts else ""
            parts.append(f"{sign}{c:.4f}*{ANALYZE_DISPLAY.get(n, n)}")
    return "u_t = " + " ".join(parts) if parts else "u_t = 0"


def _batched_metrics(y: Tensor, P: Tensor) -> dict[str, Tensor]:
    """Regression metrics of every model at once: y (n,), predictions P
    (M, n) -> dict of (M,). The median averages the middle pair, as
    ``jnp.median`` does."""
    m = regression_metrics(y, P)
    m["resid_med_abs"] = median(torch.abs(y - P), dim=-1)
    return m


def _fit_models_batched(X_tr, y_tr, X_te, y_te, u, masks, alpha, threshold, dt, max_iter, n_tr_t):
    """One shared Gram, STRidge over the (M, 13) mask batch, batched metrics
    and one-step checks of the whole model family."""
    coeffs = stridge_from_stats(
        gram_stats(X_tr, y_tr), alpha=alpha, threshold=threshold, max_iter=max_iter, init_mask=masks
    ).coeffs  # (M, 13)
    preds_tr = coeffs @ X_tr.T  # (M, n_tr)
    preds_te = coeffs @ X_te.T
    m_tr = _batched_metrics(y_tr, preds_tr)
    m_te = _batched_metrics(y_te, preds_te)

    # one-step per segment (analyze_results.py:641-646): predictions as
    # frames, against u(t+1) inside each time segment
    M = masks.shape[0]
    mt, mh, mw = u.shape
    ut_pred = torch.cat([preds_tr.reshape(M, n_tr_t, mh, mw), preds_te.reshape(M, mt - n_tr_t, mh, mw)], dim=1)

    def one_step_seg(seg_u, seg_pred):
        err = (seg_u[1:] - (seg_u[:-1] + dt * seg_pred[:, :-1])) ** 2
        return torch.sqrt(torch.mean(err, dim=(1, 2, 3)))

    os_tr = one_step_seg(u[:n_tr_t], ut_pred[:, :n_tr_t])
    os_te = one_step_seg(u[n_tr_t:], ut_pred[:, n_tr_t:])
    return coeffs, m_tr, m_te, os_tr, os_te


METRIC_KEYS = ("rmse", "mae", "r2", "nrmse", "corr", "resid_med_abs")


def _rollout_dict(k_list, rm: np.ndarray, nrm: np.ndarray, tag: str, col: int = 0) -> dict:
    """{f"k{k}_{tag}": {"rmse", "nrmse"}} from (k_max, columns) bundle rows."""
    return {f"k{k}_{tag}": {"rmse": float(rm[k - 1, col]), "nrmse": float(nrm[k - 1, col])} for k in k_list}


def _split_bundles(cfg, u: Tensor, coeffs_dense: Tensor, train_sl: slice, test_sl: slice, k_list, term_set):
    """Each split's rollout curves of every model: {tag: (rmse, nrmse)} as
    host arrays (M, k_max, 1), NaN where a split has fewer than two frames."""
    M = coeffs_dense.shape[0]
    k_max = max(k_list) if k_list else 0
    no_masks = u.new_zeros((0,) + u.shape[-2:])
    bundles = {}
    for tag, sl in (("train", train_sl), ("test", test_sl)):
        t0, t1 = sl.start or 0, sl.stop
        if k_max > 0 and (t1 - t0) > 1:
            rm, nrm = rollout_curve_bundle(
                u, coeffs_dense, cfg.dt, cfg.dx, cfg.dy, no_masks, k_max=k_max, t0=t0, t1=t1, term_set=term_set
            )
            both = torch.stack([rm, nrm]).cpu().numpy()
            bundles[tag] = (both[0], both[1])
        else:
            nanv = np.full((M, max(k_max, 1), 1), np.nan)
            bundles[tag] = (nanv, nanv)
    return bundles


def _result(name, names, coeffs: np.ndarray, m_te: dict, m_tr: dict, os_te, os_tr, rollout) -> dict:
    return {
        "name": name,
        "r2": m_te["r2"],
        "rmse": m_te["rmse"],
        "mae": m_te["mae"],
        "nrmse": m_te["nrmse"],
        "corr": m_te["corr"],
        "resid_med_abs": m_te["resid_med_abs"],
        "one_step_rmse": os_te,
        "train_r2": m_tr["r2"],
        "train_rmse": m_tr["rmse"],
        "train_nrmse": m_tr["nrmse"],
        "train_corr": m_tr["corr"],
        "train_one_step_rmse": os_tr,
        "rollout": rollout,
        "n_active": int(np.sum(np.abs(coeffs) > 1e-5)),
        "n_total": len(names),
        "equation": _equation(coeffs, names),
        "coeffs": coeffs,
        "names": names,
    }


def _run_models_batched(cfg, fields, u_t, u, train_sl, test_sl, k_list) -> list[dict]:
    superset = list(ANALYZE13)
    terms13 = torch.stack([fields[n] for n in superset], dim=0)
    model_names = list(MODELS)
    masks = torch.tensor(
        [[1.0 if n in MODELS[mn] else 0.0 for n in superset] for mn in model_names], dtype=u_t.dtype, device=u.device
    )
    M, n_tr_t = len(model_names), train_sl.stop

    X_tr = terms13[:, train_sl].reshape(13, -1).T
    y_tr = u_t[train_sl].reshape(-1)
    X_te = terms13[:, test_sl].reshape(13, -1).T
    y_te = u_t[test_sl].reshape(-1)

    coeffs_b, m_tr, m_te, os_tr, os_te = _fit_models_batched(
        X_tr, y_tr, X_te, y_te, u, masks, cfg.alpha, cfg.threshold, cfg.dt, 20, n_tr_t
    )
    # one read of the whole fit result
    host = torch.cat(
        [coeffs_b, torch.stack([m_tr[k] for k in METRIC_KEYS] + [m_te[k] for k in METRIC_KEYS] + [os_tr, os_te], 1)],
        dim=1,
    ).cpu().numpy()
    coeffs_np = host[:, :13]
    m_tr_np = dict(zip(METRIC_KEYS, host[:, 13:19].T))
    m_te_np = dict(zip(METRIC_KEYS, host[:, 19:25].T))
    os_tr_np, os_te_np = host[:, 25], host[:, 26]

    # every model and horizon of a split from one trajectory
    bundles = _split_bundles(cfg, u, coeffs_b, train_sl, test_sl, k_list, "real13")

    results = []
    for mi, model_name in enumerate(model_names):
        names = MODELS[model_name]
        coeffs = np.asarray([coeffs_np[mi, superset.index(n)] for n in names])
        rollout = {}
        for k in k_list:
            for tag in ("train", "test"):
                rm, nrm = bundles[tag]
                rollout[f"k{k}_{tag}"] = {"rmse": float(rm[mi, k - 1, 0]), "nrmse": float(nrm[mi, k - 1, 0])}
        results.append(_result(
            model_name, names, coeffs,
            {k: float(v[mi]) for k, v in m_te_np.items()}, {k: float(v[mi]) for k, v in m_tr_np.items()},
            float(os_te_np[mi]), float(os_tr_np[mi]), rollout,
        ))
    return results


def _run_model(cfg, model_name, names, fields_m, u_t, u, train_sl, test_sl, k_list) -> dict:
    """One model fit on its own (the robust path, Model 7), with its
    metrics, one-step checks and rollout curves."""
    terms = torch.stack([fields_m[n] for n in names], dim=0)  # (p, T, H, W)
    p = len(names)
    X_train = terms[:, train_sl].reshape(p, -1).T
    y_train = u_t[train_sl].reshape(-1)
    X_test = terms[:, test_sl].reshape(p, -1).T
    y_test = u_t[test_sl].reshape(-1)

    coeffs = _fit(cfg, X_train, y_train)
    y_pred_train = X_train @ coeffs
    y_pred_test = X_test @ coeffs
    m_train = _batched_metrics(y_train, y_pred_train)
    m_test = _batched_metrics(y_test, y_pred_test)
    ut_pred_full = torch.cat(
        [y_pred_train.reshape(u_t[train_sl].shape), y_pred_test.reshape(u_t[test_sl].shape)], dim=0
    )
    os_tr = one_step_prediction_rmse(u[train_sl], ut_pred_full[train_sl], cfg.dt)
    os_te = one_step_prediction_rmse(u[test_sl], ut_pred_full[test_sl], cfg.dt)
    host = torch.cat(
        [coeffs, torch.stack([m_train[k] for k in METRIC_KEYS] + [m_test[k] for k in METRIC_KEYS] + [os_tr, os_te])]
    ).cpu().numpy()
    coeffs_np, rest = host[:p], [float(v) for v in host[p:]]
    m_tr, m_te = dict(zip(METRIC_KEYS, rest[:6])), dict(zip(METRIC_KEYS, rest[6:12]))

    term_set, superset = ("real13", ANALYZE13) if set(names) <= set(ANALYZE13) else ("fourth25", FOURTH_ORDER_TERMS)
    dense = torch.as_tensor(dense_coeffs(names, coeffs_np, superset)[None], dtype=u.dtype, device=u.device)
    bundles = _split_bundles(cfg, u, dense, train_sl, test_sl, k_list, term_set)
    rollout = {}
    for tag in ("train", "test"):
        rollout.update(_rollout_dict(k_list, bundles[tag][0][0], bundles[tag][1][0], tag))
    return _result(model_name, names, coeffs_np, m_te, m_tr, rest[13], rest[12], rollout)


def run(
    cfg: AnalyzeConfig, U_raw: np.ndarray | None = None, timer=None, device: str | torch.device | None = None
) -> dict[str, Any]:
    """The analysis on ``U_raw`` (a (T, H, W) frame stack), or on the first
    ``cfg.max_images`` TIFFs of ``cfg.data_dir`` read as 8-bit grayscale.
    Runs on the CUDA card unless ``device="cpu"``; raises without a card
    otherwise. ``timer`` (a :class:`pdx_torch.utils.profiling.StageTimer`)
    times the stages."""
    dev = resolve_device(device)
    resolve_dtype(cfg.dtype)  # refuse an unknown dtype before any work
    st = timer.stage if timer is not None else null_stage

    if U_raw is None:
        with st("load_images"):
            U_raw = load_images(cfg.data_dir, max_images=cfg.max_images, mode="grayscale_u8", dtype=np.uint8)

    U_crop = preprocess(cfg, U_raw, timer=timer, device=dev)
    with st("sliced_fields"):
        fields, u_t, (mt, mh, mw) = sliced_fields(cfg, U_crop)
        u = fields["u"]

    train_sl, test_sl = _split_slices(mt, cfg.train_frac)
    k_list = [int(k) for k in cfg.rollout_steps]

    results: list[dict] = []
    if cfg.robust_regression:
        model_specs = [(name, names, fields) for name, names in MODELS.items()]
    else:
        model_specs = []
        with st("models_batched"):
            results = _run_models_batched(cfg, fields, u_t, u, train_sl, test_sl, k_list)
    if cfg.include_fourth_order:
        model_specs.append((MODEL7, FOURTH_ORDER_TERMS, fourth_order_term_fields(u, cfg.dx, cfg.dy)))
    if model_specs:
        with st("models_loop"):
            for model_name, names, fields_m in model_specs:
                results.append(_run_model(cfg, model_name, names, fields_m, u_t, u, train_sl, test_sl, k_list))

    k_eval = k_list[-1] if k_list else 0
    best_simple = select_best(results, max_active=5, k_eval=k_eval)
    best_overall = select_best(results, max_active=None, k_eval=k_eval)

    with st("spatial_holdout"):
        spatial_eval = _spatial_holdout(cfg, fields, u_t, u, best_overall["name"], mh, mw, axis="lr")
        spatial_eval_tb = _spatial_holdout(cfg, fields, u_t, u, best_overall["name"], mh, mw, axis="tb")

    b_names, b_coeffs = best_overall["names"], best_overall["coeffs"]
    # the best model's test-split curve was computed above
    rollout_time = {k: dict(best_overall["rollout"][f"k{k}_test"]) for k in k_list}
    with st("best_rollout_bundle"):
        if k_list and mt > 1:
            term_set, superset = (
                ("real13", ANALYZE13) if set(b_names) <= set(ANALYZE13) else ("fourth25", FOURTH_ORDER_TERMS)
            )
            dense = torch.as_tensor(dense_coeffs(b_names, b_coeffs, superset)[None], dtype=u.dtype, device=dev)
            masks2 = torch.stack([
                _space_mask(mh, mw, cfg.space_train_frac, axis, dev)[1].to(u.dtype) for axis in ("lr", "tb")
            ])
            rm_b, nrm_b = rollout_curve_bundle(
                u, dense, cfg.dt, cfg.dx, cfg.dy, masks2, k_max=max(k_list), t0=0, t1=mt, term_set=term_set
            )
            both = torch.stack([rm_b[0], nrm_b[0]]).cpu().numpy()
            rollout_lr = {k: {"rmse": float(both[0, k - 1, 1]), "nrmse": float(both[1, k - 1, 1])} for k in k_list}
            rollout_tb = {k: {"rmse": float(both[0, k - 1, 2]), "nrmse": float(both[1, k - 1, 2])} for k in k_list}
        else:
            rollout_lr = {k: {"rmse": float("nan"), "nrmse": float("nan")} for k in k_list}
            rollout_tb = {k: {"rmse": float("nan"), "nrmse": float("nan")} for k in k_list}

    out: dict[str, Any] = {
        "config": dataclasses.asdict(cfg),
        "results": results,
        "best_simple": best_simple,
        "best_overall": best_overall,
        "spatial_holdout": spatial_eval,
        "spatial_holdout_top_bottom": spatial_eval_tb,
        "rollout_time_test": rollout_time,
        "rollout_space_lr": rollout_lr,
        "rollout_space_tb": rollout_tb,
        "working_shape": (mt, mh, mw),
    }

    if cfg.write_artifacts:
        out_dir = Path(cfg.output_dir)
        with st("artifacts_json"):
            _write_artifacts(cfg, out_dir, out, k_list)
        # MODEL_COMPARISON.png, as the reference's analyze_results.py draws
        # it itself (:716-735); an optional artifact, skipped as in pdx when
        # matplotlib cannot draw it
        with st("fig_model_comparison"):
            try:
                model_comparison_figure(out_dir)
            except Exception as e:  # pragma: no cover - host-figure guard
                print(f"   (skipped model comparison figure: {e})")
        with st("fig4_snapshots"):
            # the rollouts and error maps run outside the guard: a device
            # fault there fails the run; only the drawing may be skipped
            try:
                fig4 = fig4_snapshot_data(
                    u, results, test_start=test_sl.start or 0, test_stop=test_sl.stop,
                    dt=cfg.dt, dx=cfg.dx, dy=cfg.dy, k_default=k_eval if k_eval else 10,
                )
            except NothingToDraw as e:
                print(f"   (skipped qualitative rollout snapshot: {e})")
            else:
                try:
                    draw_fig4_snapshots(out_dir, fig4)
                except Exception as e:  # pragma: no cover - parity with the reference's guard
                    print(f"   (skipped qualitative rollout snapshot: {e})")
    if timer is not None:
        out["stage_seconds"] = dict(timer.stages)
    return out


def _write_artifacts(cfg: AnalyzeConfig, out_dir: Path, out: dict, k_list: list[int]) -> None:
    """best_model.json, models_comparison.json and best_model_baseline.json,
    with the reference's display names."""

    def displayed(r: dict) -> dict:
        d = dict(r)
        d["names"] = [ANALYZE_DISPLAY.get(n, n) for n in r["names"]]
        return d

    results = out["results"]
    write_best_model(
        out_dir / "best_model.json",
        displayed(out["best_overall"]),
        train_frac=cfg.train_frac,
        spatial_eval=out["spatial_holdout"],
        spatial_eval_tb=out["spatial_holdout_top_bottom"],
        rollout_time_test=out["rollout_time_test"],
        rollout_space_lr=out["rollout_space_lr"],
        rollout_space_tb=out["rollout_space_tb"],
        rollout_steps=k_list,
    )
    write_models_comparison(
        out_dir / "models_comparison.json",
        [displayed(r) for r in results],
        displayed(out["best_simple"]),
        displayed(out["best_overall"]),
        train_frac=cfg.train_frac,
        space_train_frac=cfg.space_train_frac,
        rollout_steps=k_list,
        use_robust=cfg.robust_regression,
    )
    # the best-R2 model's payload, which the reference's comparative figure
    # generators read for their "approach comparison" panels
    bd = displayed(max(results, key=lambda r: r["r2"]))
    write_json(
        out_dir / "best_model_baseline.json",
        {
            "selection": "best_test_by_r2_only",
            "name": bd["name"],
            "r2": bd["r2"],
            "rmse": bd["rmse"],
            "nrmse": bd["nrmse"],
            "corr": bd["corr"],
            "one_step_rmse": bd["one_step_rmse"],
            "n_active": int(bd["n_active"]),
            "n_total": int(bd["n_total"]),
            "equation": bd["equation"],
            "terms": bd["names"],
            "coeffs": [float(c) for c in bd["coeffs"]],
            "rollout_time_test": {
                "steps": k_list,
                "metrics": {str(k): bd["rollout"].get(f"k{k}_test", {}) for k in k_list},
            },
        },
    )


def _split_slices(T: int, train_frac: float) -> tuple[slice, slice]:
    n_train, _ = split_time(T, train_frac)
    return slice(0, n_train), slice(n_train, T)


def _space_mask(mh: int, mw: int, frac: float, axis: str, device: torch.device) -> tuple[Tensor, Tensor]:
    """(train, test) boolean (mh, mw) masks: left / right columns or top /
    bottom rows, the split clamped to leave each side at least one line."""
    train = np.zeros((mh, mw), dtype=bool)
    if axis == "lr":
        train[:, : max(1, min(mw - 1, int(np.floor(frac * mw))))] = True
    else:
        train[: max(1, min(mh - 1, int(np.floor(frac * mh)))), :] = True
    return torch.as_tensor(train, device=device), torch.as_tensor(~train, device=device)


def _spatial_holdout(cfg, fields, u_t, u, model_key, mh, mw, axis) -> dict:
    """Fit on one spatial region, evaluate on the other
    (analyze_results.py:820-902). Empty for a model outside Models 1-6."""
    names = MODELS.get(model_key)
    if names is None:
        return {}
    train_m, test_m = _space_mask(mh, mw, cfg.space_train_frac, axis, u.device)
    p = len(names)
    Xf = torch.stack([fields[n] for n in names], dim=0).reshape(p, -1).T
    yf = u_t.reshape(-1)
    tm3 = torch.broadcast_to(train_m, u_t.shape).reshape(-1)
    sm3 = torch.broadcast_to(test_m, u_t.shape).reshape(-1)
    if cfg.robust_regression:
        # the robust fit needs the rows themselves (residual medians); the
        # region is fixed by the shapes, so the host builds the index
        idx = torch.as_tensor(np.nonzero(np.broadcast_to(train_m.cpu().numpy(), u_t.shape).reshape(-1))[0], device=u.device)
        coeffs = robust_stridge(Xf[idx], yf[idx], alpha=cfg.alpha, threshold=cfg.threshold, max_iter=20)[0]
    else:
        w_train = tm3.to(Xf.dtype)
        coeffs = stridge_from_stats(
            gram_stats(Xf, yf, weights=w_train), alpha=cfg.alpha, threshold=cfg.threshold, max_iter=20
        ).coeffs
    y_pred = Xf @ coeffs
    ut_pred_all = y_pred.reshape(u_t.shape)
    m_train = masked_regression_metrics(yf, y_pred, tm3)
    m_test = masked_regression_metrics(yf, y_pred, sm3)
    keys = sorted(m_train)  # pdx's order: its metrics come back as a pytree, keys sorted
    host = torch.cat([
        torch.stack([m_train[k] for k in keys] + [m_test[k] for k in keys] + [
            one_step_prediction_rmse(u, ut_pred_all, cfg.dt, train_m),
            one_step_prediction_rmse(u, ut_pred_all, cfg.dt, test_m),
        ]),
        coeffs,
    ]).cpu().numpy()
    nk = len(keys)
    m_train = {k: float(v) for k, v in zip(keys, host[:nk])}
    m_test = {k: float(v) for k, v in zip(keys, host[nk : 2 * nk])}
    m_train["one_step_rmse"] = float(host[2 * nk])
    m_test["one_step_rmse"] = float(host[2 * nk + 1])
    return {
        "space_train_frac": cfg.space_train_frac,
        "space_split": "left_right" if axis == "lr" else "top_bottom",
        "train": m_train,
        "test": m_test,
        "coeffs": [float(c) for c in host[2 * nk + 2 :]],
        "terms": [ANALYZE_DISPLAY.get(n, n) for n in names],
    }


def _parse_rollout_steps_env(val: str | None, default: tuple[int, ...]) -> tuple[int, ...]:
    """analyze_results.py:45-69: '1,2,3' or '1-10'."""
    if not val or not val.strip():
        return default
    s = val.strip()
    if "-" in s and "," not in s:
        a, b = s.split("-", 1)
        lo, hi = int(a), int(b)
        if hi < lo:
            lo, hi = hi, lo
        return tuple(range(max(1, lo), max(1, hi) + 1))
    out = sorted({int(p) for p in s.split(",") if p.strip() and int(p) > 0})
    return tuple(out) if out else default


def _env_bool(name: str, default: bool) -> bool:
    """analyze_results.py:77-81."""
    v = os.getenv(name)
    if v is None:
        return default
    return str(v).strip().lower() in {"1", "true", "yes", "y", "on"}


def config_from_env(cfg: AnalyzeConfig) -> AnalyzeConfig:
    """The reference's environment-variable overrides (analyze_results.py:
    PDE_ROLLOUT_STEPS :72, PDE_STABILIZE_TRANSLATION / _MODE / _EST_SIGMA
    :84-86, PDE_ROBUST_REGRESSION :543)."""
    return dataclasses.replace(
        cfg,
        rollout_steps=_parse_rollout_steps_env(os.getenv("PDE_ROLLOUT_STEPS"), cfg.rollout_steps),
        stabilize_translation=_env_bool("PDE_STABILIZE_TRANSLATION", cfg.stabilize_translation),
        stabilize_mode=os.getenv("PDE_STABILIZE_MODE", cfg.stabilize_mode),
        stabilize_est_sigma=float(os.getenv("PDE_STABILIZE_EST_SIGMA", cfg.stabilize_est_sigma)),
        robust_regression=_env_bool("PDE_ROBUST_REGRESSION", cfg.robust_regression),
    )


def parse_args(argv: list[str]) -> tuple[AnalyzeConfig, str, bool]:
    """(configuration with the PDE_* overrides applied, device, profile) from
    ``pdx analyze``'s flags plus ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch analyze")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-dir", default="outputs/latest/slides")
    parser.add_argument("--max-images", type=int, default=51)
    parser.add_argument("--robust", action="store_true")
    parser.add_argument("--stabilize", action="store_true")
    parser.add_argument("--no-registration", action="store_true")
    parser.add_argument("--register-mode", choices=["auto", "compose", "chain", "to_first"], default="auto",
                        help="auto: the chain; compose: batched pair flows + composition; chain: the "
                        "reference's sequential warp-to-previous; to_first: anchored to frame 0")
    parser.add_argument("--register-refine", type=int, default=1,
                        help="re-warp refinement passes per flow (0 = strict cv2-equivalent, 2 = max quality)")
    parser.add_argument("--reference-compat-warp", action="store_true")
    parser.add_argument("--include-fourth-order", action="store_true",
                        help="add the 25-term 4th-order library (notebook 02) as Model 7")
    parser.add_argument("--dtype", default="float64")
    parser.add_argument("--skip", type=int, default=25, help="crop margin in working pixels")
    parser.add_argument("--subsample", type=int, default=12, help="spatial subsample stride")
    parser.add_argument("--profile", action="store_true", help="print the per-stage wall-clock breakdown")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = AnalyzeConfig(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        max_images=args.max_images,
        robust_regression=args.robust,
        stabilize_translation=args.stabilize,
        registration=not args.no_registration,
        register_mode=args.register_mode,
        register_refine=args.register_refine,
        reference_compat_warp=args.reference_compat_warp,
        include_fourth_order=args.include_fourth_order,
        dtype=args.dtype,
        skip=args.skip,
        subsample=args.subsample,
    )
    return config_from_env(cfg), args.device, args.profile


def cmd_analyze(argv: list[str]) -> int:
    from pdx_torch.utils.profiling import StageTimer

    cfg, device, profile = parse_args(argv)
    timer = StageTimer() if profile else None
    out = run(cfg, timer=timer, device=device)
    if timer is not None:
        print(timer.report())
    print(f"Best overall: {out['best_overall']['name']}")
    print(f"  {out['best_overall']['equation']}")
    print(f"  test R2={out['best_overall']['r2']:.6f}")
    print(f"Best simple:  {out['best_simple']['name']}")
    print(f"  {out['best_simple']['equation']}")
    return 0
