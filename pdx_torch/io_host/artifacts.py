"""Result-artifact writers, the inter-stage file contract (port of
``pdx/io_host/artifacts.py``): ``best_model.json``, the single source of
truth between discovery and every figure (schema at
analyze_results.py:984-1020), ``models_comparison.json``
(analyze_results.py:1038-1100), other JSON summaries and the
patch-discovery coefficient CSV."""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

import numpy as np
import torch


def _to_builtin(x):
    """numpy / torch scalars and arrays (flattened to lists of floats),
    dicts, lists and tuples -> JSON-serialisable Python values."""
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return [float(v) for v in x.ravel().tolist()]
    if isinstance(x, torch.Tensor):
        return x.item() if x.ndim == 0 else [float(v) for v in x.detach().cpu().reshape(-1).tolist()]
    if isinstance(x, dict):
        return {k: _to_builtin(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_builtin(v) for v in x]
    return x


def write_json(path: str | Path, payload: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", encoding="utf-8") as f:
        json.dump(_to_builtin(payload), f, indent=2)
    return path


def write_best_model(path: str | Path, best_overall: dict, *, train_frac: float,
                     spatial_eval: dict, spatial_eval_tb: dict,
                     rollout_time_test: dict, rollout_space_lr: dict,
                     rollout_space_tb: dict, rollout_steps: list[int]) -> Path:
    """best_model.json with the reference schema (analyze_results.py:984-1020)."""
    payload = {
        "generated_at": datetime.now().isoformat(timespec="seconds"),
        "selection": "best_test_by_r2",
        "train_frac": train_frac,
        "name": best_overall["name"],
        "r2": best_overall["r2"],
        "rmse": best_overall["rmse"],
        "mae": best_overall["mae"],
        "nrmse": best_overall["nrmse"],
        "corr": best_overall["corr"],
        "resid_med_abs": best_overall["resid_med_abs"],
        "one_step_rmse": best_overall["one_step_rmse"],
        "train_r2": best_overall.get("train_r2"),
        "train_rmse": best_overall.get("train_rmse"),
        "train_nrmse": best_overall.get("train_nrmse"),
        "train_corr": best_overall.get("train_corr"),
        "train_one_step_rmse": best_overall.get("train_one_step_rmse"),
        "n_active": int(best_overall["n_active"]),
        "n_total": int(best_overall["n_total"]),
        "equation": best_overall["equation"],
        "terms": best_overall["names"],
        "coeffs": [float(c) for c in best_overall["coeffs"]],
        "spatial_holdout": spatial_eval,
        "spatial_holdout_top_bottom": spatial_eval_tb,
        "rollout_time_test": {
            "steps": list(rollout_steps),
            "metrics": {str(k): rollout_time_test.get(k, {}) for k in rollout_steps},
        },
        "rollout_space_test_left_right": {
            "steps": list(rollout_steps),
            "metrics": {str(k): rollout_space_lr.get(k, {}) for k in rollout_steps},
        },
        "rollout_space_test_top_bottom": {
            "steps": list(rollout_steps),
            "metrics": {str(k): rollout_space_tb.get(k, {}) for k in rollout_steps},
        },
    }
    return write_json(path, payload)


def write_models_comparison(
    path: str | Path, results: list[dict], best_simple: dict, best_overall: dict,
    *, train_frac: float, space_train_frac: float, rollout_steps: list[int],
    use_robust: bool,
) -> Path:
    """models_comparison.json with the reference schema
    (analyze_results.py:1038-1100)."""
    k_eval = int(rollout_steps[-1]) if rollout_steps else 0
    models = []
    for r in results:
        rollout_k_test = r.get("rollout", {}).get(f"k{k_eval}_test", {}) if k_eval else {}
        models.append(
            {
                "name": r.get("name"),
                "r2_test": r.get("r2"),
                "rmse_test": r.get("rmse"),
                "nrmse_test": r.get("nrmse"),
                "corr_test": r.get("corr"),
                "one_step_rmse": r.get("one_step_rmse"),
                "n_active": int(r.get("n_active", 0)),
                "n_total": int(r.get("n_total", 0)),
                "equation": r.get("equation"),
                "terms": list(r.get("names", [])),
                "coeffs": [float(c) for c in np.asarray(r.get("coeffs"), dtype=float).ravel()],
                "rollout": {"k_eval": k_eval, "test": rollout_k_test},
                "rollout_curve_test": {
                    "steps": list(rollout_steps),
                    "metrics": {
                        str(int(k)): r.get("rollout", {}).get(f"k{int(k)}_test", {})
                        for k in rollout_steps
                    },
                },
            }
        )
    payload = {
        "generated_at": datetime.now().isoformat(timespec="seconds"),
        "train_frac": train_frac,
        "space_train_frac": space_train_frac,
        "rollout_steps": list(rollout_steps),
        "use_robust_regression": bool(use_robust),
        "best_simple": {
            "name": best_simple.get("name"),
            "r2_test": best_simple.get("r2"),
            "one_step_rmse": best_simple.get("one_step_rmse"),
            "n_active": int(best_simple.get("n_active", 0)),
        },
        "best_overall": {
            "name": best_overall.get("name"),
            "r2_test": best_overall.get("r2"),
            "one_step_rmse": best_overall.get("one_step_rmse"),
            "n_active": int(best_overall.get("n_active", 0)),
        },
        "models": models,
    }
    return write_json(path, payload)


def write_patch_csv(path: str | Path, names: list[str], stats: dict) -> Path:
    """PATCH_PDE_COEFFS.csv (patch_based_pde_discovery.py:468-472)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", encoding="utf-8") as f:
        f.write("term,median,q25,q75,nonzero_freq,sign_stability,agg_coeff\n")
        for i, name in enumerate(names):
            f.write(
                f"{name},{stats['median'][i]:.8g},{stats['q25'][i]:.8g},{stats['q75'][i]:.8g},"
                f"{stats['freq'][i]:.3f},{stats['sign_stability'][i]:.3f},{stats['coeffs'][i]:.8g}\n"
            )
    return path
