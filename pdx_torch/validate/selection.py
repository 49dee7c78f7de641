"""Model selection and patch-ensemble aggregation (host numpy, tiny data).

Port of ``pdx/validate/selection.py``, a copy: it runs on the host in both
packages. Parity targets:
  * weighted rank-sum multi-objective selection: _rank / select_best
    (analyze_results.py:756-812) — 5x rollout-nRMSE rank + 3x one-step rank +
    1x sparsity rank + 1x R^2 rank, argmin of score. Ranks come from
    ``np.argsort``'s default kind, as in the reference: ties in n_active are
    common, and another sort kind can change the selected model;
  * patch stability selection (patch_based_pde_discovery.py:434-465) —
    median/IQR per term, nonzero frequency, sign stability, keep iff
    freq >= threshold, aggregate = masked median;
  * quality-weighted patch aggregation (patch_based_sindy.py:450-467).
"""

from __future__ import annotations

import numpy as np


def rank_indices(values: list[float], *, reverse: bool = False) -> list[int]:
    """0 = best; parity with _rank (analyze_results.py:756-763)."""
    order = np.argsort(values)
    if reverse:
        order = order[::-1]
    ranks = np.empty_like(order)
    ranks[order] = np.arange(len(values))
    return [int(r) for r in ranks]


def select_best(
    results_list: list[dict],
    *,
    max_active: int | None = None,
    k_eval: int = 10,
) -> dict:
    """Multi-objective weighted rank-sum selection (analyze_results.py:766-812).

    Each result dict needs: rollout[f"k{k_eval}_test"]["nrmse"],
    one_step_rmse, n_active, r2.
    """
    cand = [
        r
        for r in results_list
        if (max_active is None or int(r.get("n_active", 0)) <= int(max_active))
    ]
    if not cand:
        return results_list[0]

    rollout_nrmse = []
    for r in cand:
        v = float("inf")
        if k_eval > 0:
            v = float(r.get("rollout", {}).get(f"k{k_eval}_test", {}).get("nrmse", float("inf")))
        rollout_nrmse.append(v)

    one_step = [float(r.get("one_step_rmse", float("inf"))) for r in cand]
    n_active = [float(r.get("n_active", float("inf"))) for r in cand]
    r2 = [float(r.get("r2", float("-inf"))) for r in cand]

    rank_roll = rank_indices(rollout_nrmse)
    rank_step = rank_indices(one_step)
    rank_sparse = rank_indices(n_active)
    rank_r2 = rank_indices(r2, reverse=True)

    scores = [
        5.0 * rr + 3.0 * rs + 1.0 * r0 + 1.0 * r2r
        for rr, rs, r0, r2r in zip(rank_roll, rank_step, rank_sparse, rank_r2)
    ]
    best_idx = int(np.argmin(scores))
    out = dict(cand[best_idx])
    out["selection"] = {
        "k_eval": k_eval,
        "rank_rollout": rank_roll[best_idx],
        "rank_one_step": rank_step[best_idx],
        "rank_sparsity": rank_sparse[best_idx],
        "rank_r2": rank_r2[best_idx],
        "score": float(scores[best_idx]),
    }
    return out


def patch_stability_aggregate(
    coeff_matrix: np.ndarray,
    *,
    freq_threshold: float = 0.6,
    active_tol: float = 1e-10,
) -> dict[str, np.ndarray]:
    """Stability selection over a (n_patches, p) coefficient matrix.

    Parity: patch_based_pde_discovery.py:434-465 — per-term median, IQR,
    nonzero frequency, dominant-sign agreement; a term survives iff its
    nonzero frequency >= freq_threshold; the aggregate coefficient is the
    median over patches where it was active (masked median), else 0.
    """
    C = np.asarray(coeff_matrix, dtype=np.float64)
    active = np.abs(C) > active_tol
    freq = active.mean(axis=0)
    median = np.median(C, axis=0)
    q75, q25 = np.percentile(C, [75, 25], axis=0)
    iqr = q75 - q25
    signs = np.sign(C)
    # dominant sign agreement among active patches
    sign_stability = np.zeros(C.shape[1])
    masked_median = np.zeros(C.shape[1])
    for j in range(C.shape[1]):
        act = active[:, j]
        if act.any():
            s = signs[act, j]
            sign_stability[j] = max((s > 0).mean(), (s < 0).mean())
            masked_median[j] = np.median(C[act, j])
    keep = freq >= freq_threshold
    final = np.where(keep, masked_median, 0.0)
    return {
        "median": median,
        "iqr": iqr,
        "freq": freq,
        "sign_stability": sign_stability,
        "keep": keep,
        "coeffs": final,
    }


def quality_weighted_aggregate(
    coeff_matrix: np.ndarray,
    weights: np.ndarray,
    *,
    var_factor: float = 2.0,
) -> np.ndarray:
    """Quality-weighted average with high-variance-term suppression.

    Parity: patch_based_sindy.py:450-467 — weighted mean of patch
    coefficients, then zero terms whose std exceeds var_factor x median std.
    """
    C = np.asarray(coeff_matrix, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    w = w / (w.sum() + 1e-12)
    mean = (C * w[:, None]).sum(axis=0)
    stds = C.std(axis=0)
    med_std = np.median(stds)
    mean[stds > var_factor * med_std] = 0.0
    return mean
