"""Comparative / final-class / presentation figure suites (port of
``pdx/report/comparative.py``).

Asset-for-asset coverage of the reference's three richer generators —
``create_comparative_final_figures.py`` (25 PNGs),
``create_finalclass_figures.py`` (8 PNGs), and
``generate_presentation_figures.py`` (6 PNGs) — driven from the same
artifact contract (best_model.json, models_comparison.json, patch CSV/
report) plus, for the data-overview figures, the raw image folder.

The contract readers and the rank / normalise helpers are plain numpy and
json, as in ``pdx``. The one piece of device work, the registration strip
and quiver of the presentation suite, is :func:`presentation_flow_data`: it
runs on the device it is given and returns host arrays, and only then is
anything drawn. matplotlib is imported by the drawing alone, so this module
imports without it; without it the suites raise ``ImportError`` (after the
device work, for the presentation suite).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from pdx_torch.report.pipeline_figures import _pyplot, _save

PALETTE = ["#4C78A8", "#F58518", "#54A24B", "#E45756", "#72B7B2", "#B279A2"]


# --------------------------------------------------------------------------
# contract readers
# --------------------------------------------------------------------------

def _read_json(p: Path) -> dict:
    return json.loads(Path(p).read_text(encoding="utf-8"))


def _model_id(name: str) -> str:
    s = str(name)
    if s.strip().startswith("Model"):
        head = s.split(":", 1)[0].split()
        if len(head) >= 2 and head[1].isdigit():
            return f"M{head[1]}"
    return s[:6]


def _table(comp: dict) -> dict:
    """Extract the per-model metric table from models_comparison.json."""
    models = comp.get("models", [])
    get = lambda k: np.asarray([float(m.get(k, np.nan)) for m in models])
    rollout10 = np.asarray(
        [float((m.get("rollout", {}).get("test", {}) or {}).get("nrmse", np.nan)) for m in models]
    )
    return {
        "models": models,
        "ids": [_model_id(m.get("name", "")) for m in models],
        "r2": get("r2_test"),
        "one_step": get("one_step_rmse"),
        "rollout10": rollout10,
        "active": get("n_active"),
    }


def _curves(comp: dict) -> list[tuple[str, np.ndarray, np.ndarray]]:
    out = []
    for m in comp.get("models", []):
        c = m.get("rollout_curve_test", {}) or {}
        steps = c.get("steps", [])
        if not steps:
            continue
        ks = np.asarray([int(k) for k in steps])
        ys = np.asarray(
            [float((c.get("metrics", {}).get(str(int(k)), {}) or {}).get("nrmse", np.nan)) for k in ks]
        )
        out.append((_model_id(m.get("name", "")), ks, ys))
    return out


def _rank(values: np.ndarray, higher_better: bool) -> np.ndarray:
    """1 = best; nan ranks last."""
    v = np.where(np.isfinite(values), values, -np.inf if higher_better else np.inf)
    order = np.argsort(-v if higher_better else v)
    ranks = np.empty(len(v))
    ranks[order] = np.arange(1, len(v) + 1)
    return ranks


def _norm01(values: np.ndarray, higher_better: bool) -> np.ndarray:
    v = values.astype(float)
    finite = np.isfinite(v)
    if not finite.any():
        return np.zeros_like(v)
    lo, hi = np.nanmin(v[finite]), np.nanmax(v[finite])
    n = (v - lo) / (hi - lo + 1e-12)
    n = np.where(np.isfinite(n), n, 1.0)
    return n if higher_better else 1.0 - n


def _approach_points(slides_dir: Path) -> list[tuple[str, float, float]]:
    """(label, r2, rollout-nrmse@k_last) for every available approach file.

    Mirrors the reference's optional stabilization-variant payloads; missing
    files are skipped, and the main best_model.json always contributes.
    """
    candidates = [
        ("baseline (best R²)", "best_model_baseline.json"),
        ("+translation stab", "best_model_stabilized_translation.json"),
        ("to_first (σ=2)", "best_model_stab_to_first_sigma2.json"),
        ("selected (stable)", "best_model.json"),
    ]
    pts = []
    for label, fname in candidates:
        p = Path(slides_dir) / fname
        if not p.exists():
            continue
        d = _read_json(p)
        r = d.get("rollout_time_test", {}) or {}
        steps = r.get("steps", [])
        roll = (
            float((r.get("metrics", {}).get(str(int(steps[-1])), {}) or {}).get("nrmse", np.nan))
            if steps
            else float("nan")
        )
        pts.append((label, float(d.get("r2", np.nan)), roll))
    return pts


# --------------------------------------------------------------------------
# comparative suite (create_comparative_final_figures.py parity, 25 assets)
# --------------------------------------------------------------------------

def _fig_models_heatmap(t, out, compact=False):
    metrics = [
        ("R² (↑)", _norm01(t["r2"], True)),
        ("one-step (↓)", _norm01(t["one_step"], False)),
        ("rollout k (↓)", _norm01(t["rollout10"], False)),
        ("#active (↓)", _norm01(t["active"], False)),
    ]
    M = np.stack([m[1] for m in metrics], axis=1)
    figsize = (6.5, 3.2) if compact else (10, 4.5)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(M, cmap="RdYlGn", vmin=0, vmax=1, aspect="auto")
    ax.set_xticks(range(len(metrics)))
    ax.set_xticklabels([m[0] for m in metrics], fontsize=9)
    ax.set_yticks(range(len(t["ids"])))
    ax.set_yticklabels(t["ids"])
    if not compact:
        for i in range(M.shape[0]):
            for j in range(M.shape[1]):
                ax.text(j, i, f"{M[i, j]:.2f}", ha="center", va="center", fontsize=8)
    fig.colorbar(im, ax=ax, label="normalized score (1 = best)")
    ax.set_title("Model scores across metrics")
    return _save(fig, out)


def _fig_paired_bars(t, out):
    x = np.arange(len(t["ids"]))
    plt = _pyplot()
    fig, ax1 = plt.subplots(figsize=(9, 4.5))
    ax1.bar(x - 0.2, t["r2"], width=0.4, color=PALETTE[0], label="test R² (↑)")
    ax1.set_ylabel("test R²", color=PALETTE[0])
    ax2 = ax1.twinx()
    roll = np.where(np.isfinite(t["rollout10"]), t["rollout10"], np.nan)
    ax2.bar(x + 0.2, roll, width=0.4, color=PALETTE[1], label="rollout nRMSE (↓)")
    ax2.set_yscale("log")
    ax2.set_ylabel("rollout nRMSE @ k (log)", color=PALETTE[1])
    ax1.set_xticks(x)
    ax1.set_xticklabels(t["ids"])
    ax1.set_title("Fit vs long-horizon stability")
    return _save(fig, out)


def _fig_slopegraph(t, out):
    r_fit = _rank(t["r2"], True)
    r_roll = _rank(t["rollout10"], False)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    for i, mid in enumerate(t["ids"]):
        c = PALETTE[i % len(PALETTE)]
        ax.plot([0, 1], [r_fit[i], r_roll[i]], marker="o", color=c)
        ax.text(-0.05, r_fit[i], mid, ha="right", va="center", color=c)
        ax.text(1.05, r_roll[i], mid, ha="left", va="center", color=c)
    ax.set_xticks([0, 1])
    ax.set_xticklabels(["fit rank (R²)", "stability rank (rollout)"])
    ax.invert_yaxis()
    ax.set_ylabel("rank (1 = best)")
    ax.set_title("Fit rank rarely predicts stability rank")
    return _save(fig, out)


def _fig_rank_view(t, out, slope=False):
    metrics = [
        ("R²", _rank(t["r2"], True)),
        ("one-step", _rank(t["one_step"], False)),
        ("rollout", _rank(t["rollout10"], False)),
        ("sparsity", _rank(-t["active"], True)),
    ]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4.5))
    x = np.arange(len(metrics))
    for i, mid in enumerate(t["ids"]):
        ranks = [m[1][i] for m in metrics]
        c = PALETTE[i % len(PALETTE)]
        if slope:
            ax.plot(x, ranks, marker="o", color=c, label=mid)
        else:
            ax.scatter(x, ranks, s=90, color=c, label=mid)
    ax.set_xticks(x)
    ax.set_xticklabels([m[0] for m in metrics])
    ax.invert_yaxis()
    ax.set_ylabel("rank (1 = best)")
    ax.set_title("Per-metric model ranks")
    ax.legend(ncol=3, fontsize=8)
    return _save(fig, out)


def _fig_rollout_horizon(comp, out, model_ids=None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8.5, 4.5))
    for i, (mid, ks, ys) in enumerate(_curves(comp)):
        if model_ids is not None and mid not in model_ids:
            continue
        ax.plot(ks, ys, marker="o", color=PALETTE[i % len(PALETTE)], label=mid)
    ax.set_yscale("log")
    ax.set_xlabel("horizon k (steps)")
    ax.set_ylabel("rollout nRMSE (log; lower is better)")
    ax.set_title("Rollout error vs horizon")
    ax.legend(ncol=3, fontsize=9)
    return _save(fig, out)


def _fig_stabilization_effect(slides_dir, out):
    pts = _approach_points(slides_dir)
    if not pts:
        raise FileNotFoundError("no best_model*.json approach payloads found")
    labels = [p[0] for p in pts]
    vals = np.asarray([p[2] for p in pts])
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8.5, 4.5))
    x = np.arange(len(labels), dtype=float)
    ax.plot(x, vals, marker="o", linewidth=2, color=PALETTE[0])
    for xi, yi in zip(x, vals):
        if np.isfinite(yi):
            ax.text(xi, yi, f"{yi:.3g}", ha="center", va="bottom", fontsize=9)
    ax.set_xticks(x)
    ax.set_xticklabels(labels, fontsize=9)
    if np.isfinite(vals).any() and np.nanmin(vals) > 0:
        ax.set_yscale("log")
    ax.set_ylabel("rollout nRMSE @ k_last (↓)")
    ax.set_title("Preprocessing/stabilization vs long-horizon error")
    return _save(fig, out)


def _fig_metric_disentanglement(t, out):
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    pairs = [
        ("test R²", t["r2"], "one-step RMSE", t["one_step"]),
        ("test R²", t["r2"], "rollout nRMSE", t["rollout10"]),
        ("#active terms", t["active"], "rollout nRMSE", t["rollout10"]),
    ]
    for ax, (xl, xs, yl, ys) in zip(axes, pairs):
        for i, mid in enumerate(t["ids"]):
            ax.scatter(xs[i], ys[i], s=80, color=PALETTE[i % len(PALETTE)])
            ax.annotate(mid, (xs[i], ys[i]), fontsize=8, xytext=(3, 3), textcoords="offset points")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
    fig.suptitle("Metrics measure different things")
    return _save(fig, out)


def _fig_rollout_bars(t, out):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5.5, 7))
    order = np.argsort(np.where(np.isfinite(t["rollout10"]), t["rollout10"], np.inf))
    ids = [t["ids"][i] for i in order]
    vals = t["rollout10"][order]
    ax.barh(range(len(ids)), np.where(np.isfinite(vals), vals, np.nanmax(vals[np.isfinite(vals)]) * 2 if np.isfinite(vals).any() else 1.0),
            color=[PALETTE[i % len(PALETTE)] for i in range(len(ids))])
    ax.set_yticks(range(len(ids)))
    ax.set_yticklabels(ids)
    ax.invert_yaxis()
    ax.set_xscale("log")
    ax.set_xlabel("rollout nRMSE (log, ↓)")
    ax.set_title("Long-horizon stability ranking")
    return _save(fig, out)


def _fig_pareto(t, out, square=False):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6) if square else (8, 5))
    for i, mid in enumerate(t["ids"]):
        ax.scatter(t["r2"][i], t["rollout10"][i], s=140, color=PALETTE[i % len(PALETTE)],
                   edgecolor="black", linewidth=0.8)
        ax.annotate(mid, (t["r2"][i], t["rollout10"][i]), fontsize=9,
                    xytext=(5, 5), textcoords="offset points")
    if np.isfinite(t["rollout10"]).any() and np.nanmin(t["rollout10"]) > 0:
        ax.set_yscale("log")
    ax.set_xlabel("test R² (→ better fit)")
    ax.set_ylabel("rollout nRMSE (↓ more stable)")
    ax.set_title("Fit/stability Pareto view")
    return _save(fig, out)


def _fig_coeff_heatmap(comp, out, key_terms=None):
    models = comp.get("models", [])
    all_terms = sorted({term for m in models for term in m.get("terms", [])})
    if key_terms:
        all_terms = [term for term in all_terms if term in key_terms]
    M = np.zeros((len(models), len(all_terms)))
    for i, m in enumerate(models):
        for term, c in zip(m.get("terms", []), m.get("coeffs", [])):
            if term in all_terms:
                M[i, all_terms.index(term)] = c
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(max(7, len(all_terms) * 0.9), 4))
    vmax = np.abs(M).max() + 1e-12
    im = ax.imshow(M, cmap="RdBu_r", vmin=-vmax, vmax=vmax, aspect="auto")
    ax.set_xticks(range(len(all_terms)))
    ax.set_xticklabels(all_terms, rotation=45, ha="right", fontsize=8)
    ax.set_yticks(range(len(models)))
    ax.set_yticklabels([_model_id(m.get("name", "")) for m in models])
    fig.colorbar(im, ax=ax, label="coefficient")
    ax.set_title("Discovered coefficients" + (" (key terms)" if key_terms else ""))
    return _save(fig, out)


def _fig_terms_presence(comp, out):
    models = comp.get("models", [])
    all_terms = sorted({term for m in models for term in m.get("terms", [])})
    M = np.zeros((len(models), len(all_terms)))
    for i, m in enumerate(models):
        for term, c in zip(m.get("terms", []), m.get("coeffs", [])):
            M[i, all_terms.index(term)] = float(abs(c) > 1e-5)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(max(7, len(all_terms) * 0.8), 4))
    ax.imshow(M, cmap="Greys", vmin=0, vmax=1, aspect="auto")
    ax.set_xticks(range(len(all_terms)))
    ax.set_xticklabels(all_terms, rotation=45, ha="right", fontsize=8)
    ax.set_yticks(range(len(models)))
    ax.set_yticklabels([_model_id(m.get("name", "")) for m in models])
    ax.set_title("Term presence across models (dark = active)")
    return _save(fig, out)


def _fig_approach_bars(slides_dir, out, metric="both"):
    pts = _approach_points(slides_dir)
    if not pts:
        raise FileNotFoundError("no best_model*.json approach payloads found")
    labels = [p[0] for p in pts]
    x = np.arange(len(labels))
    plt = _pyplot()
    if metric == "both":
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        axes[0].bar(x, [p[1] for p in pts], color=PALETTE[0])
        axes[0].set_title("fit: test R² (↑)")
        axes[1].bar(x, [p[2] for p in pts], color=PALETTE[1])
        axes[1].set_title("stability: rollout nRMSE (↓)")
        if all(np.isfinite(p[2]) and p[2] > 0 for p in pts):
            axes[1].set_yscale("log")
        for ax in axes:
            ax.set_xticks(x)
            ax.set_xticklabels(labels, rotation=20, ha="right", fontsize=8)
    else:
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.bar(x, [p[2] for p in pts], color=PALETTE[1])
        ax.set_xticks(x)
        ax.set_xticklabels(labels, rotation=20, ha="right", fontsize=8)
        ax.set_title("Approach stability (rollout nRMSE, ↓)")
        if all(np.isfinite(p[2]) and p[2] > 0 for p in pts):
            ax.set_yscale("log")
    return _save(fig, out)


def _fig_score_stacked(t, out):
    parts = [
        ("R²", _norm01(t["r2"], True)),
        ("one-step", _norm01(t["one_step"], False)),
        ("rollout", _norm01(t["rollout10"], False)),
        ("sparsity", _norm01(-t["active"], True)),
    ]
    x = np.arange(len(t["ids"]))
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4.5))
    bottom = np.zeros(len(x))
    for j, (label, vals) in enumerate(parts):
        ax.bar(x, vals, bottom=bottom, color=PALETTE[j], label=label)
        bottom += vals
    ax.set_xticks(x)
    ax.set_xticklabels(t["ids"])
    ax.set_ylabel("stacked normalized score (↑)")
    ax.set_title("Composite model score")
    ax.legend(ncol=4, fontsize=8)
    return _save(fig, out)


def _fig_rank_bars(t, out):
    score = (
        5 * _rank(t["rollout10"], False)
        + 3 * _rank(t["one_step"], False)
        + _rank(-t["active"], True)
        + _rank(t["r2"], True)
    )
    order = np.argsort(score)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.bar(range(len(order)), score[order], color=[PALETTE[i % len(PALETTE)] for i in range(len(order))])
    ax.set_xticks(range(len(order)))
    ax.set_xticklabels([t["ids"][i] for i in order])
    ax.set_ylabel("weighted rank sum (↓ better)")
    ax.set_title("Rank-sum model selection (5·rollout + 3·one-step + sparsity + R²)")
    return _save(fig, out)


def _fig_m3_m4_dumbbell(t, out):
    try:
        i3, i4 = t["ids"].index("M3"), t["ids"].index("M4")
    except ValueError as e:
        raise RuntimeError("need Models 3 and 4 in models_comparison.json") from e
    metrics = [
        ("test R²", t["r2"]),
        ("one-step RMSE", t["one_step"]),
        ("rollout nRMSE", t["rollout10"]),
        ("#active", t["active"]),
    ]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4))
    for row, (label, vals) in enumerate(metrics):
        v = _norm01(vals, True)
        ax.plot([v[i3], v[i4]], [row, row], color="gray", linewidth=2, zorder=1)
        ax.scatter(v[i3], row, s=120, color=PALETTE[0], zorder=2, label="M3" if row == 0 else None)
        ax.scatter(v[i4], row, s=120, color=PALETTE[1], zorder=2, label="M4" if row == 0 else None)
        ax.text(-0.06, row, label, ha="right", va="center")
    ax.set_yticks([])
    ax.set_xlabel("normalized value")
    ax.set_title("M3 (stable) vs M4 (best fit)")
    ax.legend()
    return _save(fig, out)


def _fig_patch_stability_heatmap(patch_csv, out):
    rows = _read_patch_csv(patch_csv)
    terms = [r["term"] for r in rows]
    cols = ["median", "q25", "q75", "nonzero_freq", "sign_stability", "agg_coeff"]
    M = np.asarray([[float(r[c]) for c in cols] for r in rows])
    # normalize each column for display
    D = np.stack([_norm01(M[:, j], True) for j in range(M.shape[1])], axis=1)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, max(3, 0.4 * len(terms))))
    im = ax.imshow(D, cmap="viridis", aspect="auto")
    ax.set_xticks(range(len(cols)))
    ax.set_xticklabels(cols, rotation=30, ha="right", fontsize=8)
    ax.set_yticks(range(len(terms)))
    ax.set_yticklabels(terms, fontsize=8)
    for i in range(len(terms)):
        for j in range(len(cols)):
            ax.text(j, i, f"{M[i, j]:.2g}", ha="center", va="center", fontsize=7,
                    color="white" if D[i, j] < 0.5 else "black")
    fig.colorbar(im, ax=ax, label="column-normalized")
    ax.set_title("Patch-ensemble stability statistics")
    return _save(fig, out)


def _read_patch_csv(path: Path) -> list[dict]:
    import csv

    with Path(path).open() as f:
        return list(csv.DictReader(f))


def create_comparative_final_figures(slides_dir: str | Path, patch_csv: str | Path | None = None) -> list[Path]:
    """All 25 comparative assets (create_comparative_final_figures.py:1478-1556)."""
    slides_dir = Path(slides_dir)
    comp = _read_json(slides_dir / "models_comparison.json")
    t = _table(comp)
    outs = [
        _fig_models_heatmap(t, slides_dir / "PRES1_MODELS_HEATMAP_WIDE.png"),
        _fig_rollout_bars(t, slides_dir / "PRES2_ROLLOUT_BARS_TALL.png"),
        _fig_pareto(t, slides_dir / "PRES3_FIT_STABILITY_SQUARE.png", square=True),
        _fig_m3_m4_dumbbell(t, slides_dir / "PRES4_M3_VS_M4_DUMBBELL_WIDE.png"),
        _fig_terms_presence(comp, slides_dir / "PICK_TERMS_PRESENCE_HEATMAP.png"),
        _fig_approach_bars(slides_dir, slides_dir / "PICK_APPROACHES_BARS.png"),
        _fig_score_stacked(t, slides_dir / "PAPER1_SCORE_STACKED_BARS_WIDE.png"),
        _fig_pareto(t, slides_dir / "PAPER2_PARETO_SCATTER_SQUARE.png", square=True),
        _fig_coeff_heatmap(comp, slides_dir / "PAPER3_COEFF_HEATMAP_WIDE.png"),
        _fig_approach_bars(slides_dir, slides_dir / "PAPER4_APPROACH_BARS_WIDE.png"),
        _fig_rank_bars(t, slides_dir / "MINI1_RANK_BARS_WIDE.png"),
        _fig_pareto(t, slides_dir / "MINI2_PARETO_SQUARE.png", square=True),
        _fig_coeff_heatmap(
            comp, slides_dir / "MINI3_COEFF_KEYTERMS_WIDE.png",
            key_terms={"u", "u_x", "u_y", "lap(u)", "u^2"},
        ),
        _fig_approach_bars(slides_dir, slides_dir / "MINI4_APPROACH_STABILITY_WIDE.png", metric="stability"),
        _fig_pareto(t, slides_dir / "TRADEOFF_FIT_VS_STABILITY_SCATTER.png"),
        _fig_rollout_horizon(comp, slides_dir / "FIG2_ROLLOUT_VS_HORIZON.png", model_ids={"M3", "M4", "M5"}),
        _fig_stabilization_effect(slides_dir, slides_dir / "FIG3_STABILIZATION_EFFECT.png"),
        _fig_metric_disentanglement(t, slides_dir / "FIG3B_METRIC_DISENTANGLEMENT.png"),
        _fig_rollout_horizon(comp, slides_dir / "FIG2_ROLLOUT_VS_HORIZON_ALL_MODELS.png"),
        _fig_paired_bars(t, slides_dir / "FIG1_ALT_PAIRED_BARS_R2_VS_ROLLOUT.png"),
        _fig_slopegraph(t, slides_dir / "FIG1_ALT_SLOPEGRAPH_FIT_TO_ROLLOUT.png"),
        _fig_rank_view(t, slides_dir / "FIG1_ALT_RANK_VIEW.png"),
        _fig_models_heatmap(t, slides_dir / "FIG1_ALT_COMPACT_HEATMAP.png", compact=True),
        _fig_rank_view(t, slides_dir / "FIGX_RANK_SLOPE_FIT_VS_ROLLOUT.png", slope=True),
    ]
    if patch_csv and Path(patch_csv).exists():
        outs.append(
            _fig_patch_stability_heatmap(patch_csv, slides_dir / "PAPER5_PATCH_STABILITY_HEATMAP_WIDE.png")
        )
    return outs


# --------------------------------------------------------------------------
# final-class suite (create_finalclass_figures.py parity, 8 assets)
# --------------------------------------------------------------------------

def _best_payloads(slides_dir: Path) -> tuple[dict, dict]:
    """(stable/selected payload, best-R² payload). The baseline file is
    optional in the reference; pdx analyze writes it, but fall back to the
    selected model so the figures always render."""
    selected = _read_json(slides_dir / "best_model.json")
    base_p = slides_dir / "best_model_baseline.json"
    baseline = _read_json(base_p) if base_p.exists() else selected
    return selected, baseline


def _fig_pipeline(out, dash=False):
    stages = ["load\n51 TIFFs", "register\n(opt. flow)", "denoise\n+ crop", "derivatives",
              "library Θ(u)", "STRidge", "validate\n(rollout)", "select"]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 2.8) if not dash else (12, 4))
    x = np.arange(len(stages), dtype=float)
    ax.barh([0] * len(stages), [0.9] * len(stages), left=x, height=0.6,
            color=[PALETTE[i % len(PALETTE)] for i in range(len(stages))], alpha=0.85)
    for xi, s in zip(x, stages):
        ax.text(xi + 0.45, 0, s, ha="center", va="center", fontsize=9, fontweight="bold")
        if xi < len(stages) - 1:
            ax.annotate("", xy=(xi + 1.0, 0), xytext=(xi + 0.92, 0),
                        arrowprops=dict(arrowstyle="->", lw=1.4))
    ax.set_xlim(-0.2, len(stages))
    ax.axis("off")
    ax.set_title("PDE discovery pipeline")
    return _save(fig, out)


def _fig_model3_vs_model4(selected, baseline, out, dash=False):
    rows = [
        ("test R² (↑)", selected.get("r2"), baseline.get("r2")),
        ("one-step RMSE (↓)", selected.get("one_step_rmse"), baseline.get("one_step_rmse")),
        ("nRMSE (↓)", selected.get("nrmse"), baseline.get("nrmse")),
        ("corr (↑)", selected.get("corr"), baseline.get("corr")),
        ("#active (↓)", selected.get("n_active"), baseline.get("n_active")),
    ]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4.5))
    x = np.arange(len(rows))
    a = [float(r[1]) if r[1] is not None else np.nan for r in rows]
    b = [float(r[2]) if r[2] is not None else np.nan for r in rows]
    ax.bar(x - 0.18, a, width=0.36, color=PALETTE[0], label=_model_id(selected.get("name", "selected")))
    ax.bar(x + 0.18, b, width=0.36, color=PALETTE[1], label=_model_id(baseline.get("name", "baseline")))
    ax.set_xticks(x)
    ax.set_xticklabels([r[0] for r in rows], fontsize=9)
    ax.legend()
    title = "Selected (stable) vs best-R² model"
    if dash:
        title += f"\n{selected.get('equation', '')}\n{baseline.get('equation', '')}"
    ax.set_title(title, fontsize=11)
    return _save(fig, out)


def _fig_coeffs_comparison(selected, baseline, out, dash=False):
    terms = sorted(set(selected.get("terms", [])) | set(baseline.get("terms", [])))
    def vec(p):
        d = dict(zip(p.get("terms", []), p.get("coeffs", [])))
        return np.asarray([float(d.get(t, 0.0)) for t in terms])
    va, vb = vec(selected), vec(baseline)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 4.5))
    x = np.arange(len(terms))
    ax.bar(x - 0.18, va, width=0.36, color=PALETTE[0], label=_model_id(selected.get("name", "")))
    ax.bar(x + 0.18, vb, width=0.36, color=PALETTE[1], label=_model_id(baseline.get("name", "")))
    ax.set_xticks(x)
    ax.set_xticklabels(terms, rotation=45, ha="right", fontsize=8)
    ax.axhline(0, color="black", linewidth=0.8)
    ax.legend()
    ax.set_title("Coefficient comparison" + (" (dashboard)" if dash else ""))
    if dash:
        ax2 = ax.twinx()
        ax2.set_yticks([])
    return _save(fig, out)


def _fig_patch_diagnostics(patch_csv, out, dash=False):
    rows = _read_patch_csv(patch_csv)
    terms = [r["term"] for r in rows]
    freq = np.asarray([float(r["nonzero_freq"]) for r in rows])
    med = np.asarray([float(r["median"]) for r in rows])
    q25 = np.asarray([float(r["q25"]) for r in rows])
    q75 = np.asarray([float(r["q75"]) for r in rows])
    n_panels = 3 if dash else 2
    plt = _pyplot()
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 4))
    x = np.arange(len(terms))
    axes[0].bar(x, freq, color=PALETTE[0])
    axes[0].axhline(0.6, color="red", linestyle="--", label="keep ≥ 0.6")
    axes[0].set_title("nonzero frequency across patches")
    axes[0].legend(fontsize=8)
    axes[1].errorbar(x, med, yerr=[med - q25, q75 - med], fmt="o", color=PALETTE[1])
    axes[1].axhline(0, color="black", linewidth=0.8)
    axes[1].set_title("median ± IQR per term")
    if dash:
        sign = np.asarray([float(r["sign_stability"]) for r in rows])
        axes[2].bar(x, sign, color=PALETTE[2])
        axes[2].set_title("sign stability")
    for ax in axes:
        ax.set_xticks(x)
        ax.set_xticklabels(terms, rotation=45, ha="right", fontsize=7)
    return _save(fig, out)


def create_finalclass_figures(slides_dir: str | Path, patch_csv: str | Path | None = None) -> list[Path]:
    """All 8 final-class assets (create_finalclass_figures.py:536-565)."""
    slides_dir = Path(slides_dir)
    selected, baseline = _best_payloads(slides_dir)
    outs = [
        _fig_pipeline(slides_dir / "FINAL1_PIPELINE_BARS.png"),
        _fig_model3_vs_model4(selected, baseline, slides_dir / "FINAL2_MODEL3_VS_MODEL4.png"),
        _fig_coeffs_comparison(selected, baseline, slides_dir / "FINAL3_COEFFS_COMPARISON.png"),
        _fig_pipeline(slides_dir / "FINAL1_PIPELINE_DASH.png", dash=True),
        _fig_model3_vs_model4(selected, baseline, slides_dir / "FINAL2_MODEL3_VS_MODEL4_DASH.png", dash=True),
        _fig_coeffs_comparison(selected, baseline, slides_dir / "FINAL3_COEFFS_DASH.png", dash=True),
    ]
    if patch_csv and Path(patch_csv).exists():
        outs.append(_fig_patch_diagnostics(patch_csv, slides_dir / "FINAL4_PATCH_DIAGNOSTICS.png"))
        outs.append(_fig_patch_diagnostics(patch_csv, slides_dir / "FINAL4_PATCH_DASH.png", dash=True))
    return outs


# --------------------------------------------------------------------------
# presentation suite (generate_presentation_figures.py parity, 6 assets)
# --------------------------------------------------------------------------

def presentation_flow_data(U: np.ndarray, device: str | torch.device | None = None) -> dict[str, np.ndarray]:
    """The device work of fig2 and fig3 (``pdx``: comparative.py:657-693).

    ``U``: the normalised host frames (T >= 2, H, W). On ``device`` (the
    CUDA card by default): the first ``n = min(3, T)`` frames in float32,
    shrunk to half size by ``resize_area``; the Farnebäck flow of each pair
    (i-1, i), all pairs as one batch; frame i warped back onto frame i-1
    (reflect border). ``pdx`` computes the flow of the pair (0, 1) a second
    time for the quiver; here it is the first pair's. Returns host arrays:
    ``small`` (n, H/2, W/2), ``before`` and ``after`` (n-1, H/2, W/2), the
    |diff| to the previous frame before and after registration, and ``fx``,
    ``fy`` (H/2, W/2), the flow of the pair (0, 1)."""
    from pdx_torch import resolve_device
    from pdx_torch.ops.interp import resize_area, warp_flow
    from pdx_torch.register.farneback import farneback_flow

    if U.shape[0] < 2:
        raise ValueError(f"the motion figures need at least two frames, got {U.shape[0]}")
    dev = resolve_device(device)
    n = min(3, U.shape[0])
    frames = torch.as_tensor(np.asarray(U[:n]), dtype=torch.float32).to(dev)
    small = resize_area(frames, U.shape[1] // 2, U.shape[2] // 2)
    fx, fy = farneback_flow(small[:-1], small[1:])
    reg = warp_flow(small[1:], fx, fy, border="reflect")
    host = {
        "small": small,
        "before": torch.abs(small[1:] - small[:-1]),
        "after": torch.abs(reg - small[:-1]),
        "fx": fx[0],
        "fy": fy[0],
    }
    return {k: v.cpu().numpy() for k, v in host.items()}


def generate_presentation_figures(
    slides_dir: str | Path,
    data_dir: str | Path | None = None,
    patch_report: str | Path | None = None,
    device: str | torch.device | None = None,
) -> list[Path]:
    """fig1..fig6 (generate_presentation_figures.py): data overview, motion
    comparison (registration before/after strip), velocity quiver, method
    comparison, coefficients, physics schematic. fig1-3 need the raw image
    folder; they are skipped (not an error) when data_dir is unavailable.
    Their flows run first, on ``device`` (the CUDA card by default), by
    :func:`presentation_flow_data`; the drawing follows."""
    slides_dir = Path(slides_dir)
    outs: list[Path] = []

    flow = None
    if data_dir is not None and Path(data_dir).exists():
        from pdx_torch.io_host.images import load_images

        U = load_images(data_dir, max_images=5)
        U = U / (U.max() + 1e-12)
        flow = presentation_flow_data(U, device)

    best_p = slides_dir / "best_model.json"
    best = _read_json(best_p) if best_p.exists() else None
    if flow is None and best is None:
        return outs
    plt = _pyplot()

    if flow is not None:
        # fig1: data overview strip
        fig, axes = plt.subplots(1, min(5, U.shape[0]), figsize=(15, 3.2))
        for i, ax in enumerate(np.atleast_1d(axes)):
            ax.imshow(U[i], cmap="inferno")
            ax.set_title(f"frame {i}")
            ax.axis("off")
        fig.suptitle("Raw data overview")
        outs.append(_save(fig, slides_dir / "fig1_data_overview.png"))

        # fig2: registration before/after comparison strip
        small = flow["small"]
        n = small.shape[0]
        fig, axes = plt.subplots(3, n, figsize=(4 * n, 10))
        for i in range(n):
            axes[0, i].imshow(small[i], cmap="inferno")
            axes[0, i].set_title(f"raw frame {i}")
            if i > 0:
                axes[1, i].imshow(flow["before"][i - 1], cmap="magma")
                axes[1, i].set_title("|diff| before")
                axes[2, i].imshow(flow["after"][i - 1], cmap="magma")
                axes[2, i].set_title("|diff| after registration")
            else:
                axes[1, i].imshow(np.zeros_like(small[0]), cmap="magma")
                axes[2, i].imshow(np.zeros_like(small[0]), cmap="magma")
        for ax in axes.ravel():
            ax.axis("off")
        fig.suptitle("Motion: raw vs registered residuals")
        outs.append(_save(fig, slides_dir / "fig2_motion_comparison.png"))

        # fig3: velocity quiver from the first frame pair
        fx, fy = flow["fx"], flow["fy"]
        step = max(1, fx.shape[0] // 24)
        Y, X = np.mgrid[0 : fx.shape[0] : step, 0 : fx.shape[1] : step]
        fig, ax = plt.subplots(figsize=(9, 6))
        ax.imshow(small[0], cmap="gray", alpha=0.7)
        ax.quiver(X, Y, fy[::step, ::step], fx[::step, ::step], color="red", scale=40)
        ax.set_title("Optical-flow velocity field (frame 0 → 1)")
        ax.axis("off")
        outs.append(_save(fig, slides_dir / "fig3_velocity_field.png"))

    if best is not None:
        # fig4: method comparison (global model vs patch ensemble)
        patch_metrics = _parse_patch_report(patch_report) if patch_report else None
        fig, ax = plt.subplots(figsize=(8, 4.5))
        labels = [f"global ({_model_id(best.get('name', ''))})"]
        r2s = [float(best.get("r2", np.nan))]
        ones = [float(best.get("one_step_rmse", np.nan))]
        if patch_metrics:
            labels.append("patch ensemble")
            r2s.append(patch_metrics.get("r2", np.nan))
            ones.append(patch_metrics.get("one_step_rmse", np.nan))
        x = np.arange(len(labels))
        ax.bar(x - 0.18, r2s, width=0.36, color=PALETTE[0], label="test R² (↑)")
        ax.bar(x + 0.18, ones, width=0.36, color=PALETTE[1], label="one-step RMSE (↓)")
        ax.set_xticks(x)
        ax.set_xticklabels(labels)
        ax.legend()
        ax.set_title("Method comparison")
        outs.append(_save(fig, slides_dir / "fig4_method_comparison.png"))

        # fig5: coefficients of the selected model
        terms = best.get("terms", [])
        coeffs = np.asarray(best.get("coeffs", []), dtype=float)
        fig, ax = plt.subplots(figsize=(9, 4.5))
        colors = [PALETTE[0] if abs(c) > 1e-5 else "lightgray" for c in coeffs]
        ax.bar(range(len(terms)), coeffs, color=colors, edgecolor="black")
        ax.set_xticks(range(len(terms)))
        ax.set_xticklabels(terms, rotation=45, ha="right", fontsize=9)
        ax.axhline(0, color="black", linewidth=0.8)
        ax.set_title(f"Discovered PDE: {best.get('equation', '')}", fontsize=10)
        outs.append(_save(fig, slides_dir / "fig5_pde_coefficients.png"))

        # fig6: physics schematic
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.axis("off")
        ax.text(0.5, 0.85, "u_t = Θ(u) ξ", ha="center", fontsize=22, fontweight="bold")
        ax.text(0.5, 0.62, "Θ(u): candidate terms [1, u, u_x, u_y, ∇²u, u², u·∇u, ...]",
                ha="center", fontsize=13)
        ax.text(0.5, 0.45, "sparse ξ from STRidge: threshold |ξ| < τ, refit on support",
                ha="center", fontsize=13)
        ax.text(0.5, 0.28, f"selected: {best.get('equation', '')}", ha="center", fontsize=12,
                color=PALETTE[3])
        ax.text(0.5, 0.10, "validated by one-step prediction + k-step rollout stability",
                ha="center", fontsize=12)
        outs.append(_save(fig, slides_dir / "fig6_physics_schematic.png"))

    return outs


def _parse_patch_report(path: str | Path) -> dict | None:
    p = Path(path)
    if not p.exists():
        return None
    metrics: dict[str, float] = {}
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        for key, tag in [("r2", "R²="), ("rmse", "RMSE="), ("nrmse", "nRMSE="), ("corr", "corr=")]:
            if line.startswith(tag):
                try:
                    metrics[key] = float(line.split("=")[1])
                except ValueError:
                    pass
        if "one-step RMSE" in line and "=" in line:
            try:
                metrics["one_step_rmse"] = float(line.split("=")[-1])
            except ValueError:
                pass
    return metrics or None
