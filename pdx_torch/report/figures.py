"""Figure and slide generators of the artifact contract (port of
``pdx/report/figures.py``): MODEL_COMPARISON.png, the minimal deck
(FIG1-3 and the reference's FIG_DATA_FRAMES / FIG_BEST_MODEL_COEFFS), the
summary and method slides, the final-report figures, and FIG4's qualitative
rollout snapshots. All but FIG4 read only the artifact files
(best_model.json, models_comparison.json) and raise the reference's "run
analyze first" contract message without them (create_method_slide.py:33-39).

``pdx``'s ``qualitative_rollout_snapshots`` computes and draws in one call;
here it is the composition of two: :func:`fig4_snapshot_data` runs the
rollouts and the error maps on the stack's device and returns host arrays,
and :func:`draw_fig4_snapshots` only draws them, so ``analyze`` keeps device
faults out of the guard it puts around the drawing. matplotlib is imported
by the drawing functions alone, so this module imports without it; without
it they raise ``ImportError``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import Tensor

from pdx_torch.report.pipeline_figures import _pyplot
from pdx_torch.report.render_cache import cached_render
from pdx_torch.validate.rollout import ANALYZE13, fig4_rollout_bundle


class NothingToDraw(RuntimeError):
    """FIG4 lacks Model 3 or Model 4 or a valid horizon: no figure, as in
    ``pdx``, which skips it."""


def _load_contract(slides_dir: Path) -> tuple[dict, dict]:
    best_path = slides_dir / "best_model.json"
    comp_path = slides_dir / "models_comparison.json"
    if not best_path.exists() or not comp_path.exists():
        raise FileNotFoundError(
            f"Missing {best_path.name}/{comp_path.name} in {slides_dir} — run `pdx_torch analyze` first"
        )
    return json.loads(best_path.read_text()), json.loads(comp_path.read_text())


def model_comparison_figure(slides_dir: str | Path, out_name: str = "MODEL_COMPARISON.png") -> Path:
    """2x3 grid of per-model coefficient bar charts (analyze_results.py:716-735)."""
    slides_dir = Path(slides_dir)
    _best, comp = _load_contract(slides_dir)
    models = comp["models"]
    out = slides_dir / out_name

    def _render() -> None:
        plt = _pyplot()
        fig, axes = plt.subplots(2, 3, figsize=(20, 12))
        axes = axes.ravel()
        for idx, m in enumerate(models[:6]):
            ax = axes[idx]
            coeffs = np.asarray(m["coeffs"], dtype=float)
            colors = ["red" if abs(c) > 1e-5 else "lightgray" for c in coeffs]
            ax.bar(range(len(coeffs)), coeffs, color=colors, edgecolor="black")
            ax.set_xticks(range(len(m["terms"])))
            ax.set_xticklabels(m["terms"], fontsize=9, rotation=45, ha="right")
            ax.set_ylabel("Coefficient", fontsize=10, fontweight="bold")
            ax.set_title(
                f"{m['name']}\nR2 = {m['r2_test']:.4f}, Active: {m['n_active']}/{m['n_total']}",
                fontsize=11,
                fontweight="bold",
            )
            ax.grid(True, alpha=0.3, axis="y")
            ax.axhline(0, color="black", linewidth=1)
        plt.tight_layout()
        plt.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)

    cached_render("model_comparison", [json.dumps({"models": models[:6]}, sort_keys=True).encode()], [out], _render)
    return out


def _fig4_err_maps(u: Tensor, snap: Tensor, *, t_start: int, ks: tuple) -> Tensor:
    """(2, len(ks), H, W) float32 |error| maps at the FIG4 horizons, on
    the stack's device; the host reads only these."""
    gt = u[torch.as_tensor([t_start + k for k in ks], device=u.device)]  # (n, H, W)
    sel = snap[:, torch.as_tensor([k - 1 for k in ks], device=u.device)]  # (2, n, H, W)
    return torch.abs(gt[None] - sel).to(torch.float32)


def fig4_snapshot_data(
    u: Tensor, results: list[dict], test_start: int, test_stop: int, dt: float, dx: float, dy: float,
    k_default: int = 10,
) -> dict:
    """The rollouts of FIG4 (analyze_results.py:1104-1230) for Models 4
    and 3: |predicted - actual| maps at horizons k in {5..9, k_default}
    rolled out from the test-split start, the nRMSE-vs-k curves over the
    test split, and the shared 1-99 percentile colour range. Raises
    :class:`NothingToDraw` where ``pdx`` skips the figure."""
    r3 = next((r for r in results if str(r.get("name", "")).startswith("Model 3")), None)
    r4 = next((r for r in results if str(r.get("name", "")).startswith("Model 4")), None)
    if r3 is None or r4 is None:
        raise NothingToDraw("FIG4 needs Model 3 and Model 4 results")

    T = int(u.shape[0])
    k_snaps = list(range(5, 10))
    if int(k_default) not in k_snaps:
        k_snaps.append(int(k_default))
    k_snaps = sorted(k for k in {int(k) for k in k_snaps} if 0 < k < T)
    if not k_snaps:
        raise NothingToDraw("no valid horizons for the qualitative snapshot")
    k_max = max(k_snaps)

    dense = np.zeros((2, len(ANALYZE13)))
    for mi, r in enumerate((r4, r3)):
        for n, c in zip(r["names"], np.asarray(r["coeffs"], dtype=float)):
            dense[mi, ANALYZE13.index(n)] = c
    t_start = max(0, min(int(test_start), T - k_max - 1))
    snap, curves = fig4_rollout_bundle(
        u, torch.as_tensor(dense, dtype=u.dtype, device=u.device), dt, dx, dy,
        k_max=k_max, t_start=t_start, t0=int(test_start), t1=int(test_stop),
    )
    ks_valid = tuple(k for k in k_snaps if t_start + k < T)
    if not ks_valid:
        raise NothingToDraw("no valid horizons for the qualitative snapshot")
    maps = _fig4_err_maps(u, snap, t_start=t_start, ks=ks_valid).cpu().numpy()
    curve4, curve3 = curves.cpu().numpy().astype(np.float64)

    finite = np.isfinite(maps)
    if finite.any():
        vals = maps[finite]
        vmin, vmax = np.percentile(vals, [1, 99])
        if not np.isfinite(vmin) or not np.isfinite(vmax) or abs(vmax - vmin) < 1e-12:
            vmin, vmax = float(vals.min()), float(vals.max())
    else:
        vmin = vmax = None
    return {"maps": maps, "ks": ks_valid, "curve4": curve4, "curve3": curve3, "vmin": vmin, "vmax": vmax}


def draw_fig4_snapshots(slides_dir: str | Path, data: dict) -> list[Path]:
    """FIG4_QUAL_ROLLOUT_K*.png (M4 and M3 error maps) and
    FIG4B_ERROR_GROWTH_PLUS_MAP_K*.png (the nRMSE curves with the M4 map)
    from :func:`fig4_snapshot_data`'s arrays."""
    slides_dir = Path(slides_dir)
    maps, ks_valid, vmin, vmax = data["maps"], data["ks"], data["vmin"], data["vmax"]
    curve4_full, curve3_full = data["curve4"], data["curve3"]
    err_maps = {k: (maps[0, i], maps[1, i]) for i, k in enumerate(ks_valid)}
    outs: list[Path] = []
    for k in sorted(err_maps):
        outs.append(slides_dir / f"FIG4_QUAL_ROLLOUT_K{k}.png")
        outs.append(slides_dir / f"FIG4B_ERROR_GROWTH_PLUS_MAP_K{k}.png")

    def _render() -> None:
        plt = _pyplot()
        for k in sorted(err_maps):
            err4, err3 = err_maps[k]

            fig, axes = plt.subplots(1, 2, figsize=(9.0, 4.0))
            for ax in axes:
                ax.set_xticks([])
                ax.set_yticks([])
            im0 = axes[0].imshow(err4, cmap="magma", vmin=vmin, vmax=vmax)
            axes[0].set_title(f"M4 |error| (k={k})")
            axes[1].imshow(err3, cmap="magma", vmin=vmin, vmax=vmax)
            axes[1].set_title(f"M3 |error| (k={k})")
            fig.colorbar(im0, ax=axes, fraction=0.046, pad=0.04)
            plt.savefig(slides_dir / f"FIG4_QUAL_ROLLOUT_K{k}.png", dpi=150, bbox_inches="tight")
            plt.close(fig)

            ks = list(range(1, k + 1))
            fig2, axes2 = plt.subplots(1, 2, figsize=(11.0, 4.0))
            axes2[0].plot(ks, curve4_full[:k], marker="o", linewidth=2.0, label="M4")
            axes2[0].plot(ks, curve3_full[:k], marker="o", linewidth=2.0, label="M3")
            axes2[0].set_yscale("log")
            axes2[0].set_xlabel("Horizon k")
            axes2[0].set_ylabel("Rollout nRMSE (lower is better)")
            axes2[0].set_title("Rollout error growth over horizon k")
            axes2[0].grid(True, alpha=0.25)
            axes2[0].legend(frameon=False, ncol=2)
            im = axes2[1].imshow(err4, cmap="magma", vmin=vmin, vmax=vmax)
            axes2[1].set_xticks([])
            axes2[1].set_yticks([])
            axes2[1].set_title(f"M4 |error| at k={k}")
            fig2.colorbar(im, ax=axes2[1], fraction=0.046, pad=0.04)
            plt.savefig(slides_dir / f"FIG4B_ERROR_GROWTH_PLUS_MAP_K{k}.png", dpi=150, bbox_inches="tight")
            plt.close(fig2)

    cached_render("fig4_snapshots", [maps, curve4_full, curve3_full, ks_valid, (vmin, vmax)], outs, _render)
    return outs


def qualitative_rollout_snapshots(
    slides_dir: str | Path,
    u,
    results: list[dict],
    test_start: int,
    test_stop: int,
    dt: float,
    dx: float,
    dy: float,
    k_default: int = 10,
) -> list[Path]:
    """FIG4 qualitative rollout snapshots (analyze_results.py:1104-1230),
    ``pdx``'s signature: :func:`fig4_snapshot_data` on ``u``'s device (a
    numpy array runs on the CPU), then :func:`draw_fig4_snapshots`."""
    data = fig4_snapshot_data(torch.as_tensor(u), results, test_start, test_stop, dt, dx, dy, k_default)
    return draw_fig4_snapshots(slides_dir, data)


def generate_presentation_figures_minimal(
    slides_dir: str | Path, data_dir: str | Path | None = None
) -> list[Path]:
    """FIG1 (model R2/rollout comparison), FIG2 (rollout error growth),
    FIG3 (best-model coefficients) — the minimal deck assets — plus the
    reference's exact asset names FIG_DATA_FRAMES.png (3 raw frames, needs
    ``data_dir``) and FIG_BEST_MODEL_COEFFS.png
    (generate_presentation_figures_minimal.py:86,152)."""
    slides_dir = Path(slides_dir)
    best, comp = _load_contract(slides_dir)
    plt = _pyplot()
    outs = []

    # FIG_DATA_FRAMES: first/middle/last raw frames (reference :40-87)
    if data_dir is not None:
        fig = None
        try:
            from pdx_torch.io_host.images import load_images

            U = load_images(data_dir, max_images=51)
            idxs = [0, U.shape[0] // 2, U.shape[0] - 1]
            fig, axes = plt.subplots(1, 3, figsize=(13, 4.5))
            for ax, i in zip(axes, idxs):
                ax.imshow(U[i], cmap="gray")
                ax.set_title(f"Frame {i}", fontsize=12, fontweight="bold")
                ax.axis("off")
            fig.suptitle("Raw laser-matter frames", fontsize=14, fontweight="bold")
            plt.tight_layout()
            p = slides_dir / "FIG_DATA_FRAMES.png"
            plt.savefig(p, dpi=150, bbox_inches="tight")
            outs.append(p)
        except Exception as e:
            # skip-and-continue parity with the reference: a bad data dir or
            # an undecodable frame must not abort the artifact-only assets,
            # but say so instead of hiding it
            import warnings

            warnings.warn(f"FIG_DATA_FRAMES skipped: {type(e).__name__}: {e}")
        finally:
            if fig is not None:
                plt.close(fig)

    # FIG1: model comparison (R2 + rollout nRMSE)
    models = comp["models"]
    names = [m["name"].split(":")[0] for m in models]
    r2s = [m["r2_test"] for m in models]
    ks = comp.get("rollout_steps", [])
    k_eval = ks[-1] if ks else None
    rolls = [(m.get("rollout", {}).get("test", {}) or {}).get("nrmse", np.nan) for m in models]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 4.5))
    ax1.bar(names, r2s, color="#2a6fdb", edgecolor="black")
    ax1.set_ylabel("Test R²")
    ax1.set_title("Fit quality")
    ax1.tick_params(axis="x", rotation=30)
    ax2.bar(names, rolls, color="#d9534f", edgecolor="black")
    ax2.set_ylabel(f"Rollout nRMSE (k={k_eval})")
    ax2.set_title("Dynamical stability (lower is better)")
    ax2.tick_params(axis="x", rotation=30)
    plt.tight_layout()
    p = slides_dir / "FIG1_MODEL_COMPARISON.png"
    plt.savefig(p, dpi=150, bbox_inches="tight")
    plt.close(fig)
    outs.append(p)

    # FIG2: rollout error growth curves
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for m in models:
        curve = m.get("rollout_curve_test", {}).get("metrics", {})
        if not curve:
            continue
        steps = sorted(int(k) for k in curve.keys())
        vals = [curve[str(k)].get("nrmse", np.nan) for k in steps]
        ax.plot(steps, vals, marker="o", label=m["name"].split(":")[0])
    ax.set_yscale("log")
    ax.set_xlabel("Horizon k")
    ax.set_ylabel("Rollout nRMSE")
    ax.set_title("Rollout error growth over horizon k")
    ax.grid(True, alpha=0.25)
    ax.legend(frameon=False, fontsize=8)
    plt.tight_layout()
    p = slides_dir / "FIG2_ROLLOUT_CURVES.png"
    plt.savefig(p, dpi=150, bbox_inches="tight")
    plt.close(fig)
    outs.append(p)

    # FIG3: best-model coefficients (also saved under the reference's
    # FIG_BEST_MODEL_COEFFS.png name for listing parity)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    coeffs = np.asarray(best["coeffs"], dtype=float)
    ax.bar(best["terms"], coeffs, color="#2aa84a", edgecolor="black")
    ax.axhline(0, color="black", linewidth=1)
    ax.set_title(f"{best['name']}\n{best['equation']}")
    ax.tick_params(axis="x", rotation=30)
    plt.tight_layout()
    for name in ("FIG3_BEST_MODEL.png", "FIG_BEST_MODEL_COEFFS.png"):
        p = slides_dir / name
        plt.savefig(p, dpi=150, bbox_inches="tight")
        outs.append(p)
    plt.close(fig)

    outs.append(model_comparison_figure(slides_dir))
    return outs


def create_simple_slide3(slides_dir: str | Path) -> Path:
    """Summary slide: equation + headline metrics (create_simple_slide3.py),
    as SLIDE3_RESULTS.png, SLIDE3_SIMPLE_PDE_Results.png and
    SLIDE3_MINIMAL_PDE_Results.png (:157,176)."""
    slides_dir = Path(slides_dir)
    best, _comp = _load_contract(slides_dir)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 6.5))
    ax.axis("off")
    ax.text(0.5, 0.85, "Discovered PDE", ha="center", fontsize=22, fontweight="bold")
    ax.text(0.5, 0.68, best["equation"], ha="center", fontsize=15, family="monospace",
            bbox=dict(boxstyle="round", facecolor="#eef4ff"))
    rows = [
        ("Model", best["name"]),
        ("Test R²", f"{best['r2']:.4f}"),
        ("Test RMSE", f"{best['rmse']:.4f}"),
        ("nRMSE", f"{best['nrmse']:.3f}"),
        ("Correlation", f"{best['corr']:.3f}"),
        ("One-step RMSE", f"{best['one_step_rmse']:.4f}"),
        ("Active terms", f"{best['n_active']}/{best['n_total']}"),
    ]
    for i, (k, v) in enumerate(rows):
        ax.text(0.3, 0.52 - 0.06 * i, k, ha="right", fontsize=12, fontweight="bold")
        ax.text(0.33, 0.52 - 0.06 * i, str(v), ha="left", fontsize=12)
    out = slides_dir / "SLIDE3_RESULTS.png"
    for name in ("SLIDE3_RESULTS.png", "SLIDE3_SIMPLE_PDE_Results.png"):
        plt.savefig(slides_dir / name, dpi=150, bbox_inches="tight")
    plt.close(fig)

    fig2, ax2 = plt.subplots(figsize=(12, 6.5))
    ax2.axis("off")
    ax2.text(0.5, 0.70, "Discovered PDE (best model)", ha="center", fontsize=24,
             fontweight="bold", transform=ax2.transAxes)
    ax2.text(0.5, 0.48, best["equation"], ha="center", fontsize=16,
             family="monospace", transform=ax2.transAxes)
    sp = (best.get("spatial_holdout") or {}).get("test") or {}
    sp_tb = (best.get("spatial_holdout_top_bottom") or {}).get("test") or {}
    ax2.text(
        0.5, 0.18,
        f"time R²={best['r2']:.3f}  |  space R² LR/TB="
        f"{sp.get('r2', float('nan')):.3f}/{sp_tb.get('r2', float('nan')):.3f}",
        ha="center", fontsize=13, color="#333333", transform=ax2.transAxes,
    )
    plt.savefig(slides_dir / "SLIDE3_MINIMAL_PDE_Results.png", dpi=150, bbox_inches="tight")
    plt.close(fig2)
    return out


def create_method_slide(slides_dir: str | Path) -> Path:
    """Pipeline-methodology slide (create_method_slide.py), as
    SLIDE_METHOD.png and the reference's SLIDE_METHOD_PIPELINE.png."""
    slides_dir = Path(slides_dir)
    best, _comp = _load_contract(slides_dir)
    plt = _pyplot()
    stages = [
        "TIFF frames",
        "Downsample +\nGaussian denoise",
        "Optical-flow\nregistration",
        "Derivatives +\nterm library Θ(u)",
        "STRidge sparse\nregression",
        "Rollout / holdout\nvalidation",
    ]
    fig, ax = plt.subplots(figsize=(13, 4.5))
    ax.axis("off")
    n = len(stages)
    for i, s in enumerate(stages):
        x = (i + 0.5) / n
        ax.text(x, 0.6, s, ha="center", va="center", fontsize=11,
                bbox=dict(boxstyle="round,pad=0.6", facecolor="#e8f0e8", edgecolor="black"))
        if i < n - 1:
            ax.annotate("", xy=((i + 1.07) / n, 0.6), xytext=((i + 0.93) / n, 0.6),
                        arrowprops=dict(arrowstyle="->", lw=1.5))
    ax.text(0.5, 0.15, f"Selected: {best['name']}   |   {best['equation']}", ha="center",
            fontsize=11, family="monospace")
    ax.set_title("PDE discovery methodology", fontsize=16, fontweight="bold")
    out = slides_dir / "SLIDE_METHOD.png"
    for name in ("SLIDE_METHOD.png", "SLIDE_METHOD_PIPELINE.png"):
        plt.savefig(slides_dir / name, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def create_final_figures(slides_dir: str | Path) -> list[Path]:
    """Final-report figures: the coefficient heatmap across models
    (FINAL_COEFF_MATRIX.png) and the test-metric table
    (FINAL_METRICS_TABLE.png)."""
    slides_dir = Path(slides_dir)
    _best, comp = _load_contract(slides_dir)
    plt = _pyplot()
    models = comp["models"]
    outs = []

    all_terms = sorted({t for m in models for t in m["terms"]})
    M = np.zeros((len(models), len(all_terms)))
    for i, m in enumerate(models):
        for t, c in zip(m["terms"], m["coeffs"]):
            M[i, all_terms.index(t)] = c
    fig, ax = plt.subplots(figsize=(12, 5))
    vmax = np.abs(M).max() + 1e-12
    im = ax.imshow(M, cmap="RdBu_r", vmin=-vmax, vmax=vmax, aspect="auto")
    ax.set_xticks(range(len(all_terms)))
    ax.set_xticklabels(all_terms, rotation=45, ha="right")
    ax.set_yticks(range(len(models)))
    ax.set_yticklabels([m["name"].split(":")[0] for m in models])
    fig.colorbar(im, ax=ax, label="coefficient")
    ax.set_title("Coefficients across model families")
    plt.tight_layout()
    p = slides_dir / "FINAL_COEFF_MATRIX.png"
    plt.savefig(p, dpi=150, bbox_inches="tight")
    plt.close(fig)
    outs.append(p)

    fig, ax = plt.subplots(figsize=(12, 3.5))
    ax.axis("off")
    cols = ["Model", "R²", "RMSE", "nRMSE", "corr", "one-step", "active"]
    cells = [
        [
            m["name"].split(":")[0],
            f"{m['r2_test']:.4f}",
            f"{m['rmse_test']:.5f}",
            f"{m['nrmse_test']:.3f}",
            f"{m['corr_test']:.3f}",
            f"{m['one_step_rmse']:.5f}",
            f"{m['n_active']}/{m['n_total']}",
        ]
        for m in models
    ]
    table = ax.table(cellText=cells, colLabels=cols, loc="center")
    table.auto_set_font_size(False)
    table.set_fontsize(9)
    table.scale(1.0, 1.4)
    ax.set_title("Model comparison (test)", fontweight="bold")
    p = slides_dir / "FINAL_METRICS_TABLE.png"
    plt.savefig(p, dpi=150, bbox_inches="tight")
    plt.close(fig)
    outs.append(p)
    return outs
