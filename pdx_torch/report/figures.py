"""Figures of the ``analyze`` pipeline (port of ``pdx/report/figures.py:27-75,
265-416``): MODEL_COMPARISON.png from the artifact contract, and FIG4's
qualitative rollout snapshots.

``pdx``'s ``qualitative_rollout_snapshots`` computes and draws in one call;
here it is two: :func:`fig4_snapshot_data` runs the rollouts and the error
maps on the stack's device and returns host arrays, and
:func:`draw_fig4_snapshots` only draws them, so ``analyze`` keeps device
faults out of the guard it puts around the drawing. matplotlib is imported
by the drawing functions alone, so this module imports without it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import Tensor

from pdx_torch.report.render_cache import cached_render
from pdx_torch.validate.rollout import ANALYZE13, fig4_rollout_bundle


class NothingToDraw(RuntimeError):
    """FIG4 lacks Model 3 or Model 4 or a valid horizon: no figure, as in
    ``pdx``, which skips it."""


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


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
