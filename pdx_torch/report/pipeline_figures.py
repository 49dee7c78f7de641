"""Pipeline figures drawn on the host with matplotlib (port of
``pdx/report/pipeline_figures.py:276-320``): PATCH_PDE_SUMMARY.png of the
patch discovery (patch_based_pde_discovery.py:564-565), from small numpy
arrays already on the host, at 150 dpi."""

from __future__ import annotations

from pathlib import Path

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt


def _save(fig, path: Path) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def patch_pde_summary(
    out_dir: Path, names, stats: dict, m_test: dict, one_step_rmse: float,
    stability_freq: float,
) -> Path:
    """PATCH_PDE_SUMMARY.png: median±IQR coefficient bars + stability panel
    (patch_based_pde_discovery.py:534-565)."""
    median = np.asarray(stats["median"], dtype=float)
    q25 = np.asarray(stats["q25"], dtype=float)
    q75 = np.asarray(stats["q75"], dtype=float)
    freq = np.asarray(stats["freq"], dtype=float)
    sign_stability = np.asarray(stats["sign_stability"], dtype=float)
    x = np.arange(len(names))

    fig = plt.figure(figsize=(14, 6.5))
    ax1 = plt.subplot(1, 2, 1)
    ax1.bar(x, median, color="#2a6fdb", alpha=0.85, edgecolor="black", linewidth=1)
    ax1.errorbar(x, median, yerr=[median - q25, q75 - median], fmt="none",
                 ecolor="black", capsize=3, linewidth=1)
    ax1.axhline(0, color="black", linewidth=1)
    ax1.set_xticks(x)
    ax1.set_xticklabels(names, rotation=35, ha="right")
    ax1.set_title("Patch coefficients (median ± IQR)")
    ax1.set_ylabel("Coefficient")
    ax1.grid(True, alpha=0.3)

    ax2 = plt.subplot(1, 2, 2)
    ax2.bar(x, freq, color="#2aa84a", alpha=0.85, edgecolor="black", linewidth=1)
    ax2.plot(x, sign_stability, color="#1f3d7a", marker="o", linewidth=1.5,
             label="sign stability")
    ax2.axhline(float(stability_freq), color="black", linestyle="--", linewidth=1)
    ax2.set_xticks(x)
    ax2.set_xticklabels(names, rotation=35, ha="right")
    ax2.set_ylim(0, 1)
    ax2.set_title("Stability across patches")
    ax2.set_ylabel("frequency")
    ax2.legend(frameon=False, loc="lower right")
    ax2.grid(True, alpha=0.3)

    fig.suptitle(
        f"Patch-based PDE (test)  R²={m_test['r2']:.2f}  nRMSE={m_test['nrmse']:.2f}  "
        f"one-step RMSE={one_step_rmse:.3f}",
        fontsize=12, fontweight="bold",
    )
    plt.tight_layout(rect=[0, 0, 1, 0.93])
    return _save(fig, Path(out_dir) / "PATCH_PDE_SUMMARY.png")
