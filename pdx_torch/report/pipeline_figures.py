"""Pipeline figures drawn on the host with matplotlib (port of
``pdx/report/pipeline_figures.py:40-398``), from small numpy arrays already on
the host, at 150 dpi:

  * SLIDE1-4            pde_discovery_improved_registration.py:254,347,532,592
  * PATCH_PDE_SUMMARY   patch_based_pde_discovery.py:564-565
  * patch_based_sindy_results.png  patch_based_sindy.py:641-642 (:525-572)

matplotlib is imported by the drawing functions alone, so this module (and
:func:`patch_sindy_figure_frame_indices`, which the pipeline needs for its
device work) imports without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path: Path) -> Path:
    plt = _pyplot()
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# improved-registration SLIDE1-4
# ---------------------------------------------------------------------------


def slide1_registration_quality(
    out_dir: Path, U_norm, U_fb, U_dis, m_fb: dict, m_dis: dict, frame_idx: int | None = None
) -> Path:
    """SLIDE1: 2x4 unregistered/registered frames + interframe |diff| maps
    (pde_discovery_improved_registration.py:193-254)."""
    plt = _pyplot()
    T = U_norm.shape[0]
    fi = min(15, T - 2) if frame_idx is None else frame_idx
    ni = fi + 1
    fig = plt.figure(figsize=(20, 11))
    gs = fig.add_gridspec(2, 4, hspace=0.3, wspace=0.2)

    rows = (("Farnebäck", U_fb), ("DIS", U_dis))
    for r, (name, U_reg) in enumerate(rows):
        ax = fig.add_subplot(gs[r, 0])
        ax.imshow(U_norm[fi], cmap="gray")
        ax.set_title(f"Unregistered\nFrame {fi}", fontsize=14, fontweight="bold")
        ax.axis("off")
        ax = fig.add_subplot(gs[r, 1])
        ax.imshow(U_reg[fi], cmap="gray")
        ax.set_title(f"{name} Registered\nFrame {fi}", fontsize=14, fontweight="bold")
        ax.axis("off")
        ax = fig.add_subplot(gs[r, 2])
        im = ax.imshow(np.abs(U_norm[ni] - U_norm[fi]), cmap="hot", vmin=0, vmax=0.3)
        ax.set_title(f"Difference (Unregistered)\nFrames {fi}→{ni}", fontsize=14, fontweight="bold")
        ax.axis("off")
        plt.colorbar(im, ax=ax, fraction=0.046)
        ax = fig.add_subplot(gs[r, 3])
        im = ax.imshow(np.abs(U_reg[ni] - U_reg[fi]), cmap="hot", vmin=0, vmax=0.3)
        ax.set_title(f"Difference ({name})\nFrames {fi}→{ni}", fontsize=14, fontweight="bold")
        ax.axis("off")
        plt.colorbar(im, ax=ax, fraction=0.046)

    fig.text(0.5, 0.95, "SLIDE 1: Registration Quality Comparison",
             ha="center", fontsize=18, fontweight="bold")
    fig.text(0.5, 0.52,
             f"Farnebäck: {m_fb['avg_flow_before']:.2f}→{m_fb['avg_flow_after']:.2f} px "
             f"({m_fb['improvement_pct']:.1f}% improvement)",
             ha="center", fontsize=13, fontweight="bold", color="darkblue")
    fig.text(0.5, 0.02,
             f"DIS Flow: {m_dis['avg_flow_before']:.2f}→{m_dis['avg_flow_after']:.2f} px "
             f"({m_dis['improvement_pct']:.1f}% improvement)",
             ha="center", fontsize=13, fontweight="bold", color="darkgreen")
    return _save(fig, Path(out_dir) / "SLIDE1_Registration_Quality_51images.png")


_PARAM_FB = """Farnebäck Parameters:
• pyr_scale = 0.5
• levels = 5
• winsize = 25
• poly_n = 7
• poly_sigma = 1.5
• Flow smoothing: σ=2.0"""

_PARAM_DIS = """DIS Parameters:
• Inverse-search patches
• Patch size: 8
• Patch stride: 4
• Fixed-point iterations
• Variational refinement
• Flow smoothing: σ=2.0"""


def slide2_flow_fields(
    out_dir: Path, U_norm, flow_fb, flow_dis, frame_idx: int | None = None
) -> Path:
    """SLIDE2: flow magnitude map + quiver + histogram per method
    (pde_discovery_improved_registration.py:260-347). ``flow_*`` are
    (2, H, W) = (flow_r, flow_c) arrays for the rendered frame pair."""
    plt = _pyplot()
    T, H, W = U_norm.shape
    fi = min(15, T - 2) if frame_idx is None else frame_idx
    fig = plt.figure(figsize=(20, 11))
    gs = fig.add_gridspec(2, 3, hspace=0.35, wspace=0.3)
    step = max(1, min(H, W) // 10)
    Y, X = np.mgrid[0:H:step, 0:W:step]

    rows = (
        ("Farnebäck", flow_fb, "Smoothed, σ=2.0", "winsize=25, levels=5", "blue", "cyan"),
        ("DIS", flow_dis, "Inverse Search", "Dense Inverse Search", "green", "lime"),
    )
    for r, (name, flow, sub1, sub2, hcolor, qcolor) in enumerate(rows):
        fr, fc = np.asarray(flow[0]), np.asarray(flow[1])
        mag = np.sqrt(fr**2 + fc**2)
        ax = fig.add_subplot(gs[r, 0])
        im = ax.imshow(mag, cmap="jet")
        ax.set_title(f"{name} Flow Magnitude\n({sub1})", fontsize=13, fontweight="bold")
        ax.axis("off")
        plt.colorbar(im, ax=ax, label="Pixels", fraction=0.046)

        ax = fig.add_subplot(gs[r, 1])
        ax.imshow(U_norm[fi], cmap="gray", alpha=0.6)
        # quiver x-component = column flow, y = row flow
        ax.quiver(X, Y, fc[::step, ::step], fr[::step, ::step],
                  color=qcolor, scale=200, width=0.003)
        ax.set_title(f"{name} Flow Vectors\n({sub2})", fontsize=13, fontweight="bold")
        ax.axis("off")

        ax = fig.add_subplot(gs[r, 2])
        ax.hist(mag.ravel(), bins=100, alpha=0.7, color=hcolor, edgecolor="black")
        ax.axvline(mag.mean(), color="red", linestyle="--", linewidth=2,
                   label=f"Mean = {mag.mean():.2f} px")
        ax.set_xlabel("Flow Magnitude (pixels)", fontsize=12, fontweight="bold")
        ax.set_ylabel("Frequency", fontsize=12, fontweight="bold")
        ax.set_title(f"{name} Flow Distribution", fontsize=13, fontweight="bold")
        ax.legend()
        ax.grid(True, alpha=0.3)

    fig.text(0.5, 0.96, "SLIDE 2: Flow Field Analysis and Parameters",
             ha="center", fontsize=18, fontweight="bold")
    fig.text(0.25, 0.02, _PARAM_FB, ha="center", fontsize=10, family="monospace",
             bbox=dict(boxstyle="round", facecolor="lightblue", alpha=0.8))
    fig.text(0.75, 0.02, _PARAM_DIS, ha="center", fontsize=10, family="monospace",
             bbox=dict(boxstyle="round", facecolor="lightgreen", alpha=0.8))
    return _save(fig, Path(out_dir) / "SLIDE2_Flow_Fields_51images.png")


def slide3_pde_results(
    out_dir: Path, coeffs, term_names, y, y_pred, r2: float,
    method_name: str, improvement_pct: float, working_shape, seed: int = 0,
) -> Path:
    """SLIDE3: coefficient bars + prediction scatter + residual histogram +
    equation box (pde_discovery_improved_registration.py:473-535)."""
    plt = _pyplot()
    coeffs = np.asarray(coeffs, dtype=float)
    y = np.asarray(y).ravel()
    y_pred = np.asarray(y_pred).ravel()
    mt, mh, mw = working_shape
    fig = plt.figure(figsize=(20, 11))
    gs = fig.add_gridspec(2, 3, hspace=0.4, wspace=0.3)

    ax1 = fig.add_subplot(gs[0, :])
    colors = ["red" if abs(c) > 1e-5 else "lightgray" for c in coeffs]
    ax1.bar(range(len(coeffs)), coeffs, color=colors, edgecolor="black", linewidth=1.5)
    ax1.set_xticks(range(len(term_names)))
    ax1.set_xticklabels(term_names, fontsize=12, fontweight="bold")
    ax1.set_ylabel("Coefficient Value", fontsize=13, fontweight="bold")
    ax1.set_title(f"Discovered PDE Coefficients (R² = {r2:.6f})", fontsize=15, fontweight="bold")
    ax1.grid(True, alpha=0.3, axis="y")
    ax1.axhline(y=0, color="black", linestyle="-", linewidth=1)

    rng = np.random.default_rng(seed)
    idx = rng.choice(len(y), size=min(10_000, len(y)), replace=False)
    ax2 = fig.add_subplot(gs[1, 0])
    ax2.scatter(y[idx], y_pred[idx], alpha=0.3, s=1)
    ax2.plot([y.min(), y.max()], [y.min(), y.max()], "r--", linewidth=2, label="Perfect fit")
    ax2.set_xlabel("Actual u_t", fontsize=12, fontweight="bold")
    ax2.set_ylabel("Predicted u_t", fontsize=12, fontweight="bold")
    ax2.set_title("Model Predictions", fontsize=13, fontweight="bold")
    ax2.legend()
    ax2.grid(True, alpha=0.3)

    resid = y - y_pred
    ax3 = fig.add_subplot(gs[1, 1])
    ax3.hist(resid, bins=100, alpha=0.7, color="purple", edgecolor="black")
    ax3.axvline(0, color="red", linestyle="--", linewidth=2, label=f"Mean = {resid.mean():.2e}")
    ax3.set_xlabel("Residual (u_t actual - predicted)", fontsize=12, fontweight="bold")
    ax3.set_ylabel("Frequency", fontsize=12, fontweight="bold")
    ax3.set_title("Residual Distribution", fontsize=13, fontweight="bold")
    ax3.legend()
    ax3.grid(True, alpha=0.3)

    eq_parts = []
    for c, n in zip(coeffs, term_names):
        if abs(c) > 1e-5:
            sgn = "+" if c > 0 and eq_parts else ""
            eq_parts.append(f"{sgn}{c:.6f}·{n}")
    equation = "u_t = " + " ".join(eq_parts) if eq_parts else "u_t = 0"
    txt = (
        f"Discovered PDE:\n\n{equation}\n\n"
        "Model Performance:\n"
        f"• R² Score: {r2:.6f}\n"
        f"• Active Terms: {int(np.sum(np.abs(coeffs) > 1e-5))}/{len(coeffs)}\n"
        f"• Registration: {method_name}\n"
        f"• Improvement: {improvement_pct:.1f}%\n"
        f"• Total Frames: {mt}\n"
        f"• Spatial Points: {mh}×{mw}"
    )
    ax4 = fig.add_subplot(gs[1, 2])
    ax4.axis("off")
    ax4.text(0.5, 0.5, txt, transform=ax4.transAxes, fontsize=11,
             verticalalignment="center", horizontalalignment="center", family="monospace",
             bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.8))
    fig.text(0.5, 0.96, "SLIDE 3: PDE Discovery Results (51 Images, 2nd Order)",
             ha="center", fontsize=18, fontweight="bold")
    return _save(fig, Path(out_dir) / "SLIDE3_PDE_Results_51images.png")


def slide4_spatiotemporal(out_dir: Path, U_reg, u_t, lap, u_x, u_y) -> Path:
    """SLIDE4: frame evolution + derivative fields + mean/variance series
    (pde_discovery_improved_registration.py:538-592)."""
    plt = _pyplot()
    U_reg = np.asarray(U_reg)
    T = U_reg.shape[0]
    mid = min(20, u_t.shape[0] - 1)
    fig = plt.figure(figsize=(20, 11))
    gs = fig.add_gridspec(3, 4, hspace=0.4, wspace=0.3)

    for idx, frac in enumerate((0.0, 0.2, 0.4, 0.6)):
        fi = min(int(frac * T), T - 1)
        ax = fig.add_subplot(gs[0, idx])
        ax.imshow(U_reg[fi], cmap="viridis")
        ax.set_title(f"Frame {fi}", fontsize=12, fontweight="bold")
        ax.axis("off")

    panels = (
        (u_t, "Temporal Derivative (u_t)", dict(cmap="RdBu_r", vmin=-0.1, vmax=0.1)),
        (lap, "Laplacian (∇²u)", dict(cmap="RdBu_r", vmin=-0.5, vmax=0.5)),
        (u_x, "Spatial Gradient (u_x)", dict(cmap="RdBu_r")),
        (u_y, "Spatial Gradient (u_y)", dict(cmap="RdBu_r")),
    )
    for idx, (field, title, kw) in enumerate(panels):
        ax = fig.add_subplot(gs[1, idx])
        ax.imshow(np.asarray(field)[mid], **kw)
        ax.set_title(f"{title}\nFrame {mid}", fontsize=12, fontweight="bold")
        ax.axis("off")

    ax = fig.add_subplot(gs[2, :2])
    ax.plot(U_reg.mean(axis=(1, 2)), linewidth=2, color="blue")
    ax.set_xlabel("Frame Number", fontsize=12, fontweight="bold")
    ax.set_ylabel("Mean Intensity", fontsize=12, fontweight="bold")
    ax.set_title(f"Mean Intensity Evolution ({T} Frames)", fontsize=13, fontweight="bold")
    ax.grid(True, alpha=0.3)
    ax = fig.add_subplot(gs[2, 2:])
    ax.plot(U_reg.var(axis=(1, 2)), linewidth=2, color="red")
    ax.set_xlabel("Frame Number", fontsize=12, fontweight="bold")
    ax.set_ylabel("Intensity Variance", fontsize=12, fontweight="bold")
    ax.set_title(f"Variance Evolution ({T} Frames)", fontsize=13, fontweight="bold")
    ax.grid(True, alpha=0.3)

    fig.text(0.5, 0.96, "SLIDE 4: Spatiotemporal Evolution and Derivatives",
             ha="center", fontsize=18, fontweight="bold")
    return _save(fig, Path(out_dir) / "SLIDE4_Spatiotemporal_51images.png")


# ---------------------------------------------------------------------------
# patch pipelines
# ---------------------------------------------------------------------------


def patch_pde_summary(
    out_dir: Path, names, stats: dict, m_test: dict, one_step_rmse: float,
    stability_freq: float,
) -> Path:
    """PATCH_PDE_SUMMARY.png: median±IQR coefficient bars + stability panel
    (patch_based_pde_discovery.py:534-565)."""
    plt = _pyplot()
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


def patch_sindy_figure_frame_indices(T: int) -> list[int]:
    """The 4 frame indices patch_sindy_results displays (3 samples + mid).

    The pipeline gathers only these frames on the device before the host
    read: the figure shows 4 frames of the stack."""
    return [min(i * max(1, T // 3), T - 1) for i in range(3)] + [T // 2]


def patch_sindy_results(
    out_dir: Path, images, coords, patch_size: int, coeffs, coeffs_std,
    term_names, n_patches: int, frame_indices: list[int] | None = None,
    full_shape: tuple[int, int] | None = None,
) -> Path:
    """patch_based_sindy_results.png: sample frames + patch grid overlay +
    active-term bars + uncertainty scatter (patch_based_sindy.py:525-572).

    ``images`` is either the full (T, H, W) stack, or — when
    ``frame_indices`` is given — just the 4 displayed frames
    (``patch_sindy_figure_frame_indices``) with their stack indices,
    possibly downsampled to display resolution (``full_shape`` carries the
    original (H, W) so patch rectangles stay in full-res coordinates via
    the imshow extent)."""
    plt = _pyplot()
    images = np.asarray(images)
    coeffs = np.asarray(coeffs, dtype=float)
    coeffs_std = np.asarray(coeffs_std, dtype=float)
    if frame_indices is None:
        T = images.shape[0]
        frame_indices = patch_sindy_figure_frame_indices(T)
        images = images[np.asarray(frame_indices)]
    if full_shape is None:
        full_shape = (images.shape[-2], images.shape[-1])
    # axes in FULL-resolution pixel units regardless of display resolution
    ext = (-0.5, full_shape[1] - 0.5, full_shape[0] - 0.5, -0.5)

    fig = plt.figure(figsize=(16, 10))
    for i in range(3):
        ax = plt.subplot(2, 4, i + 1)
        ax.imshow(images[i], cmap="gray", vmin=0, vmax=1, extent=ext)
        ax.set_title(f"Frame {frame_indices[i]}")
        ax.axis("off")

    ax = plt.subplot(2, 4, 4)
    mid = images[3]
    ax.imshow(mid, cmap="gray", extent=ext)
    # patch boundaries drawn as matplotlib rectangles (the reference burns
    # cv2.rectangle into the pixels; same visual contract)
    from matplotlib.patches import Rectangle

    for (y, x) in coords:
        ax.add_patch(Rectangle((x, y), patch_size, patch_size,
                               fill=False, edgecolor="white", linewidth=1))
    ax.set_title(f"Patch Grid ({n_patches} patches)")
    ax.axis("off")

    ax = plt.subplot(2, 2, 3)
    active = np.abs(coeffs) > 1e-7
    if np.any(active):
        ax.barh(np.asarray(term_names, dtype=object)[active], coeffs[active])
        ax.set_xlabel("Coefficient Value")
        ax.set_title("Active Terms")
        ax.grid(True, alpha=0.3)

    ax = plt.subplot(2, 2, 4)
    ax.scatter(np.abs(coeffs), coeffs_std, alpha=0.6)
    ax.set_xlabel("|Coefficient|")
    ax.set_ylabel("Uncertainty (std)")
    ax.set_title("Coefficient Uncertainty")
    ax.grid(True, alpha=0.3)
    if np.all(np.abs(coeffs) > 0) and np.all(coeffs_std > 0):
        ax.set_xscale("log")
        ax.set_yscale("log")

    plt.tight_layout()
    return _save(fig, Path(out_dir) / "patch_based_sindy_results.png")
