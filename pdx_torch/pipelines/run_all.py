"""Orchestrator: run every pipeline in sequence (port of
``pdx/pipelines/run_all.py``).

Parity: ``scripts/run_all.py`` — fast steps (analyze -> figures -> slides)
then heavy steps (improved registration, patch sindy, patch discovery,
transport), fail-fast, then a refresh of the figures that read the heavy
steps' patch outputs, then list the produced artifacts. The stages run in
one process on one device, in ``pdx``'s order with ``pdx``'s per-stage
configurations; every stage gets the resolved device (the CUDA card unless
``device="cpu"``).

One deliberate difference: ``pdx`` imports matplotlib when its figure
modules load and so fails without it; here a figure stage whose drawing
cannot import matplotlib records ``"skipped: matplotlib not installed"``
instead of ``"ok"``. Only that ``ImportError`` is absorbed: any other
exception of any stage propagates, and device work is never skipped (the
presentation stage's flows run before its drawing). The pipelines' own
figures keep their guards.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from pdx_torch import resolve_device
from pdx_torch.utils.profiling import null_stage

SKIPPED = "skipped: matplotlib not installed"


@dataclass(frozen=True)
class RunAllConfig:
    data_dir: str = "data/Real-Images"
    output_root: str = "outputs/latest"
    max_images: int = 51
    skip_heavy: bool = False
    skip: int = 25
    subsample: int = 12
    # patch-sindy knobs (defaults assume ~1024 px frames like the reference)
    patch_size: int = 256
    patch_overlap: int = 64
    min_patches: int = 5
    # patch-discovery knobs (working-grid units)
    grid_patch: int = 21
    grid_overlap: int = 10


def _figure(fn, *args, **kwargs) -> str:
    """Call a figure generator: "ok", or SKIPPED if its drawing could not
    import matplotlib. Any other error propagates."""
    try:
        fn(*args, **kwargs)
    except ImportError as e:
        if (e.name or "").partition(".")[0] != "matplotlib":
            raise
        return SKIPPED
    return "ok"


def run(cfg: RunAllConfig, device: str | torch.device | None = None, timer=None) -> dict[str, str]:
    """Every pipeline of the study on ``cfg.data_dir``'s TIFFs, writing under
    ``cfg.output_root``. Returns each stage's status. ``timer`` (a
    :class:`pdx_torch.utils.profiling.StageTimer`) times each stage under
    its status name."""
    from pdx_torch.pipelines.analyze import AnalyzeConfig, run as run_analyze
    from pdx_torch.report.comparative import (
        create_comparative_final_figures,
        create_finalclass_figures,
        generate_presentation_figures,
    )
    from pdx_torch.report.figures import (
        create_method_slide,
        create_simple_slide3,
        generate_presentation_figures_minimal,
    )

    dev = resolve_device(device)
    st = timer.stage if timer is not None else null_stage
    out_root = Path(cfg.output_root)
    slides = out_root / "slides"
    patch_csv = out_root / "patch_pde" / "PATCH_PDE_COEFFS.csv"
    patch_report = out_root / "patch_pde" / "PATCH_PDE_REPORT.txt"
    status: dict[str, str] = {}

    # --- fast steps -------------------------------------------------------
    with st("analyze"):
        run_analyze(
            AnalyzeConfig(
                data_dir=cfg.data_dir,
                output_dir=str(slides),
                max_images=cfg.max_images,
                skip=cfg.skip,
                subsample=cfg.subsample,
            ),
            device=dev,
        )
    status["analyze"] = "ok"

    with st("figures_minimal"):
        status["figures_minimal"] = _figure(generate_presentation_figures_minimal, slides, data_dir=cfg.data_dir)
    with st("slide3"):
        status["slide3"] = _figure(create_simple_slide3, slides)
    with st("method_slide"):
        status["method_slide"] = _figure(create_method_slide, slides)

    with st("comparative_figures"):
        status["comparative_figures"] = _figure(create_comparative_final_figures, slides, patch_csv)
    with st("finalclass_figures"):
        status["finalclass_figures"] = _figure(create_finalclass_figures, slides, patch_csv)
    with st("presentation_figures"):
        status["presentation_figures"] = _figure(
            generate_presentation_figures, slides, cfg.data_dir, patch_report, device=dev
        )

    if not cfg.skip_heavy:
        from pdx_torch.pipelines.improved_registration import ImprovedRegistrationConfig, run as run_reg
        from pdx_torch.pipelines.patch_discovery import PatchDiscoveryConfig, run as run_pd
        from pdx_torch.pipelines.patch_sindy import PatchSindyConfig, run as run_ps
        from pdx_torch.pipelines.transport import TransportConfig, run as run_tr

        with st("improved_registration"):
            run_reg(
                ImprovedRegistrationConfig(
                    data_dir=cfg.data_dir,
                    output_dir=str(out_root / "registration"),
                    max_images=cfg.max_images,
                    skip=cfg.skip,
                    subsample=cfg.subsample,
                ),
                device=dev,
            )
        status["improved_registration"] = "ok"

        with st("patch_sindy"):
            run_ps(
                PatchSindyConfig(
                    data_dir=cfg.data_dir,
                    output_dir=str(out_root / "patch_sindy"),
                    max_images=cfg.max_images,
                    patch_size=cfg.patch_size,
                    overlap=cfg.patch_overlap,
                    min_patches=cfg.min_patches,
                ),
                device=dev,
            )
        status["patch_sindy"] = "ok"

        with st("patch_discovery"):
            run_pd(
                PatchDiscoveryConfig(
                    data_dir=cfg.data_dir,
                    output_dir=str(out_root / "patch_pde"),
                    max_images=cfg.max_images,
                    skip=cfg.skip,
                    subsample=cfg.subsample,
                    patch=cfg.grid_patch,
                    overlap=cfg.grid_overlap,
                ),
                device=dev,
            )
        status["patch_discovery"] = "ok"

        with st("transport"):
            run_tr(
                TransportConfig(
                    data_dir=cfg.data_dir,
                    output_dir=str(out_root / "transport"),
                    max_images=cfg.max_images,
                ),
                device=dev,
            )
        status["transport"] = "ok"

        # refresh the patch-dependent figure assets now that the heavy steps
        # produced PATCH_PDE_COEFFS.csv / PATCH_PDE_REPORT.txt (the reference
        # runs its generators before the heavy scripts and needs a second
        # invocation for these)
        with st("figures_refresh"):
            done = {
                _figure(create_comparative_final_figures, slides, patch_csv),
                _figure(create_finalclass_figures, slides, patch_csv),
                _figure(generate_presentation_figures, slides, cfg.data_dir, patch_report, device=dev),
            }
        status["figures_refresh"] = "ok" if done == {"ok"} else SKIPPED

    return status


def list_artifacts(output_root: str | Path) -> list[str]:
    """List produced artifacts (parity: run_all.py list_latest_pngs)."""
    root = Path(output_root)
    if not root.exists():
        return []
    return sorted(
        str(p.relative_to(root)) for p in root.rglob("*") if p.suffix in {".png", ".json", ".csv", ".txt"}
    )


def parse_args(argv: list[str]) -> tuple[RunAllConfig, str]:
    """``pdx run-all``'s flags plus ``--device`` (default ``cuda``)."""
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch run-all")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--output-root", default="outputs/latest")
    parser.add_argument("--max-images", type=int, default=51)
    parser.add_argument("--skip-heavy", action="store_true")
    parser.add_argument("--skip", type=int, default=25)
    parser.add_argument("--subsample", type=int, default=12)
    parser.add_argument("--patch-size", type=int, default=256)
    parser.add_argument("--patch-overlap", type=int, default=64)
    parser.add_argument("--min-patches", type=int, default=5)
    parser.add_argument("--grid-patch", type=int, default=21)
    parser.add_argument("--grid-overlap", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = RunAllConfig(
        data_dir=args.data_dir,
        output_root=args.output_root,
        max_images=args.max_images,
        skip_heavy=args.skip_heavy,
        skip=args.skip,
        subsample=args.subsample,
        patch_size=args.patch_size,
        patch_overlap=args.patch_overlap,
        min_patches=args.min_patches,
        grid_patch=args.grid_patch,
        grid_overlap=args.grid_overlap,
    )
    return cfg, args.device


def cmd_run_all(argv: list[str]) -> int:
    cfg, device = parse_args(argv)
    status = run(cfg, device)
    for stage, st in status.items():
        print(f"  {stage}: {st}")
    print("\nArtifacts:")
    for a in list_artifacts(cfg.output_root):
        print(f"  {a}")
    return 0
