"""pdx_torch CLI — the ported workload entry points.

Usage:
  python -m pdx_torch ks2d-bench [--grid-search] [--solver auto|gram|qr|pallas]
      [--method pointwise|blockwise|weakform] [--dictionary true|rich]
      [--regression standard|huber|trimmed|sign_constrained|ensemble] [--robust]
      [--correct-shift-ut] [--profile] [...]
  python -m pdx_torch ks2d-bench-json [...]
  python -m pdx_torch patch-discover --data-dir DIR [--no-registration]
      [--register-mode auto|compose|chain|to_first] [--patch 21] [--profile] [...]
  python -m pdx_torch analyze --data-dir DIR [--output-dir OUT] [--robust]
      [--stabilize] [--no-registration] [--register-mode ...] [--include-fourth-order]
      [--skip 25] [--subsample 12] [--profile] [...]
  python -m pdx_torch transport --data-dir DIR [--output-dir OUT] [--max-images 51]
      [--downsample 4] [--quick] [--profile]
  python -m pdx_torch patch-sindy --data-dir DIR [--registration none|ecc|optical_flow]
      [--flow-scope patch|frame] [--flow-impl auto|compose|chain] [--patch-size 256]
      [--overlap 64] [--max-patches N] [...]
  python -m pdx_torch improved-registration --data-dir DIR [--max-images 51] [--skip 25]
      [--subsample 12]
  python -m pdx_torch comprehensive [--output-dir OUT] [--methods M01_baseline,...]
      [--noises N2_noise,...] [--n-seconds 1.0]
  python -m pdx_torch sindy1d [--scenario clean|noisy|shifted|varying_ic] [--noise-rel 0.05]
      [--derivative spectral|finite] [--denoise none|spectral|gaussian|savgol] [--register]
      [--regressor lasso|stridge|lstsq] [--n-steps 2000]
  python -m pdx_torch run-all --data-dir DIR [--output-root OUT] [--skip-heavy] [...]
  python -m pdx_torch list-resolutions [--data-dir DIR] [--pattern '*.tif']
  python -m pdx_torch doctor

The flags are ``pdx``'s (for ks2d-bench one per ``Ks2dBenchConfig``
field), plus ``--device`` (default ``cuda``) for every command that
computes. The run uses the CUDA card and fails without one; ``--device cpu``
runs it on the CPU. ``--profile`` (ks2d-bench, patch-discover, analyze,
transport) runs with a :class:`pdx_torch.utils.profiling.StageTimer` and
prints its report: each stage's seconds (ended by a synchronize), then the
program's nested spans with their self time and counts. ``doctor`` checks
the card, the toolkit and the kernels, and exits 1 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=f.default)
        elif f.type in ("tuple[int, ...]",):
            parser.add_argument(
                name,
                type=lambda s: tuple(int(x) for x in s.split(",") if x.strip()),
                default=f.default,
            )
        else:
            py_type = {
                "int": int, "float": float, "str": str,
                "int | None": int, "float | None": float,
            }.get(str(f.type), str)
            parser.add_argument(name, type=py_type, default=f.default)


def _parse_config(prog: str, argv: list[str], profile: bool = False):
    """(Ks2dBenchConfig, the parsed arguments) from the command line; with
    ``profile`` the parser also takes ``--profile``."""
    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig

    parser = argparse.ArgumentParser(prog=prog)
    _add_dataclass_args(parser, Ks2dBenchConfig)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if profile:
        parser.add_argument("--profile", action="store_true",
                            help="print the stages' seconds and the program's spans")
    args = parser.parse_args(argv)
    cfg = Ks2dBenchConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(Ks2dBenchConfig)})
    return cfg, args


def cmd_ks2d_bench(argv: list[str]) -> int:
    from pdx_torch.pipelines.ks2d_bench import run
    from pdx_torch.utils.profiling import StageTimer

    cfg, args = _parse_config("pdx_torch ks2d-bench", argv, profile=True)
    timer = StageTimer() if args.profile else None
    res = run(cfg, args.device, timer=timer)
    if timer is not None:
        print(timer.report())
    print("Discovered PDE (|c| > 1e-8):")
    for name, c in sorted(zip(res["display_names"], res["coeffs"]), key=lambda p: -abs(p[1])):
        if abs(c) > 1e-8:
            print(f"  {name:8s}: {c:+.6f}")
    print("\nGround-truth comparison (relative error):")
    for k, v in res["gt_errors"].items():
        print(f"  {k:8s}: gt={v['gt']:+.6f}, est={v['est']:+.6f}, rel_err={v['rel_err_pct']:.3f}%")
    print("\nFit quality:")
    if "train_r2" in res["fit"]:
        print(f"  Train R2={res['fit']['train_r2']:.6f}, RMSE={res['fit']['train_rmse']:.6e}")
    print(f"  Test  R2={res['fit']['test_r2']:.6f}, RMSE={res['fit']['test_rmse']:.6e}")
    r = res["rollout"]
    print(
        f"\nRollout RMSE over {r['n_steps']} steps: first={r['first']:.3e}, "
        f"last={r['last']:.3e}, mean={r['mean']:.3e}"
    )
    return 0


def cmd_json(argv: list[str]) -> int:
    """ks2d-bench with machine-readable JSON output."""
    from pdx_torch.pipelines.ks2d_bench import run

    cfg, args = _parse_config("pdx_torch ks2d-bench-json", argv)
    res = run(cfg, args.device)
    # tensors (robust_info's std and confidence bounds) become lists
    print(json.dumps(res, default=lambda o: o.tolist()))
    return 0


def cmd_patch_discover(argv: list[str]) -> int:
    from pdx_torch.pipelines.patch_discovery import cmd_patch_discover

    return cmd_patch_discover(argv)


def cmd_analyze(argv: list[str]) -> int:
    from pdx_torch.pipelines.analyze import cmd_analyze

    return cmd_analyze(argv)


def cmd_transport(argv: list[str]) -> int:
    from pdx_torch.pipelines.transport import cmd_transport

    return cmd_transport(argv)


def cmd_patch_sindy(argv: list[str]) -> int:
    from pdx_torch.pipelines.patch_sindy import cmd_patch_sindy

    return cmd_patch_sindy(argv)


def cmd_improved_registration(argv: list[str]) -> int:
    from pdx_torch.pipelines.improved_registration import cmd_improved_registration

    return cmd_improved_registration(argv)


def cmd_comprehensive(argv: list[str]) -> int:
    from pdx_torch.pipelines.comprehensive import cmd_comprehensive

    return cmd_comprehensive(argv)


def cmd_sindy1d(argv: list[str]) -> int:
    from pdx_torch.pipelines.sindy1d import cmd_sindy1d

    return cmd_sindy1d(argv)


def cmd_run_all(argv: list[str]) -> int:
    from pdx_torch.pipelines.run_all import cmd_run_all

    return cmd_run_all(argv)


def cmd_list_resolutions(argv: list[str]) -> int:
    """Image-resolution audit (reference: scripts/list_image_resolutions.py)."""
    from pdx_torch.io_host.images import list_image_resolutions

    parser = argparse.ArgumentParser(prog="pdx_torch list-resolutions")
    parser.add_argument("--data-dir", default="data/Real-Images")
    parser.add_argument("--pattern", default="*.tif")
    args = parser.parse_args(argv)
    hist = list_image_resolutions(args.data_dir, args.pattern)
    if not hist:
        print(f"no images matching {args.pattern} in {args.data_dir}")
        return 1
    for (h, w), n in sorted(hist.items()):
        print(f"  {h} x {w}: {n} files")
    return 0


def cmd_doctor(argv: list[str]) -> int:
    """Environment check of the card: torch and CUDA versions, each card's
    name and power limit, float64, the TF32 flags (the port keeps both off),
    nvcc, whether the kernels (K1-K4 and the Farnebäck flow's windowed
    passes) build and load, and the dispatch and device-to-host latencies.
    Exits 0 only when a card is visible and the kernels load; never falls
    back to the CPU."""
    import os
    import subprocess
    import time

    import torch

    argparse.ArgumentParser(prog="pdx_torch doctor").parse_args(argv)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  cards visible: {torch.cuda.device_count()}")
    if not torch.cuda.is_available():
        print("no CUDA card visible: the port's entry points need one (or --device cpu)")
        return 1
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        smi = [f"{torch.cuda.get_device_name(i)}, power limit unknown (nvidia-smi: {e})"
               for i in range(torch.cuda.device_count())]
    for i, line in enumerate(smi):
        print(f"card {i}: {line}")
    dev = torch.device("cuda", 0)
    x64 = torch.full((4, 4), 0.5, dtype=torch.float64, device=dev)
    print(f"float64: {'available' if float((x64 @ x64)[0, 0]) == 1.0 else 'WRONG RESULT'}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    verdict = "off, as the port needs" if not any(tf32) else "ON: coefficient recovery loses accuracy"
    print(f"TF32: matmul {tf32[0]}, cudnn {tf32[1]} ({verdict})")

    from pdx_torch.ops.kernels import _build

    try:
        nvcc = _build._nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60).stdout
        print(f"nvcc: {nvcc} ({version.strip().splitlines()[-1]})")
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        print(f"nvcc: {e}")
    out_dir = _build._BUILD / _build.source_hash()
    try:
        t0 = time.perf_counter()
        lib = _build.library()
        loaded = [k for k, sym in _build.KERNELS.items() if hasattr(lib, sym)]
        print(f"kernels: {len(loaded)} of {len(_build.KERNELS)} loaded "
              f"({', '.join(f'{k} {_build.KERNELS[k]}' for k in loaded)}) "
              f"in {time.perf_counter() - t0:.2f} s")
    except Exception as e:  # a failed build is the finding this command reports
        loaded = []
        print(f"kernels: build or load failed: {type(e).__name__}: {e}")
    n_entries = len(os.listdir(out_dir)) if out_dir.is_dir() else 0
    print(f"build directory: {out_dir} ({n_entries} entries)")

    x = torch.ones((128, 128), device=dev)
    y = x @ x  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = x @ x
    torch.cuda.synchronize()
    print(f"dispatch+sync latency: {(time.perf_counter() - t0) * 1000:.3f} ms")
    t0 = time.perf_counter()
    float((y @ x)[0, 0])
    print(f"device->host read round-trip: {(time.perf_counter() - t0) * 1000:.3f} ms")
    return 0 if len(loaded) == len(_build.KERNELS) else 1


COMMANDS = {
    "ks2d-bench": cmd_ks2d_bench,
    "ks2d-bench-json": cmd_json,
    "patch-discover": cmd_patch_discover,
    "analyze": cmd_analyze,
    "transport": cmd_transport,
    "patch-sindy": cmd_patch_sindy,
    "improved-registration": cmd_improved_registration,
    "comprehensive": cmd_comprehensive,
    "sindy1d": cmd_sindy1d,
    "run-all": cmd_run_all,
    "list-resolutions": cmd_list_resolutions,
    "doctor": cmd_doctor,
}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0
    if argv[0] not in COMMANDS:
        print(f"error: unknown command '{argv[0]}'. available: {', '.join(sorted(COMMANDS))}", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
