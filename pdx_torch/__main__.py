"""pdx_torch CLI — the ported workload entry points.

Usage:
  python -m pdx_torch ks2d-bench [--grid-search] [--solver auto|gram|qr|pallas]
      [--method pointwise|blockwise|weakform] [--dictionary true|rich]
      [--regression standard|huber|trimmed|sign_constrained|ensemble] [--robust]
      [--correct-shift-ut] [...]
  python -m pdx_torch ks2d-bench-json [...]

The flags are ``pdx``'s (one per ``Ks2dBenchConfig`` field), plus
``--device`` (default ``cuda``). The run uses the CUDA card and fails
without one; ``--device cpu`` runs it on the CPU.
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


def _parse_config(prog: str, argv: list[str]):
    """(Ks2dBenchConfig, device) from the command line."""
    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig

    parser = argparse.ArgumentParser(prog=prog)
    _add_dataclass_args(parser, Ks2dBenchConfig)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = Ks2dBenchConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(Ks2dBenchConfig)})
    return cfg, args.device


def cmd_ks2d_bench(argv: list[str]) -> int:
    from pdx_torch.pipelines.ks2d_bench import run

    res = run(*_parse_config("pdx_torch ks2d-bench", argv))
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

    res = run(*_parse_config("pdx_torch ks2d-bench-json", argv))
    # tensors (robust_info's std and confidence bounds) become lists
    print(json.dumps(res, default=lambda o: o.tolist()))
    return 0


COMMANDS = {"ks2d-bench": cmd_ks2d_bench, "ks2d-bench-json": cmd_json}


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
