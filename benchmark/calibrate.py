"""Readings that the limits of ``correct`` are set from, for one cell over
many seeds in one process (set-up is long; the measured window is not
needed to read them):

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--requests 2]
        [--mode program|control|fault:<name>] [--out FILE]

``program`` compares the port's runs with the plain reference, ``control``
puts the reference computed one precision lower (float32) in the port's
place, and ``fault:<name>`` breaks the port underneath (see
``benchmark/faults.py``). The first request of each seed is the traced
split, so the stages' outputs are compared too. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, manifest  # noqa: E402
from benchmark.tracing import Spans  # noqa: E402


def readings(workload: str, seeds: list[int], requests: int, mode: str, device: str = "cuda",
             config_override: dict | None = None):
    import torch

    cell = manifest.cell(manifest.load(), workload)
    config = dict(cell.config, **(config_override or {}))
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    undo = faults.apply(workload, mode.split(":", 1)[1]) if mode.startswith("fault:") else None
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            state = entry.setup(config, cell.traffic, seed, device)
            worst: dict[str, float] = {}
            for i in range(requests):
                if mode == "control":
                    got = entry.reference(state, i, torch.float32)
                elif i == 0:
                    got = entry.traced_request(state, i, Spans(), keep=True)
                else:
                    got = entry.request(state, i)
                want = entry.reference(state, i, torch.float64)
                if hasattr(entry, "fixed"):
                    got = dict(got, fixed=entry.fixed(state, want, torch.float32 if mode == "control" else None))
                for k, v in entry.compare(got, want).items():
                    worst[k] = max(worst.get(k, 0.0), float(v))
            entry.free(state)
            yield {"workload": workload, "seed": seed, "mode": mode, "requests": requests,
                   "seconds": time.perf_counter() - t0, "readings": worst}
    finally:
        if undo is not None:
            undo()


def main() -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--mode", default="program")
    p.add_argument("--out")
    a = p.parse_args()
    out = open(a.out, "a") if a.out else None
    try:
        for row in readings(a.workload, [int(s) for s in a.seeds.split(",")], a.requests, a.mode):
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
