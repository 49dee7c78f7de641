#!/usr/bin/env python3
"""Smoke test of the pdx_torch port on one CUDA card (run from the repo root).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build the CUDA kernels from ``pdx_torch/csrc`` (nvcc, sm_90a);
2. kernels K1 (fused_ks_gram) and K3 (fused_blockwise_gram) against their
   plain PyTorch versions on the card, at the main path's (1999, 100, 100)
   shape and at a ragged (8, 30, 126) one, each statistic within 1e-5 of
   max|plain|, bitwise repeatable; median CUDA-event times of both;
3. the KS-2D benchmark's main path, ``pipelines.ks2d_bench.run`` at the full
   default size (100x100, 2000 Euler steps, float64) with solver auto,
   pallas (K1) and pallas blockwise (K3): worst ground-truth error < 1%,
   finite rollout, and the kernels' launch counters must move;
4. the card's pallas run against the CPU's at a small size (coefficients
   within 1e-6).

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

STAT_KEYS = ("G", "b", "sx", "n", "sy", "syy")
RTOL = 1e-5  # of max|plain| per statistic: float32 fields, float64 sums in both


def _time_ms(fn, reps: int = 15) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _check_stats(name: str, got: dict, want: dict) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / max|want|) over every
    statistic; raises past RTOL * max|want|."""
    worst, worst_rel = 0.0, 0.0
    for k in STAT_KEYS:
        err = float((got[k] - want[k]).abs().max())
        scale = float(want[k].abs().max())
        if not err <= RTOL * scale:
            raise AssertionError(f"{name}: stat {k} differs by {err:.3e} (limit {RTOL * scale:.3e})")
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale if scale else 0.0)
    return worst, worst_rel


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA card visible; this check runs only on the GPU")
    from pdx_torch.ops.kernels import _build
    from pdx_torch.ops.kernels import fused_blockwise as k3
    from pdx_torch.ops.kernels import fused_gram as k1
    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig, prepare_frames, run

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s (sources {_build.source_hash()})")

    # 2. kernels vs plain versions on the card
    kw3 = dict(block_t=3, block_x=8, block_y=8)
    specs = {
        "fused_ks_gram": dict(
            wrapper=lambda U, Ut: k1.fused_ks_gram(U, Ut, dx=0.5, dy=0.5),
            plain=lambda U, Ut: k1.fused_ks_gram_reference(U, Ut, 0.5, 0.5),
            source="pdx_torch/csrc/fused_gram.cu",
            replaces="pdx/ops/pallas/fused_gram.py:279",
            counter=k1.fused_ks_gram,
        ),
        "fused_blockwise_gram": dict(
            wrapper=lambda U, Ut: k3.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw3),
            plain=lambda U, Ut: k3.fused_blockwise_gram_reference(U, Ut, 0.5, 0.5, **kw3),
            source="pdx_torch/csrc/fused_blockwise.cu",
            replaces="pdx/ops/pallas/fused_blockwise.py:272",
            counter=k3.fused_blockwise_gram,
        ),
    }
    rng = np.random.default_rng(0)
    results = {name: {"max_abs_err": 0.0} for name in specs}
    for shape in [(1999, 100, 100), (8, 30, 126)]:
        U = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        Ut = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        for name, s in specs.items():
            got, again = s["wrapper"](U, Ut), s["wrapper"](U, Ut)
            want = s["plain"](U, Ut)
            torch.cuda.synchronize()
            err, rel = _check_stats(f"{name} {shape}", got, want)
            for k in STAT_KEYS:
                if not torch.equal(got[k], again[k]):
                    raise AssertionError(f"{name} {shape}: stat {k} differs between two runs")
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            ms = _time_ms(lambda: s["wrapper"](U, Ut))
            plain_ms = _time_ms(lambda: s["plain"](U, Ut))
            if shape[0] == 1999:
                r["ms"], r["plain_ms"] = ms, plain_ms
            print(
                f"[kernel] {name} {shape}: max|err| {err:.3e} ({rel:.1e} of max|plain|, limit {RTOL:.0e}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})"
            )
        del U, Ut

    # 3. the main path at full size
    configs = {
        "auto": Ks2dBenchConfig(grid_search=True),
        "pallas": Ks2dBenchConfig(grid_search=True, solver="pallas"),
        "pallas_blockwise": Ks2dBenchConfig(grid_search=True, solver="pallas", method="blockwise"),
    }
    needs = {"pallas": "fused_ks_gram", "pallas_blockwise": "fused_blockwise_gram"}
    for cfg in configs.values():  # warm-up: first-use allocations, cuSOLVER handles
        run(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepare_frames(configs["auto"], dev)
    torch.cuda.synchronize()
    print(f"[slice] simulate_ks2d alone (2000 steps, 100x100, float64): {time.perf_counter() - t0:.4f} s ({card})")

    for s in specs.values():
        s["counter"].launches = 0
    for label, cfg in configs.items():
        before = {n: s["counter"].launches for n, s in specs.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(cfg, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        worst = max(v["rel_err_pct"] for v in res["gt_errors"].values())
        roll = res["rollout"]
        if not worst < 1.0:
            raise AssertionError(f"{label}: recovery degraded: {res['gt_errors']}")
        if len(res["coeffs"]) != 3 or not all(math.isfinite(c) for c in res["coeffs"]):
            raise AssertionError(f"{label}: bad coefficients {res['coeffs']}")
        if not all(math.isfinite(roll[k]) for k in ("first", "last", "mean")):
            raise AssertionError(f"{label}: rollout not finite: {roll}")
        moved = {n: s["counter"].launches - before[n] for n, s in specs.items()}
        if label in needs and moved[needs[label]] < 1:
            raise AssertionError(f"{label}: kernel {needs[label]} was not launched")
        print(
            f"[slice] {label}: warm wall {wall:.4f} s, coeffs {res['coeffs']}, worst GT err "
            f"{worst:.3e}%, rollout mean {roll['mean']:.3e}, launches {moved} ({card})"
        )
    for name, s in specs.items():
        results[name]["launches"] = s["counter"].launches
        if s["counter"].launches < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # 4. the card against the CPU on a small input
    for method in ("pointwise", "blockwise"):
        small = Ks2dBenchConfig(grid_search=True, solver="pallas", method=method, Nx=32, Ny=32, n_seconds=0.2)
        on_card = np.array(run(small, dev)["coeffs"])
        on_cpu = np.array(run(small, "cpu")["coeffs"])
        np.testing.assert_allclose(on_card, on_cpu, rtol=1e-6)
        print(f"[small] pallas {method}: card {on_card.tolist()} vs CPU {on_cpu.tolist()}")

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": specs[name]["source"],
         "replaces": specs[name]["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
