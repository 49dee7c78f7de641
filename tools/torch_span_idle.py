"""Where a benchmark cell's device time and idle time fall among the port's
own spans, on the CUDA card.

    python tools/torch_span_idle.py [--workload ks2d.gt_fullfield ...] [--seed N] [--reps N] [--out PATH]

For each cell of ``BENCHMARK.json`` (default: all), in one process: the
cell's set-up and warm requests; its traced window as the benchmark takes it
(``traffic["trace_requests"]`` requests under ``torch.profiler``); then

* the window's busy and idle device seconds split by innermost program span
  (``pdx_torch.utils.profiling``): a span's self device and idle time is what
  lies inside it and outside its children; "(outside spans)" is the rest;
* every per-layer metric of the cell read from that window;
* the results of the cell's entry point plain, with a ``StageTimer`` and
  under a profiler of CUDA activity (as the benchmark's ``DeviceBusy``),
  compared bit for bit;
* what recording costs: the entry point's wall with and without a
  ``StageTimer`` (median of ``--reps`` alternated runs, each ended by a
  synchronize), the spans a run records and a span's host cost.

Prints a table a cell and writes everything to ``--out`` (default
``outputs/span_idle.json``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def split_by_span(tr, spans) -> list[dict]:
    """Rows of (name path, calls, wall, self device, self idle) seconds over
    the profiled window ``tr``, with "(outside spans)" last."""
    from benchmark import program_spans
    from pdx_torch.utils.profiling import span_tree

    rows: dict[tuple, list] = {}
    roots = []
    for path, s, own in span_tree(spans):
        own_wall = sum(b - a for a, b in own)
        own_busy = program_spans.device_ns(tr.ops, own)
        row = rows.setdefault(path, [0, 0, 0, 0])
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += own_busy
        row[3] += own_wall - own_busy
        if len(path) == 1:
            roots.append(s)
    window = tr.end_ns - tr.start_ns
    roots_wall = sum(s.end_ns - s.start_ns for s in roots)
    outside_busy = int(tr.busy_s() * 1e9) - program_spans.device_ns(tr.ops, roots)
    out = [{"span": " > ".join(p), "calls": v[0], "wall_s": v[1] / 1e9, "self_device_s": v[2] / 1e9,
            "self_idle_s": v[3] / 1e9} for p, v in rows.items()]
    out.append({"span": "(outside spans)", "calls": 0, "wall_s": (window - roots_wall) / 1e9,
                "self_device_s": outside_busy / 1e9, "self_idle_s": (window - roots_wall - outside_busy) / 1e9})
    return out


def differences(a, b, where="out") -> list[str]:
    """Where two results differ (bit for bit), ignoring stage seconds."""
    import numpy as np
    import torch

    if isinstance(a, dict):
        keys = set(a) - {"stage_seconds"}
        if keys != set(b) - {"stage_seconds"}:
            return [where]
        return [d for k in sorted(keys, key=str) for d in differences(a[k], b[k], f"{where}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in differences(x, y, f"{where}[{i}]")]
    if isinstance(a, (np.ndarray, torch.Tensor)):
        x, y = (v.cpu().numpy() if isinstance(v, torch.Tensor) else v for v in (a, b))
        return [] if np.array_equal(x, y, equal_nan=True) else [where]
    if isinstance(a, float) and a != a:
        return [] if b != b else [where]
    return [] if a == b else [where]


def _entry_call(cell_name: str, state: dict):
    """fn(timer, i) -> the cell's entry point's full result on request i."""
    from pdx_torch.pipelines import ks2d_bench, patch_discovery, transport

    if cell_name.startswith("ks2d."):
        return lambda timer, i: ks2d_bench.run(state["cfg"], state["device"], timer=timer)
    pool = state["pool"]
    if cell_name == "laser.patch_discover":
        return lambda timer, i: patch_discovery.run(state["cfg"], U_raw=pool[i % len(pool)], device=state["device"],
                                                    timer=timer)
    return lambda timer, i: transport.run(state["cfg"], U_raw=pool[i % len(pool)], timer=timer,
                                          device=state["device"])


def _span_cost_ns(n: int = 100_000) -> float:
    """Host nanoseconds to open and close one span while recording."""
    from pdx_torch.utils.profiling import StageTimer, span

    timer = StageTimer()
    with timer.stage("span_cost"):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("x"):
                pass
        dt = time.perf_counter_ns() - t0
    return dt / n


def one_cell(name: str, seed: int, reps: int) -> dict:
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness, manifest
    from benchmark.tracing import Spans, profile_window
    from pdx_torch.utils.profiling import StageTimer, spans_between

    man = manifest.load()
    cell = manifest.cell(man, name)
    traffic = cell.traffic
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    state = entry.setup(dict(cell.config), traffic, seed, "cuda")
    for w in range(int(traffic["warm_requests"])):
        entry.request(state, w)
    torch.cuda.synchronize()

    n_prof = int(traffic["trace_requests"])
    tr = profile_window(lambda: [entry.traced_request(state, j, Spans()) for j in range(n_prof)])
    spans = spans_between(tr.start_ns, tr.end_ns)
    td = harness.TraceData(Spans(), tr, entry.trace_context(state), traffic, 0.0, 0)
    metrics = {}
    for m in cell.per_layer:
        v = harness.load_metric(m["name"]).read(td)
        metrics[m["name"]] = None if v is None else float(v)
    rows = split_by_span(tr, spans)
    program_names = {s.name for s in spans}
    named_ops = sorted({op[0] for op in tr.ops if op[0] in program_names})

    call = _entry_call(name, state)
    plain = call(None, 0)
    timer = StageTimer()
    timed = call(timer, 0)
    with profile(activities=[ProfilerActivity.CUDA]):  # as the benchmark's DeviceBusy records
        profiled = call(None, 0)
    torch.cuda.synchronize()
    differs = {"timer": differences(plain, timed), "profiler": differences(plain, profiled)}

    walls = {"plain": [], "timer": []}
    for i in range(reps):
        for kind in (("plain", "timer") if i % 2 == 0 else ("timer", "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(StageTimer() if kind == "timer" else None, i)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
    t0 = time.time_ns()
    call(StageTimer(), 0)
    spans_a_run = len(spans_between(t0, time.time_ns()))
    return {
        "cell": name, "seed": seed, "card": torch.cuda.get_device_name(0), "profiled_requests": n_prof,
        "window_s": tr.window_s, "busy_s": tr.busy_s(), "device_ops": len(tr.ops), "program_spans": len(spans),
        "device_ops_named_like_a_span": named_ops, "metrics": metrics, "by_span": rows, "differs": differs,
        "walls": walls, "median_plain_s": statistics.median(walls["plain"]),
        "median_timer_s": statistics.median(walls["timer"]), "spans_a_timed_run": spans_a_run,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tools/torch_span_idle.py")
    p.add_argument("--workload", action="append")
    p.add_argument("--seed", type=int, default=6_100_000_003)
    p.add_argument("--reps", type=int, default=6)
    p.add_argument("--out", type=Path, default=ROOT / "outputs" / "span_idle.json")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_span_idle: needs a CUDA card", file=sys.stderr)
        return 1
    from benchmark import manifest

    names = args.workload or [w["name"] for w in manifest.load()["workloads"]]
    results = {"span_cost_ns": _span_cost_ns(), "cells": []}
    print(f"[span] open and close while recording: {results['span_cost_ns']:.0f} ns a span")
    out = args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    for name in names:
        r = one_cell(name, args.seed, args.reps)
        results["cells"].append(r)
        out.write_text(json.dumps(results, indent=1))
        print(f"\n[{name}] window {r['window_s']:.4f} s over {r['profiled_requests']} requests, busy {r['busy_s']:.4f} s, "
              f"{r['device_ops']} device operations, {r['program_spans']} program spans ({r['card']})")
        print(f"{'innermost span':<62}{'calls':>7}{'wall s':>10}{'device s':>10}{'idle s':>10}")
        for row in r["by_span"]:
            print(f"{row['span'][-61:]:<62}{row['calls']:>7}{row['wall_s']:>10.4f}{row['self_device_s']:>10.4f}"
                  f"{row['self_idle_s']:>10.4f}")
        print(f"metrics {json.dumps(r['metrics'])}")
        print(f"device operations named like a program span: {r['device_ops_named_like_a_span']}")
        print(f"bitwise: with a timer differs at {r['differs']['timer'] or 'nothing'}, under a profiler at "
              f"{r['differs']['profiler'] or 'nothing'}")
        print(f"wall median of {args.reps}: plain {r['median_plain_s']:.6f} s, with a StageTimer "
              f"{r['median_timer_s']:.6f} s ({100 * (r['median_timer_s'] / r['median_plain_s'] - 1):+.2f}%); "
              f"{r['spans_a_timed_run']} spans a timed run", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
