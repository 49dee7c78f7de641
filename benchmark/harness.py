"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the plain reference, and the result line.

A cell's traffic file names an entry (``benchmark/entries/<entry>.py``),
the adapter between the harness and one entry point of ``pdx_torch``. An
entry module provides:

* ``setup(config, traffic, seed, device)`` -> state: the inputs, made from
  the seed;
* ``request(state, i)`` -> summary: the i-th discovery run, as a user
  calls it; the summary is small host data;
* ``traced_request(state, i, span, keep)``: the same run split into the
  port's public stages, each inside ``span(name)``; with ``keep`` its
  summary also holds the stages' outputs that only the traced run checks;
* ``input_key(state, i)``: which input request i ran on;
* ``reference(state, i, dtype)`` -> summary: the plain reference's result
  on request i's input, in ``dtype``;
* ``compare(got, want)`` -> {number: value}: the numbers that decide
  ``correct``, each held to its limit in
  ``benchmark/limits/<config>.<entry>.json``;
* ``fixed(state, want, dtype=None)`` (optional) -> summary: a later stage
  of the program run on the reference's own intermediate (``want``), or
  with ``dtype`` the reference's in that precision; ``compare`` finds it
  in ``got["fixed"]``;
* ``trace_context(state)`` -> dict: what the metric readers may need;
* ``free(state)``: drop the program's device state before the reference.

The loop is closed with one client: each run starts when the one before it
has returned, as a researcher waits for a result before the next setting.
"""

from __future__ import annotations

import argparse
import ast
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from pathlib import Path

from benchmark import manifest, stats

FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "pdx")
REFERENCE_FORBIDDEN = FORBIDDEN_TOP_LEVEL + ("pdx_torch",)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's: ``pdx_torch`` is not ``pdx``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_TOP_LEVEL)


def reference_imports_program(ref_dir: Path | None = None) -> list[str]:
    """``file: module`` for every import in ``benchmark/reference/`` of the
    program, JAX or the JAX package."""
    ref_dir = ref_dir or manifest.BENCH / "reference"
    found = []
    for path in sorted(ref_dir.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                mods = [node.module]
            found += [f"{path.name}: {m}" for m in mods if m.split(".")[0] in REFERENCE_FORBIDDEN]
    return found


def load_metric(name: str):
    """``benchmark/metrics/<name>.py`` as a module (its name may hold dots)."""
    path = manifest.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TraceData:
    """What a metric reader gets: the window's spans (seconds a span name,
    one entry a request), the measured window's length and the runs
    completed in it, the profiled window's device trace, the entry's
    context and the traffic file."""

    def __init__(self, spans, device, ctx, traffic, window_s=0.0, n_runs=0):
        self.spans, self.device, self.ctx, self.traffic = spans, device, ctx, traffic
        self.window_s, self.n_runs = window_s, n_runs


def parse_args(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def compare_all(entry, cell_limits: dict, pairs) -> dict[str, dict]:
    """Worst value of every compared number over ``pairs`` of (got, want),
    each beside its limit."""
    worst: dict[str, float] = {}
    for got, want in pairs:
        for k, v in entry.compare(got, want).items():
            v = float(v)
            worst[k] = max(worst.get(k, 0.0), math.inf if math.isnan(v) else v)
    return {k: {"value": worst[k], "limit": cell_limits[k]} for k in worst}


def run(argv, *, device: str = "cuda", process_start: float | None = None, config_override: dict | None = None,
        stream=None) -> int:
    """One run of one cell; prints the result as the last line of
    ``stream`` (stdout). Returns the exit code. ``device="cpu"`` and
    ``config_override`` exist for the tests, which drive a run at a small
    size without a card."""
    t_start = process_start if process_start is not None else time.perf_counter()
    args = parse_args(argv)
    stream = stream or sys.stdout
    try:
        man = manifest.load()
        cell = manifest.cell(man, args.workload)
    except manifest.ManifestError as e:
        _say(f"benchmark: {e}")
        return 2

    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            _say("benchmark: no CUDA card visible; the benchmark does not run on the CPU")
            return 1
        if torch.cuda.device_count() < cell.chips:
            _say(f"benchmark: {cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible")
            return 1
    bad_refs = reference_imports_program()
    if bad_refs:
        _say("benchmark: the reference imports the program or JAX: " + ", ".join(bad_refs))
        return 3

    config = dict(cell.config, **(config_override or {}))
    traffic = cell.traffic
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    limits = manifest.limits(cell)
    trace = bool(args.trace)

    # set-up: the inputs from the seed, then warm requests of the cell's shapes
    state = entry.setup(config, traffic, args.seed, device)
    warm = [entry.request(state, w) for w in range(int(traffic["warm_requests"]))]
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # the measured window: a closed loop, one client, back to back
    from benchmark.tracing import DeviceBusy, Spans, profile_window

    spans = Spans() if trace else None
    # an end-to-end metric read from the device's trace: the whole window
    # runs under a profiler of CUDA activity alone
    busy = None
    if not trace and device == "cuda" and any(m["source"] == "device_trace" for m in cell.end_to_end):
        busy = DeviceBusy().__enter__()
    outputs, walls, failed = [], [], 0
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        try:
            out = entry.traced_request(state, i, spans, i == 0) if trace else entry.request(state, i)
            _sync(device)
            outputs.append((i, out))
            walls.append(time.perf_counter() - ts)
        except Exception:  # a failed run is counted and reported, the loop goes on
            failed += 1
            _say(traceback.format_exc())
        i += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    attempted = i
    if busy is not None:
        t_read = time.perf_counter()
        busy.__exit__(None, None, None)
        _say(f"device busy {busy.busy_s!r} s in the window, {busy.n_ops} device operations; "
             f"the profiler stopped and read in {time.perf_counter() - t_read!r} s")
    if walls:
        _say(f"window {window_s!r} s, {len(walls)} runs; run walls min {min(walls)!r} median "
             f"{stats.percentile(walls, 50)!r} max {max(walls)!r} s")

    metrics: dict[str, dict] = {}
    device_info: dict = {}
    breakdown = None
    if device == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    if not trace and walls:
        for m in cell.end_to_end:
            if m["name"] == "run_s":
                metrics["run_s"] = stats.run_s(window_s, len(walls))
            elif m["name"] == "run_p95_s":
                metrics["run_p95_s"] = stats.percentile(walls, 95.0)
            elif m["name"] == "setup_s":
                metrics["setup_s"] = setup_s
            elif m["name"] == "device_s_per_run" and busy is not None:
                metrics["device_s_per_run"] = busy.busy_s / len(walls)
        metrics = {k: {"value": v, "unit": next(m["unit"] for m in cell.end_to_end if m["name"] == k)}
                   for k, v in metrics.items()}
    if trace and walls and device == "cuda":
        n_prof = int(traffic["trace_requests"])
        prof_spans = Spans()
        dev_trace = profile_window(lambda: [entry.traced_request(state, j, prof_spans) for j in range(n_prof)])
        td = TraceData(spans, dev_trace, entry.trace_context(state), traffic, window_s, len(walls))
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(td)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info["busy_s"] = dev_trace.busy_s()
        device_info["window_s"] = dev_trace.window_s
        breakdown = {"device_ops": dev_trace.top_ops(), "idle_gaps": dev_trace.top_idle()}
        del dev_trace, td
    if device == "cuda":
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        _say(f"memory peak {device_info['memory_peak_bytes']} bytes allocated")

    # correctness, once the window has closed and the program's state is freed
    entry.free(state)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    rng = random.Random(args.seed)
    n_check = min(int(traffic["check_requests"]), len(outputs))
    sample = set(rng.sample(range(len(outputs)), n_check))
    if trace and outputs:
        sample.add(0)  # the run whose stages' outputs were kept
    refs: dict = {}
    pairs = []
    for s in sorted(sample):
        idx, got = outputs[s]
        key = entry.input_key(state, idx)
        if key not in refs:
            refs[key] = entry.reference(state, idx, torch.float64)
        if hasattr(entry, "fixed"):
            got = dict(got, fixed=entry.fixed(state, refs[key]))
        pairs.append((got, refs[key]))
    checks = compare_all(entry, limits, pairs)
    if trace and outputs and warm:
        # the split into stages against the entry, on the same input
        split = compare_all(entry, limits, [(outputs[0][1], warm[0])])
        checks.update({f"split.{k}": v for k, v in split.items()})
    correct = bool(walls) and failed == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())

    found = forbidden_modules()
    if found:
        _say("benchmark: JAX or the JAX package was loaded: " + ", ".join(found))
        return 3

    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        _say(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}")
    print(json.dumps(result), file=stream, flush=True)
    return 0
