"""``laser.improved_registration`` at a small size: ``correct`` comes out true
for the port and false for the float32 control in its place and for every
planted fault of ``benchmark/faults_registration_study.py``, in a whole run
of the harness on the CPU; the cell's per-layer readers on hand-built
traces; and a short run on the card at that size."""

import importlib
import io
import json
import subprocess
import sys

import pytest
import torch

from benchmark import faults_registration_study as faults
from benchmark import harness, manifest
from benchmark.tracing import DeviceTrace, Spans
from pdx_torch.utils import profiling
from pdx_torch.utils.profiling import Span

WORKLOAD = faults.WORKLOAD
SMALL = {"frames": 8, "height": 96, "width": 112,
         "improved_registration": {"max_images": 8, "denoise_sigma": 1.0, "savgol_window": 7, "savgol_poly": 3,
                                   "skip": 10, "subsample": 4, "dx": 0.1, "dy": 0.1, "dt": 1.0, "alpha": 0.01,
                                   "threshold": 1e-05, "reference_compat_warp": False, "dtype": "float64"}}
PER_LAYER = {"dis.ms_per_step", "dis.launches_per_step", "dis.device_ms_per_step", "quality.s_per_sweep",
             "register.ms_per_flow", "register.launches_per_flow", "register.device_ms_per_flow",
             "register.graph_replay_share", "device.idle_pct"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many tiny operations: on one thread each, since in a parallel test run
    a thread team per operation waits on cores that other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_small(trace: int = 0, device: str = "cpu") -> dict:
    out = io.StringIO()
    rc = harness.run(["--workload", WORKLOAD, "--seed", "3000000019", "--seconds", "0.5", "--trace", str(trace)],
                     device=device, config_override=SMALL, stream=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_port_is_correct(trace):
    res = run_small(trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {"fb_quality_gap", "method_gap", "coef_gap", "r2_gap", "fixed_fb_quality_gap", "fixed_method_gap",
            "fixed_coef_gap", "fixed_r2_gap", "dis_step_gap", "dis_quality_gap"}
    if trace:  # the kept stages, and the split into stages against the entry: bitwise
        want |= {"head_gap", "fb_registered_gap"}
        assert all(v["value"] == 0 for k, v in res["checks"].items() if k.startswith("split."))
    assert want <= set(res["checks"])


def test_the_float32_control_is_not_correct(monkeypatch):
    entry = importlib.import_module("benchmark.entries.improved_registration")
    monkeypatch.setattr(entry, "request", lambda state, i: entry.reference(state, i, torch.float32))
    res = run_small()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS[WORKLOAD]))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_planted_fault_is_not_correct(fault, trace):
    undo = faults.apply(WORKLOAD, fault)
    try:
        res = run_small(trace)
    finally:
        undo()
    assert not res["correct"], res["checks"]


def _span(name, sid, parent, start, end, **counts):
    s = Span(name, sid, parent, sid if parent is None else 1, start)
    s.end_ns, s.counts = end, dict(counts)
    return s


def _trace(program_spans, monkeypatch, ops=(), spans=()):
    """A trace of two requests: harness spans by name (seconds), the profiled
    window's device operations and harness spans, and the program's spans."""
    monkeypatch.setattr(profiling, "spans_between",
                        lambda a, b: [s for s in program_spans if s.start_ns >= a and s.end_ns <= b])
    host = Spans()
    for name, secs in (("dis_chain", (1.0, 3.0)), ("quality", (3.0, 5.0)), ("register", (0.25, 0.75))):
        for v in secs:
            host.add(name, v)
    dev = DeviceTrace(ops=list(ops), spans=list(spans), start_ns=0, end_ns=10_000)
    return harness.TraceData(host, dev, {"flows_per_request": 50}, {})


PROGRAM = [
    _span("dis.flow", 1, None, 1100, 1200, **{"dis.flows": 1}),
    _span("dis.level", 2, 1, 1110, 1150, **{"dis.levels": 1, "dis.iterations": 8}),
    _span("dis.flow", 3, None, 1900, 2100, **{"dis.flows": 1}),  # its middle inside the chain's span
    _span("dis.flow", 4, None, 2500, 2600, **{"dis.flows": 1}),  # outside it
    _span("quality.sweep", 5, None, 3100, 3200, **{"quality.sweeps": 1, "quality.pair_flows": 50}),
    _span("quality.sweep", 6, None, 3300, 3400, **{"quality.sweeps": 1, "quality.pair_flows": 50}),
]
OPS = [("k", 1000, 1500), ("k", 1400, 1600), ("k", 1950, 2400), ("k", 2500, 2600), ("k", 3000, 3100)]
HARNESS = [("dis_chain", 1000, 2050), ("quality", 3000, 4000)]


@pytest.mark.parametrize("name,want", [
    ("dis.ms_per_step", 1e3 * 2.0 / 50),  # the span's mean over the steps of a run
    ("dis.launches_per_step", 3 / (1 * 50)),  # three operations start in the one dis_chain span
    ("dis.device_ms_per_step", (600 + 100) / 1e6 / 2),  # device ns in the span over the two flows under it
    ("quality.s_per_sweep", 4.0 / 2),  # the span's mean over the sweeps a span
    ("register.ms_per_flow", 1e3 * 0.5 / 50),  # the study's chain read as the patch cell's
])
def test_the_readers(monkeypatch, name, want):
    assert harness.load_metric(name).read(_trace(PROGRAM, monkeypatch, OPS, HARNESS)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["dis.device_ms_per_step", "quality.s_per_sweep"])
def test_a_program_without_the_counts_reads_none(monkeypatch, name):
    bare = [_span(s.name, s.id, s.parent, s.start_ns, s.end_ns) for s in PROGRAM]
    assert harness.load_metric(name).read(_trace(bare, monkeypatch, OPS, HARNESS)) is None
    t = _trace(PROGRAM, monkeypatch, OPS, HARNESS)
    monkeypatch.delattr(profiling, "spans_between")  # a program without the tracer
    assert harness.load_metric(name).read(t) is None


@pytest.mark.gpu
def test_a_short_traced_run_on_the_card():
    """The cell's harness on the card at the small size, in a process of its
    own (a test process may have loaded JAX, which the harness refuses):
    correct, the split into stages bitwise the entry, and the cell's per-layer
    metrics read (the graphed Farnebäck chain's among them: every flow after
    the warm run's capture a replay)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = ("import json; from benchmark.tests.test_bench_registration_study import run_small; "
            "print(json.dumps(run_small(1, 'cuda')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=manifest.ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert all(v["value"] == 0 for k, v in res["checks"].items() if k.startswith("split."))
    assert PER_LAYER <= set(res["metrics"]), res["metrics"]
    assert res["metrics"]["register.graph_replay_share"]["value"] == 1.0
