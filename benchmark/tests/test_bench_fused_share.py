"""The reader of ``farneback.fused_share`` on hand-built spans: the
update kernel's launches over the flow's iterations in every span of the
window, 0 where every update ran plain, and None where the program has no
iterations there or no kernel wrappers."""

import importlib.util

import pytest

from benchmark import harness
from benchmark.tracing import DeviceTrace
from pdx_torch.utils import profiling
from pdx_torch.utils.profiling import Span

NAME = "farneback.fused_share"


def _span(name, sid, parent, start, end, **counts):
    s = Span(name, sid, parent, sid if parent is None else 1, start)
    s.end_ns, s.counts = end, dict(counts)
    return s


@pytest.fixture
def recorded(monkeypatch):
    """Make the tracer report ``spans`` for the window."""
    def use(spans):
        monkeypatch.setattr(profiling, "spans_between",
                            lambda a, b: [s for s in spans if s.start_ns >= a and s.end_ns <= b])
    return use


def _read(ops=(), start=0, end=10_000_000):
    t = harness.TraceData({}, DeviceTrace(ops=list(ops), start_ns=start, end_ns=end), {}, {})
    return harness.load_metric(NAME).read(t)


def _it(n, launches):
    return {"farneback.iterations": n, **({"flow_update.launches": launches} if launches is not None else {})}


def test_reads_the_update_launches_over_the_iterations_in_every_span(recorded):
    recorded([
        _span("pair_flows", 1, None, 0, 5_000_000),
        _span("farneback.level", 2, 1, 100_000, 1_000_000, **_it(3, 3)),
        _span("farneback.refine", 3, 1, 1_100_000, 1_500_000, **_it(2, 2)),
        _span("register", 4, None, 6_000_000, 9_000_000),
        _span("farneback.chain_flow", 5, 4, 6_100_000, 6_200_000,  # a replay: its capture's counts
              **{"farneback.flows": 1, "farneback.graph_replays": 1, **_it(27, 27)}),
        _span("farneback.level", 6, None, 9_100_000, 9_200_000, **_it(5, None)),  # updates left plain
        _span("farneback.level", 7, None, 20_000_000, 21_000_000, **_it(100, None)),  # outside the window
    ])
    assert _read() == pytest.approx(32 / 37)
    recorded([_span("farneback.level", 1, None, 0, 10, **_it(3, 3))])
    assert _read() == 1.0


def test_updates_that_launch_no_kernel_read_zero(recorded):
    recorded([_span("farneback.level", 1, None, 0, 10, **_it(3, None)),
              _span("farneback.refine", 2, None, 20, 30, **_it(2, None))])
    assert _read([("k", 0, 100)]) == 0.0


@pytest.mark.parametrize("spans", [
    [],
    [_span("farneback.level", 1, None, 0, 10)],  # no counts
    [_span("farneback.level", 1, None, 0, 10, **_it(0, 0))],  # nothing to divide by
], ids=["nothing", "no_counts", "no_iterations"])
def test_a_window_without_iterations_reads_none(recorded, spans):
    recorded(spans)
    assert _read([("k", 0, 100)]) is None


def test_a_program_without_the_kernel_wrappers_reads_none(recorded, monkeypatch):
    """The program before the kernels (no ``ops/kernels/flow_windows``)."""
    recorded([_span("farneback.level", 1, None, 0, 10, **_it(3, None))])
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".flow_windows") else find_spec(name, *a))
    assert _read([("k", 0, 100)]) is None


def test_no_trace_or_no_tracer_reads_none(recorded, monkeypatch):
    recorded([_span("farneback.level", 1, None, 1, 5, **_it(3, 3))])
    assert harness.load_metric(NAME).read(harness.TraceData({}, None, {}, {})) is None
    assert _read(start=20, end=100) is None  # spans outside the window
    monkeypatch.delattr(profiling, "spans_between")
    assert _read([("k", 0, 100)]) is None
