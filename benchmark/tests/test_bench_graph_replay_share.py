"""The reader of ``register.graph_replay_share`` on hand-built spans: the
program's graph replays over its flows under the ``register`` spans of the
window, and None where the program counts no replays."""

import pytest

from benchmark import harness
from benchmark.tracing import DeviceTrace
from pdx_torch.utils import profiling
from pdx_torch.utils.profiling import Span

NAME = "register.graph_replay_share"


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


def test_register_reads_the_share_of_flows_replayed_as_a_graph(recorded):
    recorded([
        _span("register", 1, None, 0, 9_000_000),
        _span("farneback.chain_flow", 2, 1, 1_000_000, 2_000_000, **{"farneback.flows": 1}),  # eager, captured
        _span("farneback.level", 3, 2, 1_100_000, 1_500_000, **{"farneback.iterations": 5}),
        _span("farneback.chain_flow", 4, 1, 3_000_000, 3_100_000,
              **{"farneback.flows": 1, "farneback.iterations": 5, "farneback.graph_replays": 1}),
        _span("farneback.chain_flow", 5, 1, 4_000_000, 4_100_000,
              **{"farneback.flows": 1, "farneback.iterations": 5, "farneback.graph_replays": 1}),
        _span("farneback.chain_flow", 6, None, 9_500_000, 9_600_000,  # outside every register span
              **{"farneback.flows": 1, "farneback.graph_replays": 1}),
    ])
    assert _read() == pytest.approx(2 / 3)
    recorded([_span("register", 1, None, 0, 10),
              _span("farneback.chain_flow", 2, 1, 1, 5, **{"farneback.flows": 1, "farneback.graph_replays": 1})])
    assert _read() == 1.0


@pytest.mark.parametrize("spans", [
    [],
    [_span("register", 1, None, 0, 10), _span("farneback.chain_flow", 2, 1, 1, 5)],  # no counts
    [_span("register", 1, None, 0, 10),  # a chain that counts no replays, as the parent's
     _span("farneback.chain_flow", 2, 1, 1, 5, **{"farneback.flows": 1})],
], ids=["nothing", "no_counts", "no_replays"])
def test_a_chain_without_replays_reads_none(recorded, spans):
    recorded(spans)
    assert _read([("k", 0, 100)]) is None


def test_no_trace_or_no_tracer_reads_none(recorded, monkeypatch):
    recorded([_span("register", 1, None, 0, 10),
              _span("farneback.chain_flow", 2, 1, 1, 5, **{"farneback.flows": 1, "farneback.graph_replays": 1})])
    assert harness.load_metric(NAME).read(harness.TraceData({}, None, {}, {})) is None
    assert _read(start=20, end=100) is None  # spans outside the window
    monkeypatch.delattr(profiling, "spans_between")
    assert _read([("k", 0, 100)]) is None
