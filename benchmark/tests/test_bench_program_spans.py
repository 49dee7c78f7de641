"""The readers of the program's spans, on hand-built device traces and
spans: device time clipped at span edges, overlapping operations counted
once, counts summed over nested spans, None where nothing was recorded."""

import pytest

from benchmark import harness, program_spans
from benchmark.tracing import DeviceTrace
from pdx_torch.utils import profiling
from pdx_torch.utils.profiling import Span


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


def _t(ops, start=0, end=10_000_000):
    return harness.TraceData({}, DeviceTrace(ops=ops, start_ns=start, end_ns=end), {}, {})


def _read(name, t):
    return harness.load_metric(name).read(t)


def test_device_time_is_clipped_at_span_edges_and_counted_once():
    spans = [_span("s", 1, None, 1000, 2000), _span("s", 2, None, 5000, 6000)]
    ops = [("k", 500, 1200),  # 200 inside the first span
           ("k", 1100, 1300), ("k", 1250, 1400),  # overlapping: 1100-1400 once
           ("k", 1900, 5100),  # 100 in each span
           ("k", 7000, 8000)]  # outside both
    assert program_spans.device_ns(ops, spans) == (1400 - 1000) + (2000 - 1900) + (5100 - 5000)
    assert program_spans.device_ns([], spans) == 0


def test_counts_are_summed_over_nested_spans():
    spans = [_span("outer", 1, None, 0, 100, n=1), _span("inner", 2, 1, 10, 20, n=2),
             _span("deeper", 3, 2, 12, 15, n=4), _span("other", 4, None, 200, 300, n=8)]
    assert program_spans.count_under(spans, "outer", "n") == 7
    assert program_spans.count_under(spans, "inner", "n") == 6
    assert program_spans.count_under(spans, "missing", "n") == 0


def test_sim_and_fit_read_device_time_per_step_and_per_run(recorded):
    recorded([
        _span("prepare_frames", 1, None, 0, 3_000_000),
        _span("ks2d.sim", 2, 1, 0, 2_000_000, **{"ks2d.euler_steps": 2000}),
        _span("fit", 3, None, 3_000_000, 4_000_000),
        _span("ks2d.grid", 4, 3, 3_100_000, 3_500_000, **{"stridge.iterations": 3}),
    ])
    ops = [("k", 100_000, 400_000), ("k", 300_000, 700_000),  # 600 us in the simulation
           ("k", 2_900_000, 3_200_000)]  # 100 us before the fit and 200 us inside it
    t = _t(ops)
    assert _read("sim.device_us_per_step", t) == pytest.approx(600.0 / 2000)
    assert _read("fit.device_ms_per_run", t) == pytest.approx(0.2)


def test_register_reads_device_time_per_counted_flow(recorded):
    recorded([
        _span("register", 1, None, 0, 9_000_000),
        _span("farneback.chain_flow", 2, 1, 1_000_000, 2_000_000, **{"farneback.flows": 1}),
        _span("farneback.level", 3, 2, 1_100_000, 1_500_000, **{"farneback.iterations": 5}),
        _span("farneback.chain_flow", 4, 1, 3_000_000, 4_000_000, **{"farneback.flows": 1}),
    ])
    ops = [("k", 1_200_000, 1_700_000), ("k", 3_900_000, 4_500_000), ("k", 5_000_000, 6_000_000)]
    assert _read("register.device_ms_per_flow", _t(ops)) == pytest.approx((0.5 + 0.1) / 2)


def test_fista_iterations_are_read_per_sweep(recorded):
    recorded([_span("discover_lasso_sweep", 1, None, 0, 10, **{"fista.iterations": 3, "fista.host_syncs": 2}),
              _span("discover_lasso_sweep", 2, None, 20, 30, **{"fista.iterations": 5})])
    assert _read("transport.fista_iterations", _t([])) == 4.0
    recorded([_span("discover_lasso_sweep", 1, None, 0, 10)])
    assert _read("transport.fista_iterations", _t([])) is None


NEW = ("sim.device_us_per_step", "fit.device_ms_per_run", "register.device_ms_per_flow", "transport.fista_iterations")


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_none(recorded, name):
    recorded([])
    assert _read(name, _t([("k", 0, 100)])) is None
    recorded([_span("ks2d.sim", 1, None, 0, 10), _span("farneback.chain_flow", 2, None, 20, 30)])  # no counts
    assert _read(name, _t([("k", 0, 100)])) is None
    assert _read(name, harness.TraceData({}, None, {}, {})) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "spans_between")
    assert _read(name, _t([("k", 0, 100)])) is None


@pytest.mark.parametrize("name", NEW)
def test_spans_outside_the_window_are_not_read(recorded, name):
    recorded([_span("ks2d.sim", 1, None, 0, 10, **{"ks2d.euler_steps": 5}), _span("fit", 2, None, 0, 10),
              _span("farneback.chain_flow", 3, None, 0, 10, **{"farneback.flows": 1}),
              _span("discover_lasso_sweep", 4, None, 0, 10, **{"fista.iterations": 3})])
    assert _read(name, _t([("k", 0, 100)], start=20, end=100)) is None
