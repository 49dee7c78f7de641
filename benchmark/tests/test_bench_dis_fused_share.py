"""The reader of ``dis.fused_share`` on hand-built spans: the inverse
search kernel's launches over the DIS flow's pyramid levels in every span
of the window, lower where a level ran the plain passes, and None where the
program has no levels there or no kernel wrappers."""

import importlib.util

import pytest

from benchmark import harness
from benchmark.tracing import DeviceTrace
from pdx_torch.utils import profiling
from pdx_torch.utils.profiling import Span

NAME = "dis.fused_share"


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


def _level(launched):
    return {"dis.levels": 1, "dis.iterations": 8, **({"dis_inverse_search.launches": 1} if launched else {})}


def _flow(sid, start, launched):
    """A flow span and its four levels, ``launched`` saying which launched the kernel."""
    spans = [_span("dis.flow", sid, None, start, start + 500_000, **{"dis.flows": 1})]
    for k, kernel in enumerate(launched):
        a = start + 1_000 + 100_000 * k
        spans.append(_span("dis.level", sid + 1 + k, sid, a, a + 90_000, **_level(kernel)))
    return spans


def test_every_level_on_the_kernel_reads_one(recorded):
    recorded(_flow(1, 0, [True] * 4) + _flow(10, 1_000_000, [True] * 4))
    assert _read() == 1.0


def test_a_level_left_plain_lowers_the_share(recorded):
    recorded(_flow(1, 0, [True] * 4) + _flow(10, 1_000_000, [True, True, True, False])
             + _flow(20, 20_000_000, [False] * 4))  # outside the window
    assert _read() == pytest.approx(7 / 8)
    recorded(_flow(1, 0, [False] * 4))
    assert _read([("k", 0, 100)]) == 0.0


@pytest.mark.parametrize("spans", [
    [],
    [_span("dis.flow", 1, None, 0, 10)],  # no counts
    [_span("dis.level", 1, None, 0, 10, **{"dis.levels": 0})],  # nothing to divide by
], ids=["nothing", "no_counts", "no_levels"])
def test_a_window_without_levels_reads_none(recorded, spans):
    recorded(spans)
    assert _read([("k", 0, 100)]) is None


def test_a_program_without_the_kernel_wrappers_reads_none(recorded, monkeypatch):
    """The program before the kernels (no ``ops/kernels/dis_patches``)."""
    recorded(_flow(1, 0, [False] * 4))
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".dis_patches") else find_spec(name, *a))
    assert _read([("k", 0, 100)]) is None


def test_no_trace_or_no_tracer_reads_none(recorded, monkeypatch):
    recorded(_flow(1, 0, [True] * 4))
    assert harness.load_metric(NAME).read(harness.TraceData({}, None, {}, {})) is None
    assert _read(start=20, end=100) is None  # spans outside the window
    monkeypatch.delattr(profiling, "spans_between")
    assert _read([("k", 0, 100)]) is None
