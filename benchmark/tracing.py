"""Spans taken by the harness around calls into the port's public stages,
and the reading of a ``torch.profiler`` trace of a bounded window.

A span ends with a device synchronize, so its seconds hold the device work
its stage queued. Inside a profiled window each span is also a
``record_function`` range, so the device events that ran inside it can be
told apart: a stage's work cannot start before its span opens, and the
synchronize finishes it before the span closes.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from benchmark import stats

SPAN_PREFIX = "bench:"


class Spans:
    """Host-clock spans by name, each ended by a synchronize."""

    def __init__(self) -> None:
        self.seconds: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name].append(seconds)

    def mean(self, name: str) -> float | None:
        v = self.seconds.get(name)
        return sum(v) / len(v) if v else None


@dataclass
class DeviceTrace:
    """What one profiled window recorded: device operations as (name,
    start ns, end ns), harness spans as (name, start ns, end ns), and the
    window's own bounds on the same clock."""

    ops: list[tuple[str, int, int]] = field(default_factory=list)
    spans: list[tuple[str, int, int]] = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        return stats.busy_ns([(a, b) for _, a, b in self.ops], self.start_ns, self.end_ns) / 1e9

    def ops_in(self, span: str) -> list[tuple[str, int, int]]:
        """Device operations that started inside a span of that name."""
        ranges = [(a, b) for n, a, b in self.spans if n == span]
        return [op for op in self.ops if any(a <= op[1] <= b for a, b in ranges)]

    def span_count(self, span: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == span)

    def top_ops(self, k: int = 10) -> list[list]:
        """Device seconds by operation name (C++ template names cut to
        their first 120 characters)."""
        by_name: dict[str, int] = defaultdict(int)
        for n, a, b in self.ops:
            by_name[n[:120]] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def top_idle(self, k: int = 10) -> list[list]:
        """Idle device time summed by the innermost harness span the gap
        falls in ("between spans" outside every span)."""
        by_span: dict[str, int] = defaultdict(int)
        for a, b in stats.idle_gaps([(x, y) for _, x, y in self.ops], self.start_ns, self.end_ns):
            mid = (a + b) // 2
            inside = [(sb - sa, n) for n, sa, sb in self.spans if sa <= mid <= sb]
            by_span[min(inside)[1] if inside else "between spans"] += b - a
        top = sorted(by_span.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]


class DeviceBusy:
    """While open, ``torch.profiler`` records CUDA activity alone (no host
    events); on close, ``busy_s`` is the union of the device operations'
    intervals in seconds and ``n_ops`` their number. It wraps a whole
    measured window, so a metric read from it covers all of the window's
    work."""

    busy_s: float = 0.0
    n_ops: int = 0

    def __enter__(self) -> "DeviceBusy":
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        intervals = [(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in self._prof.profiler.kineto_results.events() if e.device_type() == cuda]
        del self._prof
        self.busy_s = stats.busy_ns(intervals) / 1e9
        self.n_ops = len(intervals)
        return False


def profile_window(fn) -> DeviceTrace:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activity) and
    read the kineto events as they are: building the profiler's event tree
    for a few hundred thousand events takes about a minute."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            fn()
            torch.cuda.synchronize()
    tr = DeviceTrace()
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kineto mirrors each record_function range on the device's
            # timeline; those ranges are not device work
            if not e.name().startswith(SPAN_PREFIX):
                tr.ops.append((e.name(), a, b))
        elif e.name().startswith(SPAN_PREFIX):
            name = e.name()[len(SPAN_PREFIX):]
            if name == "window":
                tr.start_ns, tr.end_ns = a, b
            else:
                tr.spans.append((name, a, b))
    if tr.end_ns <= tr.start_ns:
        raise RuntimeError("the profiler recorded no window range")
    return tr
