"""Per-stage wall-clock timer and the program's tracer (port of
``pdx/utils/profiling.py:17-76``, with spans and counts added).

``with timer.stage("name"):`` adds the stage's seconds to ``timer.stages``.
The timer waits for the CUDA card at the end of each stage, so a stage's
time includes the device work it queued, not only its launches. Without a
timer the pipelines use :func:`null_stage`.

The tracer. ``with span("name"):`` records a :class:`Span`: its name, its
parent, the run id that every span of one top-level span shares, its start
and end from ``time.time_ns()`` (the Unix-epoch clock that ``torch.profiler``
stamps its events with, so spans lie over a device trace), and the counts
added while it was the innermost open span. ``count(name, n)`` adds to a
process-wide total always and, while recording, to the innermost open span.
Opening or closing a span does no synchronize, launches nothing, reads
nothing from the device and opens no ``record_function``: kineto mirrors
each such range on the device's timeline as a device-typed event, which a
reader of the trace would count as device work.

Spans are recorded while a stage of a :class:`StageTimer` is open, or while
a ``torch.profiler`` session records; otherwise :func:`span` is one flag
check and a shared no-op context. Closed spans are kept in memory, at most
``SPAN_CAP`` of them (the oldest dropped), and read by
:func:`spans_between`; :func:`span_tree` gives each span's name path and
self intervals, and :func:`report` prints them nested, with self time and
counts.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_CAP = 65_536


class Span:
    """One recorded span; ``end_ns`` is 0 while it is open."""

    __slots__ = ("name", "id", "parent", "run", "start_ns", "end_ns", "counts")

    def __init__(self, name: str, id: int, parent: int | None, run: int, start_ns: int) -> None:
        self.name, self.id, self.parent, self.run = name, id, parent, run
        self.start_ns, self.end_ns = start_ns, 0
        self.counts: dict[str, int] = {}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, run={self.run}, "
                f"{(self.end_ns - self.start_ns) / 1e6:.3f} ms, {self.counts})")


_ids = itertools.count(1)
_closed: collections.deque[Span] = collections.deque(maxlen=SPAN_CAP)
_totals: collections.Counter[str] = collections.Counter()
_lock = threading.Lock()  # guards the totals and the open-stage count
_local = threading.local()  # each thread's stack of open spans
_open_stages = [0]  # stages of any StageTimer open now


def recording() -> bool:
    """Whether :func:`span` records: a timer's stage is open, or a
    ``torch.profiler`` session records."""
    return _open_stages[0] > 0 or _autograd_profiler._is_profiler_enabled


def _stack() -> list[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _SpanScope:
    __slots__ = ("name", "span")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> Span:
        stack = _stack()
        sid = next(_ids)
        top = stack[-1] if stack else None
        self.span = Span(self.name, sid, top.id if top else None, top.run if top else sid, time.time_ns())
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        sp = self.span
        sp.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # closed out of order: drop what it left open above it
            del stack[stack.index(sp):]
        _closed.append(sp)
        return False


_NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` while recording (the context yields the
    :class:`Span`), else a shared no-op context (yields None)."""
    if not (_open_stages[0] or _autograd_profiler._is_profiler_enabled):
        return _NULL_SPAN
    return _SpanScope(name)


def count(name: str, n: int = 1, into: Span | None = None) -> None:
    """Add ``n`` to the process-wide total ``name``, and to ``into`` or,
    while recording, to the innermost open span of this thread. Inside
    :func:`held_counts` the count goes to the holder alone."""
    held = getattr(_local, "held", None)
    if held is not None:
        held[name] += n
        return
    with _lock:
        _totals[name] += n
    if into is None and recording():
        stack = _stack()
        into = stack[-1] if stack else None
    if into is not None:
        into.counts[name] = into.counts.get(name, 0) + n


@contextlib.contextmanager
def held_counts():
    """Yields a Counter that takes this thread's counts while the context is
    open, in place of the totals and the spans: the counts of work that is
    recorded and not run (a CUDA graph's capture), to be counted when it runs."""
    held, _local.held = getattr(_local, "held", None), collections.Counter()
    try:
        yield _local.held
    finally:
        _local.held = held


def total(name: str) -> int:
    """The process-wide total of a count (0 if never counted)."""
    with _lock:
        return _totals[name]


def spans_between(start_ns: int, end_ns: int) -> list[Span]:
    """The kept closed spans that lie inside [start_ns, end_ns] (the
    ``time.time_ns()`` clock), in the order they closed."""
    return [s for s in list(_closed) if s.start_ns >= start_ns and s.end_ns <= end_ns]


Interval = collections.namedtuple("Interval", "start_ns end_ns")


def span_tree(spans: list[Span]) -> list[tuple[tuple[str, ...], Span, list[Interval]]]:
    """Each of ``spans`` in order of start, as (its name path through its
    parents among ``spans``, the span, its self intervals: the parts of it
    that none of its children among ``spans`` covers)."""
    by_id = {s.id: s for s in spans}
    children: dict[int, list[tuple[int, int]]] = collections.defaultdict(list)
    for s in spans:
        if s.parent in by_id:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = []
    for s in sorted(spans, key=lambda s: s.start_ns):
        names, p = [s.name], s
        while p.parent in by_id:
            p = by_id[p.parent]
            names.append(p.name)
        own, at = [], s.start_ns
        for a, b in sorted(children.get(s.id, ())):
            a = min(a, s.end_ns)
            if a > at:
                own.append(Interval(at, a))
            at = max(at, b)
        if s.end_ns > at:
            own.append(Interval(at, s.end_ns))
        out.append((tuple(reversed(names)), s, own))
    return out


def report(spans: list[Span] | None = None) -> str:
    """The spans (default: every kept one) as a tree of their name paths:
    calls, total and self seconds (a span's time less what its children
    cover), and the counts summed."""
    spans = list(_closed) if spans is None else spans
    rows: dict[tuple[str, ...], list] = {}  # path -> [calls, total ns, self ns, counts]
    for path, s, own in span_tree(spans):
        row = rows.setdefault(path, [0, 0, 0, collections.Counter()])
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += sum(b - a for a, b in own)
        row[3].update(s.counts)
    lines = [f"{'span':<44}{'calls':>7}{'total s':>11}{'self s':>11}  counts"]
    for p in sorted(rows, key=lambda p: [list(rows).index(p[:k]) for k in range(1, len(p) + 1)]):
        calls, tot, own, counts = rows[p]
        label = "  " * (len(p) - 1) + p[-1]
        extra = " ".join(f"{k}={v}" for k, v in counts.items())
        lines.append(f"{label:<44}{calls:>7}{tot / 1e9:>11.4f}{own / 1e9:>11.4f}  {extra}".rstrip())
    return "\n".join(lines)


class StageTimer:
    """Accumulates named stage durations, each ended by a device synchronize.
    Each stage is also a span, and the tracer records while it is open."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}  # in the order the stages first ran
        self._span_ns: list[int] = []  # the first stage's start and the last one's end

    @contextlib.contextmanager
    def stage(self, name: str):
        with _lock:
            _open_stages[0] += 1
        try:
            with _SpanScope(name) as sp:
                t0 = time.perf_counter()
                try:
                    yield sp
                finally:
                    if torch.cuda.is_initialized():
                        torch.cuda.synchronize()
                    self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
        finally:
            with _lock:
                _open_stages[0] -= 1
            self._span_ns = [self._span_ns[0] if self._span_ns else sp.start_ns, sp.end_ns]

    def report(self) -> str:
        """The stage table, then the spans recorded inside the stages."""
        total_s = sum(self.stages.values())
        lines = [f"{'stage':<28}{'seconds':>10}{'share':>8}"]
        for name, dt in self.stages.items():
            lines.append(f"{name:<28}{dt:>10.4f}{dt / max(total_s, 1e-12):>8.1%}")
        lines.append(f"{'total':<28}{total_s:>10.4f}")
        if self._span_ns:
            lines += ["", report(spans_between(*self._span_ns))]
        return "\n".join(lines)


def null_stage(name: str, *_args, **_kwargs):
    """Stage for runs without a timer: no time kept and no synchronize; a
    span while recording (under a ``torch.profiler`` session), else a no-op."""
    return span(name)
