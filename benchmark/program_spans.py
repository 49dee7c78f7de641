"""The program's own spans laid over a profiled window's device trace.

The port's tracer (``pdx_torch.utils.profiling``) records spans while a
``torch.profiler`` session records, stamped with ``time.time_ns()``, the
clock the profiler stamps its events with. A reader takes the spans that
lie inside the profiled window and the device operations inside them. A
program without the tracer, or one that recorded nothing in the window,
gives ``None``.
"""

from __future__ import annotations

import bisect

from benchmark import stats


def recorded(t) -> list | None:
    """The program's spans inside ``t``'s profiled window, or None."""
    if t.device is None:
        return None
    try:
        from pdx_torch.utils.profiling import spans_between
    except ImportError:
        return None
    return spans_between(t.device.start_ns, t.device.end_ns) or None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def count_under(spans, name: str, count: str) -> int:
    """The count ``count`` summed over the spans named ``name`` and every
    span nested inside one of them."""
    by_id = {s.id: s for s in spans}
    total = 0
    for s in spans:
        p = s
        while p is not None and p.name != name:
            p = by_id.get(p.parent)
        if p is not None:
            total += s.counts.get(count, 0)
    return total


def device_ns(ops, spans) -> int:
    """Device time inside ``spans``: for each span the union of the device
    operations' intervals clipped to it (operations that overlap count
    once), summed over the spans."""
    merged = stats.interval_union([(a, b) for _, a, b in ops])
    starts = [a for a, _ in merged]
    total = 0
    for s in spans:
        i = max(0, bisect.bisect_right(starts, s.start_ns) - 1)
        while i < len(merged) and merged[i][0] < s.end_ns:
            a, b = merged[i]
            total += max(0, min(b, s.end_ns) - max(a, s.start_ns))
            i += 1
    return total
