"""Seconds a registration-quality sweep (the mean flow magnitude of every
consecutive pair, one batched float64 call): the span around
``registration_quality``, over the sweeps the program counted a span
(``quality.sweeps`` of the program spans whose middle lies in a ``quality``
span of the profiled window). A program that counts no sweeps reads None."""

from benchmark import program_spans


def read(t):
    s = t.spans.mean("quality")
    spans = program_spans.recorded(t)
    ranges = [(a, b) for n, a, b in t.device.spans if n == "quality"]
    if s is None or spans is None or not ranges:
        return None
    sweeps = sum(sp.counts.get("quality.sweeps", 0) for sp in spans
                 if any(a <= (sp.start_ns + sp.end_ns) // 2 <= b for a, b in ranges))
    return s * len(ranges) / sweeps if sweeps else None
