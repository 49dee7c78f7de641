"""Device microseconds an explicit-Euler step of the KS simulation: the
device time inside the program's ``ks2d.sim`` spans of the profiled window,
over the Euler steps the program counted in them (``ks2d.euler_steps``)."""

from benchmark import program_spans


def read(t):
    spans = program_spans.recorded(t)
    if spans is None:
        return None
    steps = program_spans.count_under(spans, "ks2d.sim", "ks2d.euler_steps")
    if not steps:
        return None
    return program_spans.device_ns(t.device.ops, program_spans.named(spans, "ks2d.sim")) / 1e3 / steps
