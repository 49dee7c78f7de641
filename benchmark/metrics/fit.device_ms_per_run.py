"""Device milliseconds a run after the simulation: the device time inside
the program's ``fit`` spans of the profiled window (u_t, the kernel's
statistics, the STRidge grid, the selection's read, the rollout), over
those spans."""

from benchmark import program_spans


def read(t):
    spans = program_spans.recorded(t)
    fits = program_spans.named(spans, "fit") if spans else []
    if not fits:
        return None
    return program_spans.device_ns(t.device.ops, fits) / 1e6 / len(fits)
