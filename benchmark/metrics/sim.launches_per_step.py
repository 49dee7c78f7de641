"""Device operations (kernels, copies, sets) an explicit-Euler step of the
KS simulation: those that started inside ``sim`` spans of the profiled
window, over the spans and the steps each makes."""


def read(t):
    n_spans = t.device.span_count("sim")
    steps = t.ctx.get("steps_per_request")
    if not n_spans or not steps:
        return None
    return len(t.device.ops_in("sim")) / (n_spans * steps)
