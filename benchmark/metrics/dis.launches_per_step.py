"""Device operations (kernels, copies, sets) a step of the DIS chain: those
that started inside ``dis_chain`` spans of the profiled window, over the
spans and the flows each makes (one a step)."""


def read(t):
    n_spans = t.device.span_count("dis_chain")
    steps = t.ctx.get("flows_per_request")
    if not n_spans or not steps:
        return None
    return len(t.device.ops_in("dis_chain")) / (n_spans * steps)
