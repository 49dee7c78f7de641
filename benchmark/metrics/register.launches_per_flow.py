"""Device operations (kernels, copies, sets) a flow of the registration
chain: those that started inside ``register`` spans of the profiled
window, over the spans and the flows each makes."""


def read(t):
    n_spans = t.device.span_count("register")
    flows = t.ctx.get("flows_per_request")
    if not n_spans or not flows:
        return None
    return len(t.device.ops_in("register")) / (n_spans * flows)
