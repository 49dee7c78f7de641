"""Milliseconds a step of the DIS registration chain: the span around
``register_dis``, over the flows a run makes (one a step, a frame after the
first)."""


def read(t):
    s = t.spans.mean("dis_chain")
    n = t.ctx.get("flows_per_request")
    return None if s is None or not n else 1e3 * s / n
