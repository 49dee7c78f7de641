"""Milliseconds a flow of the Farnebäck registration chain: the span
around ``register``, over the flows a run makes (one a frame after the
first)."""


def read(t):
    s = t.spans.mean("register")
    n = t.ctx.get("flows_per_request")
    return None if s is None or not n else 1e3 * s / n
