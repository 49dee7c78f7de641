"""Device milliseconds a flow of the Farnebäck registration chain: the
device time inside the program's ``farneback.chain_flow`` spans of the
profiled window (the flow's pyramid, its re-warp pass, the smooth and the
warp), over the flows the program counted in them (``farneback.flows``)."""

from benchmark import program_spans


def read(t):
    spans = program_spans.recorded(t)
    if spans is None:
        return None
    flows = program_spans.count_under(spans, "farneback.chain_flow", "farneback.flows")
    if not flows:
        return None
    return program_spans.device_ns(t.device.ops, program_spans.named(spans, "farneback.chain_flow")) / 1e6 / flows
