"""Share of the registration chain's flows that ran as a replayed CUDA
graph: the program's ``farneback.graph_replays`` over its
``farneback.flows``, both counted under the ``register`` spans of the
profiled window. A program that counts no replays there reads None."""

from benchmark import program_spans


def read(t):
    spans = program_spans.recorded(t)
    if spans is None or not any("farneback.graph_replays" in s.counts for s in spans):
        return None
    flows = program_spans.count_under(spans, "register", "farneback.flows")
    if not flows:
        return None
    return program_spans.count_under(spans, "register", "farneback.graph_replays") / flows
