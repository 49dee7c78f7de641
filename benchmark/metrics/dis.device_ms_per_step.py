"""Device milliseconds a DIS flow of the registration chain: the device time
inside the ``dis_chain`` spans of the profiled window (each ended by a
synchronize, so it holds all of its steps' work), over the flows the
program counted there (``dis.flows`` of the program spans whose middle lies
in one). A program that counts no DIS flows reads None."""

from types import SimpleNamespace

from benchmark import program_spans


def read(t):
    spans = program_spans.recorded(t)
    chains = [(a, b) for n, a, b in t.device.spans if n == "dis_chain"]
    if spans is None or not chains:
        return None
    flows = sum(s.counts.get("dis.flows", 0) for s in spans
                if any(a <= (s.start_ns + s.end_ns) // 2 <= b for a, b in chains))
    if not flows:
        return None
    ranges = [SimpleNamespace(start_ns=a, end_ns=b) for a, b in chains]
    return program_spans.device_ns(t.device.ops, ranges) / 1e6 / flows
