"""Seconds a run in the batched float64 pair flows: the port's own stage
timer's ``pair_flows`` stage, ended by a synchronize."""


def read(t):
    return t.spans.mean("pair_flows")
