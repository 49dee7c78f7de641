"""Seconds a run in the KS simulation: the span around ``prepare_frames``."""


def read(t):
    return t.spans.mean("sim")
