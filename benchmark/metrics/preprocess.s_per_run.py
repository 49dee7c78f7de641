"""Seconds a run in the preprocessing head (the stack's upload, the area
shrink, the Gaussian, the min-max): the span around ``preprocess_head``."""


def read(t):
    return t.spans.mean("preprocess")
