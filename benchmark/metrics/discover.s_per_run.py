"""Seconds a run after registration (local-poly datasets, the batched
patch fits, the held-out evaluation): the span around ``discover``."""


def read(t):
    return t.spans.mean("discover")
