"""Seconds a run after the simulation: the span around the grid fast path
on the prepared frames (u_t, the kernel's statistics, the STRidge grid,
selection, the rollout)."""


def read(t):
    return t.spans.mean("fit")
