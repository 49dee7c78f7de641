"""The benchmark's arithmetic: window statistics, the union of device
intervals, the card's published peaks and the roofline counts.

Nothing here touches a device, so every function is tested on the CPU.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12


def run_s(window_s: float, n_runs: int) -> float:
    """Seconds a discovery run: the whole window over the runs completed in it."""
    if n_runs <= 0:
        raise ValueError("no run completed in the window")
    return window_s / n_runs


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def interval_union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge (start, end) intervals into disjoint ones, sorted. Device
    operations on several streams may overlap; each instant counts once."""
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_ns(intervals: list[tuple[int, int]], lo: int | None = None, hi: int | None = None) -> int:
    """Nanoseconds covered by the union of ``intervals``, clipped to [lo, hi]."""
    total = 0
    for a, b in interval_union(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        total += max(0, b - a)
    return total


def idle_gaps(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for a, b in interval_union(intervals):
        if b <= lo or a >= hi:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def roofline_s(flops: float, nbytes: float, flop_per_s: float = FP64_FLOP_PER_S) -> tuple[float, str]:
    """(least seconds the card could take, what bounds it)."""
    t_ops, t_bytes = flops / flop_per_s, nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Float64 operations a sample of the KS true-library statistics needs:
# u_t (2), the 5-point Laplacian (8), the biharmonic as the Laplacian of the
# Laplacian (8), |grad u|^2 (7), and the statistics of q = 3 terms: one FMA
# (2) a Gram (6), b (3) and syy (1) entry, one add a sx (3) and sy (1) entry.
KS_GRAM_FLOPS_PER_SAMPLE = 2 + 8 + 8 + 7 + 2 * (6 + 3 + 1) + 3 + 1
KS_GRAM_STATS = 3 * 4 // 2 + 2 * 3 + 2  # G's upper triangle, b, sx, n, sy, syy


def ks_gram_count(frames: int, nx: int, ny: int, itemsize: int = 8) -> tuple[float, float]:
    """(flops, bytes) of the true-library statistics of a (frames, nx, ny)
    field: the field read once (u_t comes from the same frames), the
    statistics written once, the operations above on every sample of the
    first frames - 1 frames."""
    samples = (frames - 1) * nx * ny
    return samples * KS_GRAM_FLOPS_PER_SAMPLE, frames * nx * ny * itemsize + KS_GRAM_STATS * 8
