"""Share of the DIS pyramid levels whose inverse search launched the
hand-written kernel: the program's ``dis_inverse_search.launches`` (one a
kernel search, counted where ``ops/kernels/dis_patches`` launches it) over
its ``dis.levels``, both summed over the program spans of the profiled
window. It falls below 1 wherever a level runs the plain passes. A program
without that wrapper module, or with no levels in the window, reads None."""

import importlib.util

from benchmark import program_spans

WRAPPERS = "pdx_torch.ops.kernels.dis_patches"


def read(t):
    spans = program_spans.recorded(t)
    if spans is None or importlib.util.find_spec(WRAPPERS) is None:
        return None
    levels = sum(s.counts.get("dis.levels", 0) for s in spans)
    if not levels:
        return None
    return sum(s.counts.get("dis_inverse_search.launches", 0) for s in spans) / levels
