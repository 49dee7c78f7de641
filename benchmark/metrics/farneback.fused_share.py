"""Share of the Farnebäck flow updates that launched the hand-written
kernel: the program's ``flow_update.launches`` (one a kernel update,
counted where ``ops/kernels/flow_windows`` launches it) over its
``farneback.iterations``, both summed over the program spans of the
profiled window (a replayed chain step counts its capture's). It falls
below 1 wherever an update runs the plain code. A program without that
wrapper module, or with no iterations in the window, reads None."""

import importlib.util

from benchmark import program_spans

WRAPPERS = "pdx_torch.ops.kernels.flow_windows"


def read(t):
    spans = program_spans.recorded(t)
    if spans is None or importlib.util.find_spec(WRAPPERS) is None:
        return None
    iterations = sum(s.counts.get("farneback.iterations", 0) for s in spans)
    if not iterations:
        return None
    return sum(s.counts.get("flow_update.launches", 0) for s in spans) / iterations
