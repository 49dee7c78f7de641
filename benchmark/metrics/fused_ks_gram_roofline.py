"""Share of its roofline that the public call ``fused_ks_gram`` (kernel K1)
reaches at the cell's own field: the least time the card could take for
the statistics problem (the float64 field read once, the statistics
written once, the float64 operations they need; see
``benchmark.stats.ks_gram_count``) over the call's time, by CUDA events
around many warm calls. Any later implementation of the call is read
against the same count."""

import torch

from benchmark import stats

CALLS = 50


def read(t):
    call, count = t.ctx.get("gram_call"), t.ctx.get("gram_count")
    if call is None or count is None:
        return None
    for _ in range(3):
        call()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CALLS):
        call()
    b.record()
    b.synchronize()
    seconds = a.elapsed_time(b) / 1e3 / CALLS
    bound, _what = stats.roofline_s(*count)
    return 100.0 * bound / seconds
