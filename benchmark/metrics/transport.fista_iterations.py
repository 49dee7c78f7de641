"""FISTA iterations a run, summed over the sweep's alphas: the program's
``fista.iterations`` count in its ``discover_lasso_sweep`` spans of the
profiled window, over those spans."""

from benchmark import program_spans


def read(t):
    spans = program_spans.recorded(t)
    sweeps = program_spans.named(spans, "discover_lasso_sweep") if spans else []
    if not any("fista.iterations" in s.counts for s in sweeps):
        return None
    return program_spans.count_under(spans, "discover_lasso_sweep", "fista.iterations") / len(sweeps)
