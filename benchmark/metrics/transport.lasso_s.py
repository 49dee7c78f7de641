"""Seconds a run in the transport library and the FISTA sweep: the port's
own stage timer's ``discover_lasso_sweep`` stage, ended by a synchronize."""


def read(t):
    return t.spans.mean("discover_lasso_sweep")
