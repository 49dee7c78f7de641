"""``correct`` comes out false for the float32 control in the port's place
and for every planted fault, in a whole run of the harness on the CPU (the
look for a card skipped) at a small size; and true for the port itself."""

import pytest
import torch

from benchmark import faults
from benchmark.tests.tiny import SMALL, run_cell


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("trace", [0, 1])
def test_the_port_is_correct(workload, trace):
    res = run_cell(workload, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_float32_control_is_not_correct(workload, monkeypatch):
    import importlib

    from benchmark import manifest

    entry = importlib.import_module(f"benchmark.entries.{manifest.cell(manifest.load(), workload).traffic['entry']}")
    monkeypatch.setattr(entry, "request", lambda state, i: entry.reference(state, i, torch.float32))
    res = run_cell(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,fault,trace", [
    (w, f, t) for w in sorted(faults.FAULTS) for f in sorted(faults.FAULTS[w]) for t in (0, 1)
    if t == 1 or (w, f) not in faults.TRACED_ONLY])
def test_a_planted_fault_is_not_correct(workload, fault, trace):
    undo = faults.apply(workload, fault)
    try:
        res = run_cell(workload, trace=trace)
    finally:
        undo()
    assert not res["correct"], res["checks"]
