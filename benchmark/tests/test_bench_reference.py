"""Each plain reference against the port's CPU path at a small size: the
port's readings lie under the cell's limits."""

import pytest

from benchmark import calibrate, manifest
from benchmark.tests.tiny import SMALL


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_port_on_the_cpu_agrees_with_the_reference(workload):
    limits = manifest.limits(manifest.cell(manifest.load(), workload))
    (row,) = calibrate.readings(workload, [3_000_000_019], 2, "program", device="cpu",
                                config_override=SMALL[workload])
    assert set(row["readings"]) == set(limits)
    for k, v in row["readings"].items():
        assert v <= limits[k], (k, v, limits[k])
