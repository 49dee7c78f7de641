"""A short run of every cell through the one command, on the card
(``python -m pytest -q -m gpu benchmark/tests`` there); skipped without one."""

import json
import subprocess
import sys

import pytest

from benchmark import manifest


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "4294967311",
                          "--seconds", "3", "--trace", str(trace)], capture_output=True, text=True, cwd=manifest.ROOT,
                         timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    cell = manifest.cell(manifest.load(), workload)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if not trace:
        want -= {"run_p95_s"}  # a 3 s window may hold fewer runs than a 30 s one; it is still reported
    assert want <= set(res["metrics"])
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
