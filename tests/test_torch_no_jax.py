"""pdx_torch and chip_smoke.py must never import jax (nor pdx, whose
__init__ imports jax): neither on import nor while a run outside the
grid-search fast path is under way."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import sys
import pdx_torch, pdx_torch.__main__, pdx_torch.interop, pdx_torch.pipelines.ks2d_bench
import pdx_torch.ops.kernels._build, pdx_torch.ops.kernels.fused_gram, pdx_torch.ops.kernels.fused_blockwise
import pdx_torch.ops.spectral, pdx_torch.ops.interp, pdx_torch.ops.filters
import pdx_torch.sim.perturb, pdx_torch.sim.ks2d, pdx_torch.register.phasecorr
import pdx_torch.ops.linalg, pdx_torch.solve.stridge, pdx_torch.solve.robust, pdx_torch.library.weakform
import chip_smoke
from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig, run
small = dict(Nx=16, Ny=16, n_seconds=0.05, n_sample=1500)
for kw in (dict(), dict(method="weakform", robust=True, n_bootstrap=4), dict(solver="qr", correct_shift_ut=True, grid_search=True)):
    res = run(Ks2dBenchConfig(**small, **kw), "cpu")  # the dataset / regression branch
    assert len(res["coeffs"]) == 3 and "train_r2" in res["fit"], res
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "pdx.")) or m == "pdx")
assert not bad, bad
print("clean")
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
