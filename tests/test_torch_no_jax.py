"""pdx_torch and chip_smoke.py must never import jax (nor pdx, whose
__init__ imports jax): neither on import nor while a run is under way (the
KS-2D dataset / regression branch, the patch ensemble and analyze with
registration on, transport; in a second process, patch_sindy with ECC and
with optical flow, improved_registration, the comprehensive method matrix,
sindy1d and the multi-device dry run over a mesh of virtual shards). In a
third, with matplotlib made unimportable, the report
modules and run_all import, and run_all(skip_heavy=True) marks every figure
stage skipped and runs the rest. On the card (``gpu``), a fourth runs the
paths that only CUDA tensors take: kernels K1-K4, the Farnebäck flow
kernels, the chain's CUDA graphs and the DIS flow's kernels, each of which
must launch."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_card import DIS_KERNELS, FLOW_KERNELS, GRAM_KERNELS, card

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import sys
import pdx_torch, pdx_torch.__main__, pdx_torch.interop, pdx_torch.pipelines.ks2d_bench
import pdx_torch.ops.kernels._build, pdx_torch.ops.kernels.fused_gram, pdx_torch.ops.kernels.fused_blockwise
import pdx_torch.ops.spectral, pdx_torch.ops.interp, pdx_torch.ops.filters
import pdx_torch.sim.perturb, pdx_torch.sim.ks2d, pdx_torch.register.phasecorr
import pdx_torch.ops.linalg, pdx_torch.solve.stridge, pdx_torch.solve.robust, pdx_torch.library.weakform
import pdx_torch.preprocess, pdx_torch.interop, pdx_torch.library.localpoly, pdx_torch.ops.metrics
import pdx_torch.utils.hostmem, pdx_torch.io_host.images, pdx_torch.io_host.artifacts
import pdx_torch.register.farneback, pdx_torch.pipelines.patch_discovery, pdx_torch.report.pipeline_figures
import pdx_torch.pipelines.run_all, pdx_torch.report.comparative
import chip_smoke
from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig, run
small = dict(Nx=16, Ny=16, n_seconds=0.05, n_sample=1500)
for kw in (dict(), dict(method="weakform", robust=True, n_bootstrap=4), dict(solver="qr", correct_shift_ut=True, grid_search=True)):
    res = run(Ks2dBenchConfig(**small, **kw), "cpu")  # the dataset / regression branch
    assert len(res["coeffs"]) == 3 and "train_r2" in res["fit"], res
import numpy as np
from tools.make_synth_stack import make_stack
from pdx_torch.pipelines.patch_discovery import PatchDiscoveryConfig, run as patch_run
out = patch_run(PatchDiscoveryConfig(data_dir="unused", max_images=12, skip=4, subsample=2, patch=11, overlap=5,
                                     samples_per_patch=40, rt=1, rs=2, deg=2, write_artifacts=False),
                U_raw=make_stack(T=12, H=96, W=96), device="cpu")  # registration on: the Farneback chain
assert out["n_patches"] > 0 and np.isfinite(out["patch_coeffs"]).all(), out
import pdx_torch.pipelines.analyze, pdx_torch.pipelines.transport, pdx_torch.solve.lasso, pdx_torch.validate.holdout
import pdx_torch.validate.selection, pdx_torch.validate.rollout, pdx_torch.report.figures, pdx_torch.report.render_cache
import pdx_torch.utils.profiling, pdx_torch.library.dictionaries, pdx_torch.library.pointwise, pdx_torch.ops.fd
from pdx_torch.pipelines.analyze import AnalyzeConfig, run as analyze_run
stack = make_stack(T=8, H=96, W=96)
out = analyze_run(AnalyzeConfig(data_dir="unused", max_images=8, skip=4, subsample=4, rollout_steps=(1, 2),
                                include_fourth_order=True, write_artifacts=False), U_raw=(stack >> 8).astype(np.uint8),
                  device="cpu")  # registration on: the chain
assert len(out["results"]) == 7 and np.isfinite(out["best_overall"]["r2"]), out
from pdx_torch.pipelines.transport import TransportConfig, run as transport_run
out = transport_run(TransportConfig(data_dir="unused", max_images=8, flow_levels=2, write_artifacts=False),
                    U_raw=stack, device="cpu")
assert all(np.isfinite(r["r2"]) for r in out["results"].values()), out
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "pdx.")) or m == "pdx")
assert not bad, bad
print("clean")
"""


PROBE_STUDIES = """
import sys
import numpy as np
import pdx_torch.register, pdx_torch.register.ecc, pdx_torch.register.dis, pdx_torch.register.tvl1
import pdx_torch.register.quality, pdx_torch.pipelines.patch_sindy, pdx_torch.pipelines.improved_registration
from tools.make_synth_stack import make_stack
from pdx_torch.pipelines.patch_sindy import PatchSindyConfig, run as sindy_run
from pdx_torch.pipelines.improved_registration import ImprovedRegistrationConfig, run as ir_run
stack = make_stack(T=4, H=96, W=96)
for method in ("ecc", "optical_flow"):
    out = sindy_run(PatchSindyConfig(data_dir="unused", patch_size=48, overlap=16, skip_boundary=3, subsample=2,
                                     min_patches=2, registration_method=method, write_artifacts=False),
                    U_raw=stack[:3] / 65535.0, device="cpu")
    assert out["n_patches"] == 4 and np.isfinite(out["coeffs"]).all(), out
out = ir_run(ImprovedRegistrationConfig(data_dir="unused", skip=10, subsample=6, savgol_window=3, savgol_poly=2,
                                        write_artifacts=False), U_raw=stack[:, :64, :64], device="cpu")
assert out["selected_method"] in ("DIS", "Farneback") and np.isfinite(out["coeffs"]).all(), out
import pdx_torch.preprocess, pdx_torch.solve.dmd, pdx_torch.sim.ks1d, pdx_torch.pipelines.comprehensive
import pdx_torch.pipelines.sindy1d
from pdx_torch.pipelines import comprehensive, sindy1d
out = comprehensive.run(comprehensive.ComprehensiveConfig(n_seconds=0.05, Nx=24, Ny=24, noises=("N7_all",),
                                                          n_subsample=500, write_artifacts=False), "cpu")
assert len(out["results"]["N7_all"]) == 21, out
out = sindy1d.run(sindy1d.Sindy1dConfig(n_steps=40, scenario="shifted", register=True, regressor="stridge"), "cpu")
assert np.isfinite(out["coeffs"]).all(), out
import contextlib, io
import pdx_torch.shard, pdx_torch.shard.mesh, pdx_torch.shard.dryrun
with contextlib.redirect_stdout(io.StringIO()):  # its "ok" line
    out = pdx_torch.shard.dryrun.dryrun_multichip(3, "cpu")  # every sharded axis over 3 virtual shards
assert out["patch_shards"] == 3 and len(set(out["placement"].values())) == 3, out
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "pdx.")) or m == "pdx")
assert not bad, bad
print("clean")
"""


PROBE_NO_MATPLOTLIB = """
import contextlib, io, os, sys, tempfile
from pathlib import Path
sys.modules["matplotlib"] = None  # every import of matplotlib now raises ImportError
import pdx_torch.report.figures, pdx_torch.report.comparative, pdx_torch.report.pipeline_figures
from pdx_torch.pipelines.run_all import SKIPPED, RunAllConfig, run
from pdx_torch.io_host.images import write_tiff_stack
from tools.make_synth_stack import make_stack
with tempfile.TemporaryDirectory() as tmp:
    os.environ["XDG_CACHE_HOME"] = tmp + "/xdg"
    write_tiff_stack(tmp + "/tiffs", make_stack(T=16, H=96, W=96))
    with contextlib.redirect_stdout(io.StringIO()) as said:  # analyze says which of its figures it skipped
        status = run(RunAllConfig(data_dir=tmp + "/tiffs", output_root=tmp + "/out", max_images=16,
                                  skip_heavy=True, skip=4, subsample=4), device="cpu")
    assert "(skipped model comparison figure" in said.getvalue(), said.getvalue()
    figures = [s for s in status if s in ("figures_minimal", "slide3", "method_slide", "comparative_figures",
                                          "finalclass_figures", "presentation_figures", "figures_refresh")]
    assert list(status) == ["analyze"] + figures and len(figures) == 6, status
    assert status["analyze"] == "ok" and all(status[s] == SKIPPED for s in figures), status
    assert (Path(tmp) / "out" / "slides" / "best_model.json").exists()
bad = sorted(m for m in sys.modules if m in ("jax", "pdx") or m.startswith(("jax.", "jaxlib", "pdx.", "matplotlib."))
             or (m == "matplotlib" and sys.modules[m] is not None))
assert not bad, bad
print("clean")
"""


PROBE_CARD = f"""
import sys
import numpy as np
from tools.make_synth_stack import make_stack
from pdx_torch.pipelines import improved_registration as tir, ks2d_bench as tb, patch_discovery as tpd
from pdx_torch.pipelines import patch_sindy as tps, transport as tt
from pdx_torch.utils.profiling import total
names = {GRAM_KERNELS + FLOW_KERNELS + DIS_KERNELS!r}
base = {{n: total(n + ".launches") for n in names}}
small = dict(grid_search=True, Nx=32, Ny=32, n_seconds=0.2, solver="pallas", dtype="float32")
for kw in (dict(), dict(method="blockwise"), dict(dictionary="rich"), dict(method="blockwise", dictionary="rich")):
    out = tb.run(tb.Ks2dBenchConfig(**small, **kw), "cuda")  # K1, K3, K2, K4
    assert np.isfinite(out["coeffs"]).all(), out
out = tpd.run(tpd.PatchDiscoveryConfig(data_dir="unused", max_images=12, skip=4, subsample=2, patch=11, overlap=5,
                                       samples_per_patch=60, rt=1, rs=2, deg=2, write_artifacts=False),
              U_raw=make_stack(T=12, H=128, W=128), device="cuda")  # registration on: the chain's step graphs
assert out["n_patches"] > 0 and np.isfinite(out["patch_coeffs"]).all(), out
out = tt.run(tt.TransportConfig(data_dir="unused", max_images=8, downsample=4, flow_levels=2, write_artifacts=False),
             U_raw=make_stack(T=8, H=220, W=220), device="cuda")
assert all(np.isfinite(r["r2"]) for r in out["results"].values()), out
stack = make_stack(T=6, H=96, W=96, seed=1)
out = tps.run(tps.PatchSindyConfig(data_dir="unused", patch_size=48, overlap=16, skip_boundary=3, subsample=2,
                                   min_patches=2, registration_method="optical_flow", write_artifacts=False),
              U_raw=stack / 65535.0, device="cuda")
assert np.isfinite(out["coeffs"]).all(), out
out = tir.run(tir.ImprovedRegistrationConfig(data_dir="unused", skip=10, subsample=6, savgol_window=5,
                                             savgol_poly=2, write_artifacts=False), U_raw=stack, device="cuda")
assert np.isfinite(out["coeffs"]).all(), out
idle = sorted(n for n in names if total(n + ".launches") == base[n])
assert not idle, idle  # every kernel's branch was entered
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "pdx.")) or m == "pdx")
assert not bad, bad
print("clean")
"""


def _probe_is_clean(probe: str, timeout: float = 120) -> None:
    # one intra-op thread: the probe checks imports, and beside the other test
    # workers a many-threaded run of small ops spends its time waiting
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_port_imports_no_jax():
    _probe_is_clean(PROBE)


def test_registration_studies_import_no_jax():
    _probe_is_clean(PROBE_STUDIES)


def test_run_all_without_matplotlib_skips_only_the_figures():
    _probe_is_clean(PROBE_NO_MATPLOTLIB)


@pytest.mark.gpu
def test_card_paths_import_no_jax():
    card()
    _probe_is_clean(PROBE_CARD, timeout=900)  # may build the kernels first
