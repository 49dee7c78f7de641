import subprocess
import sys

from benchmark import harness, manifest


def test_forbidden_names_compare_the_whole_top_level_name():
    mods = ["pdx_torch", "pdx_torch.pipelines", "numpy", "jaxtyping", "pdxx"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["pdx", "pdx.ops", "jax", "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib.xla", "pdx", "pdx.ops"]


def test_the_reference_imports_nothing_of_the_program():
    assert harness.reference_imports_program() == []


def test_an_import_of_the_program_in_the_reference_is_found(tmp_path):
    (tmp_path / "a.py").write_text("import numpy\nfrom pdx_torch.ops import fd\n")
    (tmp_path / "b.py").write_text("import jax.numpy as jnp\nfrom . import a\n")
    assert harness.reference_imports_program(tmp_path) == ["a.py: pdx_torch.ops", "b.py: jax.numpy"]


def test_a_cell_loads_no_jax():
    """What a run imports on the CPU, with the port: no JAX, no pdx."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, calibrate\n"
            "from benchmark.entries import ks2d_bench, patch_discovery, transport\n"
            "import pdx_torch.pipelines.ks2d_bench, pdx_torch.pipelines.patch_discovery, "
            "pdx_torch.pipelines.transport\n"
            "print(harness.forbidden_modules())\n") % str(manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ks2d.gt_fullfield", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=manifest.ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
