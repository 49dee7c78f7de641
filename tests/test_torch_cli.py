"""The port's CLI against pdx's: every command pdx registers, list-resolutions
with pdx's output and exit codes, doctor without a card, and run-all's flags."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pdx import __main__ as jmain
from pdx.pipelines import run_all as jra
from pdx_torch import __main__ as tmain
from pdx_torch.io_host.images import write_tiff, write_tiff_stack

ROOT = Path(__file__).resolve().parents[1]


def _commands(help_text: str) -> set[str]:
    line = next(ln for ln in help_text.splitlines() if ln.startswith("commands:"))
    return {c.strip() for c in line.removeprefix("commands:").split(",")}


def test_help_lists_every_pdx_command(capsys):
    assert jmain.main(["--help"]) == 0
    want = _commands(capsys.readouterr().out)
    proc = subprocess.run([sys.executable, "-m", "pdx_torch", "--help"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = _commands(proc.stdout)
    assert want <= got, want - got
    assert got == set(tmain.COMMANDS)


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """A folder of frames of two sizes (8- and 16-bit), and an empty one."""
    base = tmp_path_factory.mktemp("resolutions")
    rng = np.random.default_rng(0)
    write_tiff_stack(base / "mixed", rng.integers(0, 65535, size=(3, 20, 28), dtype=np.uint16))
    for i, frame in enumerate(rng.integers(0, 255, size=(2, 12, 9), dtype=np.uint8)):
        write_tiff(base / "mixed" / f"small_{i}.tif", frame)
    (base / "empty").mkdir()
    return base


@pytest.mark.parametrize("folder,pattern", [("mixed", "*.tif"), ("mixed", "small_*.tif"), ("empty", "*.tif"),
                                            ("missing", "*.tif")])
def test_list_resolutions_prints_what_pdx_prints(image_dirs, folder, pattern, capsys):
    argv = ["list-resolutions", "--data-dir", str(image_dirs / folder), "--pattern", pattern]
    want_rc = jmain.main(argv)
    want = capsys.readouterr().out
    got_rc = tmain.main(argv)
    got = capsys.readouterr().out
    assert (got_rc, got) == (want_rc, want)
    assert got_rc == (0 if folder == "mixed" else 1)
    if folder == "mixed" and pattern == "*.tif":
        assert got == "  12 x 9: 2 files\n  20 x 28: 3 files\n"


def test_doctor_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmain.main(["doctor"]) == 1
    out = capsys.readouterr().out
    assert out.startswith(f"torch {torch.__version__}")
    assert "no CUDA card visible" in out


def _flags(main, argv, capsys) -> set[str]:
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 0
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out)) - {"--help"}


def test_run_all_help_has_pdx_flags_and_device(capsys):
    want = _flags(jra.cmd_run_all, ["--help"], capsys)
    got = _flags(tmain.main, ["run-all", "--help"], capsys)
    assert got == want | {"--device"}


@pytest.fixture(scope="module")
def full_tiffs(tmp_path_factory):
    """The real dataset's shape written as 51 uncompressed uint16 TIFFs."""
    from torch_card import full_stack

    U = full_stack()  # skips without a card
    d = tmp_path_factory.mktemp("full_tiffs")
    write_tiff_stack(d, U)
    return d


@pytest.mark.gpu
def test_list_resolutions_of_the_full_stack_as_a_subprocess(full_tiffs):
    res = subprocess.run([sys.executable, "-m", "pdx_torch", "list-resolutions", "--data-dir", str(full_tiffs)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "1024 x 1280: 51 files", (res.stdout, res.stderr[-2000:])


@pytest.mark.gpu
def test_doctor_on_the_card_as_a_subprocess():
    """rc 0, the card named as nvidia-smi names it, every kernel of the
    build's registry loaded."""
    from pdx_torch.ops.kernels._build import KERNELS
    from torch_card import card

    card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    res = subprocess.run([sys.executable, "-m", "pdx_torch", "doctor"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, (res.stdout, res.stderr[-2000:])
    assert f"card 0: {smi}" in res.stdout
    line = next(s for s in res.stdout.splitlines() if s.startswith("kernels:"))
    assert line.startswith(f"kernels: {len(KERNELS)} of {len(KERNELS)} loaded")
    assert all(f"{label} {symbol}" in line for label, symbol in KERNELS.items()), line
