"""pdx_torch.report.comparative and the rest of pdx_torch.report.figures
against pdx's, on one artifact contract that the port's ``analyze`` and
patch ensemble write on the CPU (registration off; 12 TIFFs of 128 x 128
uint16 made by tools/make_synth_stack.py).

* Every suite (comparative with and without the patch CSV, final-class,
  presentation, the minimal deck, the two slides, the final figures)
  writes the same set of file names as ``pdx``'s from the same inputs, each
  PNG over 1000 bytes.
* The numpy and json helpers return exactly ``pdx``'s values.
* ``presentation_flow_data`` against ``pdx``'s inline computation
  (pdx/report/comparative.py:657-693) on the same frames: the half-size
  frames within 1e-6 (a float32 block mean summed in another order), the
  flows within 5e-5 of max|flow| (float32 Farnebäck in both packages,
  summed in another order through 5 levels and 2 refine passes: measured
  1.0e-5 at 128 x 128 frames and up to 2.4e-5 of max|flow| at 220 x 220;
  the port's batched pairs equal its single pairs bit for bit), the
  residual images within 1e-5 absolute (frames in [0, 1]).
* A ``gpu`` case holds the card's ``presentation_flow_data`` to the CPU's
  at the same limits. ``pdx`` is imported only by the tests that use it, so
  that the ``gpu`` case runs on a machine without jax (``pytest
  --noconftest -m gpu``).
"""

import inspect
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pdx_torch.io_host.images import load_images, write_tiff_stack
from pdx_torch.report import comparative as tc
from pdx_torch.report import figures as tf
from tools.make_synth_stack import make_stack
from torch_card import cuda

SMALL_PATCH = dict(max_images=12, skip=4, subsample=2, patch=11, overlap=5, samples_per_patch=60, rt=1, rs=2, deg=2,
                   registration=False)


@pytest.fixture(scope="module")
def contract(tmp_path_factory):
    """(TIFF dir, slides dir, patch CSV, patch report) written by the port
    on the CPU, the decoded-stack caches in the module's directory."""
    from pdx_torch.pipelines.analyze import AnalyzeConfig, run as analyze
    from pdx_torch.pipelines.patch_discovery import PatchDiscoveryConfig, run as patches

    base = tmp_path_factory.mktemp("comparative")
    data = base / "tiffs"
    write_tiff_stack(data, make_stack(T=12, H=128, W=128, seed=3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CACHE_HOME", str(base / "xdg"))
        mp.setenv("PDX_STACK_CACHE_DIR", str(base / "pdx_stacks"))
        analyze(AnalyzeConfig(data_dir=str(data), output_dir=str(base / "slides"), max_images=12, skip=10,
                              subsample=4, rollout_steps=(1, 2, 3), registration=False), device="cpu")
        patches(PatchDiscoveryConfig(data_dir=str(data), output_dir=str(base / "patch_pde"), **SMALL_PATCH),
                device="cpu")
        patch = base / "patch_pde"
        yield data, base / "slides", patch / "PATCH_PDE_COEFFS.csv", patch / "PATCH_PDE_REPORT.txt"


def _suites(contract):
    data, _slides, csv, report = contract
    return {
        "comparative": lambda m, s: m.create_comparative_final_figures(s, csv),
        "comparative_no_csv": lambda m, s: m.create_comparative_final_figures(s, None),
        "finalclass": lambda m, s: m.create_finalclass_figures(s, csv),
        "presentation": lambda m, s: m.generate_presentation_figures(
            s, data, report, **({"device": "cpu"} if m is tc else {})),
        "minimal": lambda m, s: m.generate_presentation_figures_minimal(s, data_dir=data),
        "slide3": lambda m, s: m.create_simple_slide3(s),
        "method": lambda m, s: m.create_method_slide(s),
        "final": lambda m, s: m.create_final_figures(s),
    }


COMPARATIVE = {"comparative", "comparative_no_csv", "finalclass", "presentation"}
N_ASSETS = {"comparative": 25, "comparative_no_csv": 24, "finalclass": 8, "presentation": 6}


@pytest.mark.parametrize("suite", list(N_ASSETS) + ["minimal", "slide3", "method", "final"])
def test_suite_writes_pdx_file_names(contract, suite, tmp_path, monkeypatch):
    from pdx.report import comparative as jc
    from pdx.report import figures as jf

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("PDX_STACK_CACHE_DIR", str(tmp_path / "pdx_stacks"))
    fn = _suites(contract)[suite]
    names = {}
    for tag, mod in (("pdx", jc if suite in COMPARATIVE else jf), ("port", tc if suite in COMPARATIVE else tf)):
        slides = tmp_path / tag
        shutil.copytree(contract[1], slides)
        before = set(p.name for p in slides.iterdir())
        ret = fn(mod, slides)
        ret = [ret] if isinstance(ret, Path) else ret
        written = set(p.name for p in slides.iterdir()) - before
        names[tag] = ({Path(p).name for p in ret}, written)
        for p in written:
            assert (slides / p).stat().st_size > 1000, (tag, p)
    assert names["port"] == names["pdx"]
    if suite in N_ASSETS:
        assert len(names["port"][1]) == N_ASSETS[suite]


@pytest.mark.parametrize("fn", ["generate_presentation_figures_minimal", "create_simple_slide3", "create_method_slide",
                                "create_final_figures"])
def test_missing_contract_names_the_port(fn, tmp_path):
    with pytest.raises(FileNotFoundError, match="run `pdx_torch analyze` first"):
        getattr(tf, fn)(tmp_path)


def _same(a, b):
    """Exact equality of nested helper results (nan equal to nan)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b)
    else:
        assert type(a) is type(b) and a == b


VALUES = np.asarray([0.3, np.nan, -1.0, 2.5, 0.3, np.inf, 1e-9])


@pytest.mark.parametrize("helper", ["_read_json", "_model_id", "_table", "_curves", "_rank", "_norm01",
                                    "_approach_points", "_read_patch_csv", "_parse_patch_report", "_best_payloads"])
def test_helpers_equal_pdx(contract, helper):
    from pdx.report import comparative as jc

    _data, slides, csv, report = contract
    comp = jc._read_json(slides / "models_comparison.json")
    args = {
        "_read_json": [(slides / "models_comparison.json",), (slides / "best_model.json",)],
        "_model_id": [(m["name"],) for m in comp["models"]] + [("Model x: odd",), ("plain name",), ("  Model 12",)],
        "_table": [(comp,), ({},)],
        "_curves": [(comp,), ({"models": [{"name": "Model 3: a", "rollout_curve_test": {"steps": []}}]},)],
        "_rank": [(VALUES, True), (VALUES, False), (np.asarray([2.0, 1.0]), True)],
        "_norm01": [(VALUES, True), (VALUES, False), (np.asarray([np.nan, np.nan]), True)],
        "_approach_points": [(slides,), (csv.parent,)],
        "_read_patch_csv": [(csv,)],
        "_parse_patch_report": [(report,), (slides / "missing.txt",), (csv,)],
        "_best_payloads": [(slides,)],
    }[helper]
    for a in args:
        _same(getattr(tc, helper)(*a), getattr(jc, helper)(*a))


def test_qualitative_rollout_snapshots_is_the_composition(tmp_path):
    from pdx.report import figures as jf

    assert inspect.signature(tf.qualitative_rollout_snapshots).parameters.keys() == \
        inspect.signature(jf.qualitative_rollout_snapshots).parameters.keys()
    rng = np.random.default_rng(0)
    u = rng.normal(size=(14, 12, 12)) * 1e-3 + 0.5
    results = [{"name": "Model 3: x", "names": ["uxx", "uyy"], "coeffs": [0.1, 0.1]},
               {"name": "Model 4: y", "names": ["uxx", "uyy", "u"], "coeffs": [0.1, 0.1, -0.01]}]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = tf.qualitative_rollout_snapshots(tmp_path / "a", u, results, 9, 14, 1.0, 0.1, 0.1)
    data = tf.fig4_snapshot_data(torch.as_tensor(u), results, 9, 14, 1.0, 0.1, 0.1)
    want = tf.draw_fig4_snapshots(tmp_path / "b", data)
    assert [p.name for p in got] == [p.name for p in want]
    assert all(p.stat().st_size > 1000 for p in got)


def _frames(contract):
    U = load_images(contract[0], max_images=5)
    return U / (U.max() + 1e-12)


def _check_flow_data(got, want):
    np.testing.assert_allclose(got["small"], want["small"], rtol=0, atol=1e-6)
    scale = max(np.abs(want["fx"]).max(), np.abs(want["fy"]).max())
    for k in ("fx", "fy"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-5 * scale, err_msg=k)
    for k in ("before", "after"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_presentation_flow_data_matches_pdx(contract):
    import jax.numpy as jnp

    from pdx.ops.interp import resize_area, warp_flow
    from pdx.register.farneback import farneback_flow

    U = _frames(contract)
    got = tc.presentation_flow_data(U, "cpu")
    # pdx/report/comparative.py:662-685, as written there
    n = min(3, U.shape[0])
    small = np.asarray(resize_area(jnp.asarray(U[:n], jnp.float32), U.shape[1] // 2, U.shape[2] // 2))
    before, after = [], []
    for i in range(1, n):
        fx, fy = farneback_flow(jnp.asarray(small[i - 1]), jnp.asarray(small[i]))
        reg = np.asarray(warp_flow(jnp.asarray(small[i]), fx, fy, border="reflect"))
        before.append(np.abs(small[i] - small[i - 1]))
        after.append(np.abs(reg - small[i - 1]))
    fx, fy = farneback_flow(jnp.asarray(small[0]), jnp.asarray(small[1]))
    want = dict(small=small, before=np.stack(before), after=np.stack(after), fx=np.asarray(fx), fy=np.asarray(fy))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())
    _check_flow_data(got, want)
    assert got["after"].mean() < got["before"].mean()


def test_presentation_flow_data_needs_two_frames():
    with pytest.raises(ValueError, match="at least two frames"):
        tc.presentation_flow_data(np.zeros((1, 8, 8), np.float32), "cpu")


@pytest.mark.gpu
def test_presentation_flow_data_on_the_card(cuda):
    U = make_stack(T=5, H=256, W=320, seed=2).astype(np.float32)
    U = U / (U.max() + 1e-12)
    _check_flow_data(tc.presentation_flow_data(U, cuda), tc.presentation_flow_data(U, "cpu"))
