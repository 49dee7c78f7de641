"""pdx_torch.pipelines.run_all against pdx.pipelines.run_all.

* Stage order and configurations: every stage function that either
  ``run`` calls is replaced by a recorder; with ``skip_heavy=False`` both
  make the same calls in the same order, with field-for-field equal
  configurations and equal figure arguments, and the port hands every stage
  the resolved device. No computation.
* End to end on pdx's own run_all stack (16 TIFFs of 220 x 220 uint16,
  skip 10, subsample 6, ``skip_heavy=True``), the port on the CPU: equal
  status dicts, the same artifact names, the same selected model, and
  best-model coefficients within 1e-5 of max|coef| (the registration-on
  limit of tests/test_torch_analyze.py: the chain's flows are float32 in
  both packages; measured ~3e-8).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pdx.pipelines import run_all as jra
from pdx_torch.io_host.images import write_tiff_stack
from pdx_torch.pipelines import run_all as tra
from test_real_pipelines import make_synthetic_stack
from torch_card import GRAM_KERNELS, card, full_stack, launches

PIPELINES = ("analyze", "improved_registration", "patch_sindy", "patch_discovery", "transport")
FIGURES = {
    "report.figures": ("generate_presentation_figures_minimal", "create_simple_slide3", "create_method_slide"),
    "report.comparative": ("create_comparative_final_figures", "create_finalclass_figures",
                           "generate_presentation_figures"),
}


def _plain(v):
    return str(v) if isinstance(v, Path) else v


def _record_stages(monkeypatch, pkg: str) -> list:
    """Replace every stage function of ``pkg`` that run_all calls by a
    recorder; returns the list the calls are appended to."""
    import importlib

    calls = []
    for name in PIPELINES:
        mod = importlib.import_module(f"{pkg}.pipelines.{name}")

        def rec(cfg, *args, _name=name, **kwargs):
            calls.append((_name, type(cfg).__name__, dataclasses.asdict(cfg), args, kwargs))
            return {}

        monkeypatch.setattr(mod, "run", rec)
    for modname, fns in FIGURES.items():
        mod = importlib.import_module(f"{pkg}.{modname}")
        for fn in fns:
            def rec(*args, _name=fn, **kwargs):
                calls.append((_name, [_plain(a) for a in args], {k: _plain(v) for k, v in kwargs.items()}))
                return []

            monkeypatch.setattr(mod, fn, rec)
    return calls


def test_stage_order_and_configs_match_pdx(monkeypatch, tmp_path):
    kw = dict(data_dir=str(tmp_path / "data"), output_root=str(tmp_path / "out"), max_images=40, skip=7,
              subsample=5, patch_size=64, patch_overlap=16, min_patches=3, grid_patch=13, grid_overlap=4)
    want_calls = _record_stages(monkeypatch, "pdx")
    want = jra.run(jra.RunAllConfig(**kw))
    got_calls = _record_stages(monkeypatch, "pdx_torch")
    got = tra.run(tra.RunAllConfig(**kw), device="cpu")
    assert got == want and list(got) == list(want)
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls]
    for g, w in zip(got_calls, want_calls):
        if g[0] in PIPELINES:
            name, cls, cfg, args, kwargs = g
            assert (name, cls, cfg, args) == w[:4]
            assert kwargs == {"device": torch.device("cpu")} and w[4] == {}
        else:
            name, args, kwargs = g
            assert args == w[1], name
            device = kwargs.pop("device", None)
            assert kwargs == w[2], name
            assert (device == torch.device("cpu")) == (name == "generate_presentation_figures"), name
    assert [c[0] for c in got_calls].count("generate_presentation_figures") == 2  # the refresh after the heavy steps


def test_config_defaults_match_pdx():
    assert dataclasses.asdict(tra.RunAllConfig()) == dataclasses.asdict(jra.RunAllConfig())
    names = [[f.name for f in dataclasses.fields(c)] for c in (tra.RunAllConfig, jra.RunAllConfig)]
    assert names[0] == names[1]


def test_run_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tra.run(tra.RunAllConfig(data_dir=str(tmp_path), output_root=str(tmp_path / "out")))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """pdx's and the port's run_all(skip_heavy=True) on one TIFF stack,
    each with its decoded-stack disk cache in a directory of its own."""
    PIL = pytest.importorskip("PIL.Image")
    base = tmp_path_factory.mktemp("run_all")
    data = base / "tiffs"
    data.mkdir()
    for i, frame in enumerate(make_synthetic_stack(T=16)):
        PIL.fromarray(frame).save(data / f"frame_{i:03d}.tif")
    kw = dict(data_dir=str(data), max_images=16, skip_heavy=True, skip=10, subsample=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CACHE_HOME", str(base / "xdg"))
        mp.setenv("PDX_STACK_CACHE_DIR", str(base / "pdx_stacks"))
        want = jra.run(jra.RunAllConfig(output_root=str(base / "pdx"), **kw))
        got = tra.run(tra.RunAllConfig(output_root=str(base / "port"), **kw), device="cpu")
    return want, got, base / "pdx", base / "port"


def test_end_to_end_statuses_and_artifacts_match_pdx(both):
    want, got, pdx_root, port_root = both
    assert got == want and set(got.values()) == {"ok"}
    assert tra.list_artifacts(port_root) == jra.list_artifacts(pdx_root)
    for a in tra.list_artifacts(port_root):
        if a.endswith(".png"):
            assert (port_root / a).stat().st_size > 1000, a


def test_end_to_end_selected_model_matches_pdx(both):
    _, _, pdx_root, port_root = both
    b_want, b_got = (json.loads((r / "slides" / "best_model.json").read_text()) for r in (pdx_root, port_root))
    assert b_got["name"] == b_want["name"] and b_got["terms"] == b_want["terms"]
    cj = np.asarray(b_want["coeffs"])
    np.testing.assert_allclose(b_got["coeffs"], cj, rtol=0, atol=1e-5 * np.abs(cj).max())
    m_want, m_got = (json.loads((r / "slides" / "models_comparison.json").read_text()) for r in (pdx_root, port_root))
    assert [m["name"] for m in m_got["models"]] == [m["name"] for m in m_want["models"]]


def test_cli_run_all_parses_pdx_flags_and_device():
    cfg, device = tra.parse_args(["--data-dir", "D", "--output-root", "O", "--max-images", "9", "--skip-heavy",
                                  "--skip", "3", "--subsample", "2", "--patch-size", "32", "--patch-overlap", "8",
                                  "--min-patches", "2", "--grid-patch", "11", "--grid-overlap", "5",
                                  "--device", "cpu"])
    assert cfg == tra.RunAllConfig("D", "O", 9, True, 3, 2, 32, 8, 2, 11, 5) and device == "cpu"
    assert tra.parse_args([]) == (tra.RunAllConfig(), "cuda")


# --- the card: run_all from TIFFs of the real dataset's shape, and against the CPU ---------------------------------

FIGURE_STAGES = ("figures_minimal", "slide3", "method_slide", "comparative_figures", "finalclass_figures",
                 "presentation_figures", "figures_refresh")
# what run_all must leave in its output root: the analyze contract, and after the heavy steps the patch
# ensemble's CSV and report and the registration, patch_sindy and transport outputs
FAST_ARTIFACTS = ("slides/best_model.json", "slides/models_comparison.json", "slides/best_model_baseline.json")
HEAVY_ARTIFACTS = ("patch_pde/PATCH_PDE_COEFFS.csv", "patch_pde/PATCH_PDE_REPORT.txt",
                   "patch_pde/patch_pde_summary.json", "registration/registration_study.json",
                   "patch_sindy/patch_sindy_results.json", "transport/transport_results.json")
COEFF_KEYS = ("coeffs", "coefficients", "agg_coeffs")


def _coefficients(node) -> list[float]:
    """Every number held under a coefficient key anywhere in a JSON payload."""
    if isinstance(node, dict):
        out = []
        for k, v in node.items():
            out += [float(c) for c in np.ravel(v)] if k in COEFF_KEYS else _coefficients(v)
        return out
    if isinstance(node, list):
        return [c for v in node for c in _coefficients(v)]
    return []


def _gates(status: dict, root: Path, skip_heavy: bool = False) -> None:
    """Every stage "ok" (a figure stage skipped without matplotlib), the
    artifact contract, and every coefficient in it finite."""
    import csv
    import importlib.util

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    for stage, st in status.items():
        assert st == ("ok" if has_mpl or stage not in FIGURE_STAGES else tra.SKIPPED), (stage, st)
    contract = FAST_ARTIFACTS + (() if skip_heavy else HEAVY_ARTIFACTS)
    arts = set(tra.list_artifacts(root))
    assert all(a in arts for a in contract), sorted(arts)
    coeffs = []
    for a in contract:
        if a.endswith(".json"):
            coeffs += _coefficients(json.loads((root / a).read_text()))
        elif a.endswith(".csv"):
            with (root / a).open() as f:
                coeffs += [float(v) for row in csv.DictReader(f) for k, v in row.items() if k != "term"]
    assert coeffs and np.isfinite(coeffs).all()


@pytest.fixture(scope="module")
def full_tiffs(tmp_path_factory):
    """The real dataset's shape written as 51 uncompressed uint16 TIFFs."""
    U = full_stack()  # skips without a card
    d = tmp_path_factory.mktemp("full_tiffs")
    write_tiff_stack(d, U)
    return d


@pytest.mark.gpu
def test_full_size_on_the_card(full_tiffs, tmp_path, monkeypatch):
    """The default configuration from the TIFFs, cold (no stack in the
    process, an empty disk cache) and warm: every stage, the artifact
    contract, finite coefficients, none of K1-K4 launched."""
    from pdx_torch.io_host import images

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    images.clear_stack_memcache()
    cfg = tra.RunAllConfig(data_dir=str(full_tiffs), output_root=str(tmp_path / "outputs"))
    for _ in ("cold", "warm"):
        with launches(GRAM_KERNELS) as moved:
            status = tra.run(cfg, card())
        images.flush_stack_cache_writes()
        assert not any(moved.values()), moved
        _gates(status, tmp_path / "outputs")


@pytest.mark.gpu
def test_disk_cache_returns_the_decoded_stack(full_tiffs, tmp_path):
    """A hit of the decoded-stack disk cache, read in full, is the stack
    the TIFFs decode to."""
    from pdx_torch.io_host import images

    card()
    U = images.load_images(full_tiffs, cache=False)
    images.load_images(full_tiffs, cache_dir=tmp_path)
    images.flush_stack_cache_writes()
    images.clear_stack_memcache()
    assert np.array_equal(np.asarray(images.load_images(full_tiffs, cache_dir=tmp_path)), U)


@pytest.mark.gpu
def test_presentation_flow_data_at_full_size_on_the_card(full_tiffs):
    """The presentation's flow figure data from 5 frames of the real shape
    (3 frames at 512 x 640): finite, and registration lowers the mean
    absolute frame difference."""
    from pdx_torch.io_host.images import load_images
    from pdx_torch.report.comparative import presentation_flow_data

    U5 = load_images(full_tiffs, max_images=5)
    flow = presentation_flow_data(U5 / (U5.max() + 1e-12), card())
    assert all(np.isfinite(v).all() for v in flow.values()) and flow["fx"].shape == (512, 640)
    assert float(flow["after"].mean()) < float(flow["before"].mean())


@pytest.mark.gpu
def test_skip_heavy_card_matches_cpu(tmp_path):
    """run_all(skip_heavy=True) on the card and on the CPU on 16 TIFFs of
    220 x 220 (the size of pdx's own run_all test, skip 10, subsample 6):
    each passes the gates, the same statuses and selected model, best-model
    coefficients within 1e-5 of max|coef| (the registration-on limit:
    float32 Farnebäck flows)."""
    from tools.make_synth_stack import make_stack

    dev = card()
    write_tiff_stack(tmp_path / "tiffs", make_stack(T=16, H=220, W=220))
    status, best = {}, {}
    for d in (dev, "cpu"):
        root = tmp_path / str(d)
        status[d] = tra.run(tra.RunAllConfig(data_dir=str(tmp_path / "tiffs"), output_root=str(root), max_images=16,
                                             skip_heavy=True, skip=10, subsample=6), d)
        _gates(status[d], root, skip_heavy=True)
        best[d] = json.loads((root / "slides" / "best_model.json").read_text())
    a, b = best[dev], best["cpu"]
    assert status[dev] == status["cpu"] and a["name"] == b["name"]
    cb = np.asarray(b["coeffs"])
    np.testing.assert_allclose(a["coeffs"], cb, rtol=0, atol=1e-5 * np.abs(cb).max())
