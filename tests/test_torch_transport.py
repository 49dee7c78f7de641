"""pdx_torch.pipelines.transport against pdx.pipelines.transport, float64,
at pdx's own test size (8 frames of tests/test_real_pipelines.py's
220 x 220 stack, 4x downsampled, 2 pyramid levels).

Tolerances, and why: the pair flows run in float64 in both packages
(measured 1e-12 px apart): flows within 1e-9 px. The library is stencils
and products in pdx's order: 1e-12 of each field's largest value. The
Lasso sweep is FISTA on the Gram in both; coefficients within 1e-9 of
max|coef| and R2 within 1e-10 (measured ~1e-14). pdx's default alphas
zero every coefficient at this size, so the sweep is also checked at
alphas (1e-6, 1e-5, 1e-4), where 4-5 terms stay active.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.pipelines import transport as jt
from pdx_torch import __main__ as tmain
from pdx_torch.pipelines import transport as tt
from test_torch_patch_discovery import make_synthetic_stack
from torch_card import assert_flow_kernels, assert_no_gram_kernel, card, full_stack, launches

SMALL = dict(max_images=8, downsample=4, flow_levels=2)
ACTIVE_ALPHAS = (1e-6, 1e-5, 1e-4)


@pytest.fixture(autouse=True)
def _stack_caches_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("PDX_STACK_CACHE_DIR", str(tmp_path / "pdx_stacks"))


@pytest.fixture(scope="module")
def stack():
    return make_synthetic_stack(T=8, N=220)


@pytest.fixture(scope="module")
def tiff_dir(tmp_path_factory, stack):
    PIL = pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("synth_tiffs")
    for i, frame in enumerate(stack):
        PIL.fromarray(frame).save(d / f"frame_{i:03d}.tif")
    return d


def _compare(got, want):
    assert set(got) == set(want)
    assert {**got["config"], "output_dir": ""} == {**want["config"], "output_dir": ""}
    assert got["term_names"] == want["term_names"] and got["n_samples"] == want["n_samples"]
    np.testing.assert_allclose(got["mean_flow_speed"], want["mean_flow_speed"], rtol=1e-10)
    assert list(got["results"]) == list(want["results"])
    for a, w in want["results"].items():
        g = got["results"][a]
        assert set(g) == set(w)
        cw = np.asarray(w["coefficients"])
        np.testing.assert_allclose(g["coefficients"], cw, rtol=0, atol=1e-9 * max(np.abs(cw).max(), 1e-300))
        assert [n for n, _ in g["active_terms"]] == [n for n, _ in w["active_terms"]]
        for k in ("intercept", "r2", "mse", "mae"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-10, atol=1e-15, err_msg=f"{a} {k}")


def test_run_matches_pdx(tiff_dir, tmp_path):
    """Both packages read the TIFFs; pdx's default alphas; the artifact."""
    dirs = tmp_path / "pdx", tmp_path / "port"
    want = jt.run(jt.TransportConfig(data_dir=str(tiff_dir), output_dir=str(dirs[0]), **SMALL))
    got = tt.run(tt.TransportConfig(data_dir=str(tiff_dir), output_dir=str(dirs[1]), **SMALL), device="cpu")
    _compare(got, want)
    assert set(got["results"]) == {0.001, 0.01, 0.1}
    jj, tj = (json.loads((d / "transport_results.json").read_text()) for d in dirs)
    assert set(tj) == set(jj) and tj["term_names"] == jj["term_names"] and list(tj["results"]) == list(jj["results"])
    for a in jj["results"]:
        assert set(tj["results"][a]) == set(jj["results"][a])
        np.testing.assert_allclose(tj["results"][a]["coefficients"], jj["results"][a]["coefficients"], atol=1e-12)


def test_run_active_terms_and_timer(stack):
    """Alphas at which terms stay active, each stopping at its own FISTA
    iteration; the stage timer's stages."""
    from pdx_torch.utils.profiling import StageTimer

    kw = dict(data_dir="unused", write_artifacts=False, alphas=ACTIVE_ALPHAS, **SMALL)
    want = jt.run(jt.TransportConfig(**kw), U_raw=stack)
    timer = StageTimer()
    got = tt.run(tt.TransportConfig(**kw), U_raw=stack, timer=timer, device="cpu")
    stages = got.pop("stage_seconds")
    assert list(stages) == ["load_images", "ship_normalize_resize", "pair_flows", "discover_lasso_sweep", "host_readback"]
    _compare(got, want)
    assert all(len(r["active_terms"]) >= 4 for r in got["results"].values())


def test_pair_flows_and_library_match_pdx(stack):
    """The float64 pair flows and the 13-term library on them."""
    from pdx.ops.interp import resize_bilinear as j_resize
    from pdx.register.farneback import farneback_flow_pairs as j_flows

    cfg = tt.TransportConfig(**SMALL)
    images = torch.from_numpy(stack.astype(np.float64))
    imgs_ds, imgs_n = tt._normalized_pairs_input(cfg, images / images.max())
    fu, fv = tt._pair_flows(cfg, imgs_n)
    j_ds = j_resize(jnp.asarray(stack.astype(np.float64) / stack.max()), 55, 55)
    np.testing.assert_allclose(imgs_ds.numpy(), np.asarray(j_ds), rtol=0, atol=1e-13)
    mn, mx = j_ds.min(axis=(1, 2), keepdims=True), j_ds.max(axis=(1, 2), keepdims=True)
    jr, jc = j_flows((j_ds - mn) / (mx - mn + 1e-12), pyr_scale=0.5, levels=2, winsize=15, iterations=3, poly_n=5,
                     poly_sigma=1.2, gaussian_win=False)
    np.testing.assert_allclose(fu.numpy(), np.asarray(jc), rtol=0, atol=1e-9)
    np.testing.assert_allclose(fv.numpy(), np.asarray(jr), rtol=0, atol=1e-9)

    got, got_t = tt.build_transport_library(imgs_ds, fu, fv, 1.0, 0.5, 2.0)
    want, want_t = jt.build_transport_library(jnp.asarray(imgs_ds.numpy()), jnp.asarray(fu.numpy()),
                                              jnp.asarray(fv.numpy()), 1.0, 0.5, 2.0)
    assert list(got) == list(want) == tt.TERM_NAMES == jt.TERM_NAMES
    for k in list(want) + ["target"]:
        g, w = (got_t, want_t) if k == "target" else (got[k], want[k])
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=k)


def test_quick_run_and_mass_drift(stack):
    """quick_run's plain least squares: the library holds transport =
    rho_div + advection exactly, so the normal equations are singular but
    for their 1e-12 ridge and amplify round-off; coefficients within 1e-6
    of max|coef| (measured 5e-8), R2 and the flow speed within rtol 1e-9."""
    cfg = tt.TransportConfig(data_dir="unused", max_images=8, downsample=8, flow_levels=2)
    got = tt.quick_run(cfg, U_raw=stack, device="cpu")
    want = jt.quick_run(jt.TransportConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), U_raw=stack)
    assert set(got) == set(want)
    cw = np.asarray(want["coefficients"])
    np.testing.assert_allclose(got["coefficients"], cw, rtol=0, atol=1e-6 * np.abs(cw).max())
    assert got["physics_check"][:-7] == want["physics_check"][:-7]  # the coefficient's last printed digits aside
    np.testing.assert_allclose([got["r2"], got["mean_flow_speed"]], [want["r2"], want["mean_flow_speed"]], rtol=1e-9)
    U = stack.astype(np.float64)
    assert tt.mass_conservation_drift(U) == pytest.approx(jt.mass_conservation_drift(U), rel=1e-12)
    assert tt.mass_conservation_drift(torch.from_numpy(U)) == pytest.approx(jt.mass_conservation_drift(U), rel=1e-12)
    assert tt.mass_conservation_drift(np.ones((5, 4, 4))) < 1e-9


def test_cli_device_cpu(tiff_dir, tmp_path, capsys):
    base = ["transport", "--data-dir", str(tiff_dir), "--output-dir", str(tmp_path), "--max-images", "8",
            "--device", "cpu"]
    assert tmain.main(base) == 0
    out = capsys.readouterr().out
    assert "Mean optical-flow speed:" in out and "alpha=0.001: R2=" in out
    assert (tmp_path / "transport_results.json").exists()
    assert tmain.main(base + ["--quick"]) == 0
    assert "continuity form predicts transport coefficient" in capsys.readouterr().out


def test_run_needs_a_card_unless_cpu(stack):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tt.run(tt.TransportConfig(**SMALL), U_raw=stack)


# --- the card: transport at the real dataset's shape, and against the CPU -------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("alphas", [None, ACTIVE_ALPHAS], ids=["pdx_alphas", "active_alphas"])
def test_full_size_on_the_card(alphas):
    """The default configuration (4x downsample, 50 pair flows as one
    float64 batch, a 13-term library of 50 x 256 x 320 rows) on the real
    dataset's shape, at pdx's alphas and at alphas that keep terms active
    (there FISTA iterates): finite coefficients and R2 for every alpha,
    none of K1-K4 launched, the flow's expansions and update launched."""
    cfg = tt.TransportConfig(data_dir="unused", write_artifacts=False)
    if alphas is not None:
        cfg = dataclasses.replace(cfg, alphas=alphas)
    U = full_stack()  # skips without a card
    with launches() as moved:
        out = tt.run(cfg, U_raw=U, device=card())
    assert_no_gram_kernel(moved)
    assert_flow_kernels(moved, ("poly_expansion", "warped_poly_expansion", "flow_update"))
    assert len(out["results"]) == len(cfg.alphas)
    for a, r in out["results"].items():
        assert np.isfinite(r["coefficients"]).all() and np.isfinite(r["r2"]), a


@pytest.mark.gpu
def test_card_matches_cpu():
    """8 frames of 220 x 220 (4x downsampled, 2 pyramid levels, as pdx's own
    test): float64 flows within 1e-9 px; coefficients within 1e-6 of
    max|coef| and R2 within 1e-9, at pdx's alphas and at alphas that keep
    terms active (FISTA stops where a step falls under 1e-8, so card and
    CPU may stop an iteration apart)."""
    from tools.make_synth_stack import make_stack

    U = make_stack(T=8, H=220, W=220, seed=3)
    cfg = tt.TransportConfig(data_dir="unused", write_artifacts=False, **SMALL)
    flows = []
    for d in (card(), "cpu"):
        images = torch.as_tensor(U, device=d).to(torch.float64)
        flows.append([f.cpu() for f in tt._pair_flows(cfg, tt._normalized_pairs_input(cfg, images / images.max())[1])])
    assert max(float((a - b).abs().max()) for a, b in zip(*flows)) < 1e-9
    for alphas in (cfg.alphas, ACTIVE_ALPHAS):
        one = dataclasses.replace(cfg, alphas=alphas)
        on_card, on_cpu = (tt.run(one, U_raw=U, device=d)["results"] for d in (card(), "cpu"))
        scale = max(max(np.abs(r["coefficients"]).max() for r in on_cpu.values()), 1e-300)
        assert max(np.abs(on_card[a]["coefficients"] - on_cpu[a]["coefficients"]).max() for a in on_cpu) / scale < 1e-6
        assert max(abs(on_card[a]["r2"] - on_cpu[a]["r2"]) for a in on_cpu) < 1e-9
