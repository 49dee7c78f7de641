"""pdx_torch.pipelines.analyze against pdx.pipelines.analyze, float64, on
the synthetic stack of pdx's real-pipeline tests (diffusion and drift of a
smooth random field; 12 frames of 128 x 128 uint16, read as 8-bit
grayscale like the real TIFFs).

Tolerances, and why:

* registration off: the same rows, Gram statistics, STRidge solves and
  Euler rollouts in another summation order (measured <= 3.5e-11 of
  max|coef|, Model 7's 25 terms the worst). Coefficients within 1e-10 of
  max|coef|, n_active, equations and the selected models equal; metrics
  and rollout errors within rtol 1e-8 (an R2 near 1 - 1e-3 moves ~1e-10);
* registration on: the chain's flows are float32 in both packages, so the
  registered frames differ at float32 rounding (~3e-7) and the
  coefficients by ~3e-7 of max|coef| (measured). Coefficients within 1e-5
  of max|coef|, the same support and selected models; metrics and rollout
  errors within rtol 1e-4 plus atol 1e-5 (one-step errors of ~1e-3 move
  ~1e-7, R2 near 0 only in absolute terms);
* robust regression: 0.2% noise on the frames, because trimming clean rows
  is a round-off lottery (fault F6); then as registration off.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pdx.pipelines import analyze as ja
from pdx_torch import __main__ as tmain
from pdx_torch.pipelines import analyze as ta
from pdx_torch.preprocess import resize_denoise_normalize
from pdx_torch.register.farneback import register_sequence_dispatch
from pdx_torch.register.phasecorr import stabilize_translation_sequence
from test_torch_patch_discovery import make_synthetic_stack
from torch_card import all_finite, assert_no_gram_kernel, card, full_u8, launches

SMALL = dict(skip=10, subsample=4, rollout_steps=(1, 2, 3))
METRICS = ("r2", "rmse", "mae", "nrmse", "corr", "resid_med_abs", "one_step_rmse", "train_r2", "train_rmse",
           "train_nrmse", "train_corr", "train_one_step_rmse")


def as_grayscale_u8(U16):
    """The 8-bit frames load_images(mode="grayscale_u8") makes of 16-bit TIFFs."""
    return (U16 >> 8).astype(np.uint8)


@pytest.fixture(autouse=True)
def _stack_caches_in_tmp(tmp_path, monkeypatch):
    """Both packages' decoded-stack disk caches go to the test's directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("PDX_STACK_CACHE_DIR", str(tmp_path / "pdx_stacks"))


@pytest.fixture(scope="module")
def tiff_dir(tmp_path_factory):
    PIL = pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("synth_tiffs")
    for i, frame in enumerate(make_synthetic_stack()):
        PIL.fromarray(frame).save(d / f"frame_{i:03d}.tif")
    return d


@pytest.fixture(scope="module")
def off(tiff_dir, tmp_path_factory):
    """Registration off, Model 7 on, artifacts written: both packages read
    the TIFFs themselves. Returns (pdx's output, the port's, their dirs)."""
    dirs = tmp_path_factory.mktemp("pdx_out"), tmp_path_factory.mktemp("port_out")
    kw = dict(data_dir=str(tiff_dir), max_images=12, registration=False, include_fourth_order=True, **SMALL)
    want = ja.run(ja.AnalyzeConfig(output_dir=str(dirs[0]), **kw))
    got = ta.run(ta.AnalyzeConfig(output_dir=str(dirs[1]), **kw), device="cpu")
    return want, got, dirs


def _close(got, want, rtol, atol=0.0, what=""):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol, err_msg=what)


def _compare(got, want, coef_tol, rtol, atol=0.0):
    assert set(got) == set(want)
    assert {**got["config"], "output_dir": ""} == {**want["config"], "output_dir": ""}
    assert tuple(got["working_shape"]) == tuple(int(v) for v in want["working_shape"])
    assert [r["name"] for r in got["results"]] == [r["name"] for r in want["results"]]
    for g, w in zip(got["results"], want["results"]):
        assert set(g) == set(w) and g["names"] == w["names"], w["name"]
        cw = np.asarray(w["coeffs"])
        _close(g["coeffs"], cw, 0, coef_tol * np.abs(cw).max(), w["name"])
        assert g["n_active"] == w["n_active"] and g["n_total"] == w["n_total"], w["name"]
        _close([g[k] for k in METRICS], [w[k] for k in METRICS], rtol, atol, w["name"])
        keys = sorted(w["rollout"])
        assert sorted(g["rollout"]) == keys
        _close([g["rollout"][k][m] for k in keys for m in ("rmse", "nrmse")],
               [w["rollout"][k][m] for k in keys for m in ("rmse", "nrmse")], rtol, atol, w["name"])
    for key in ("best_simple", "best_overall"):
        assert got[key]["name"] == want[key]["name"], key
        assert got[key]["selection"] == want[key]["selection"], key
    for key in ("spatial_holdout", "spatial_holdout_top_bottom"):
        g, w = got[key], want[key]
        assert set(g) == set(w), key
        if w:
            assert g["terms"] == w["terms"] and g["space_split"] == w["space_split"]
            cw = np.asarray(w["coeffs"])
            _close(g["coeffs"], cw, 0, coef_tol * np.abs(cw).max(), key)
            for part in ("train", "test"):
                assert list(g[part]) == list(w[part])
                _close(list(g[part].values()), list(w[part].values()), rtol, atol, key)
    for key in ("rollout_time_test", "rollout_space_lr", "rollout_space_tb"):
        assert list(got[key]) == list(want[key])
        _close([got[key][k][m] for k in want[key] for m in ("rmse", "nrmse")],
               [want[key][k][m] for k in want[key] for m in ("rmse", "nrmse")], rtol, atol, key)


def test_run_matches_pdx_registration_off(off):
    """Models 1-7 (the batched six, Model 7 on its own), selection, both
    spatial holdouts, the best model's masked rollouts; the equations."""
    want, got, _ = off
    _compare(got, want, 1e-10, 1e-8)
    assert len(got["results"]) == 7
    for g, w in zip(got["results"], want["results"]):
        assert g["equation"] == w["equation"]
    np.testing.assert_array_equal(got["results"][0]["coeffs"], got["results"][1]["coeffs"])  # the reference's quirk


def _json_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k != "generated_at":  # a timestamp
                _json_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        _close(got, want, 1e-8, 1e-10 * max(1.0, abs(want)), path)
    else:
        assert got == want, path


def test_artifacts_match_pdx(off):
    """The three JSON artifacts, key for key and value for value (the
    timestamp aside), and the same figure files."""
    _want, _got, (pdx_dir, port_dir) = off
    for name in ("best_model.json", "models_comparison.json", "best_model_baseline.json"):
        want = json.loads((pdx_dir / name).read_text())
        got = json.loads((port_dir / name).read_text())
        assert "generated_at" in got or name == "best_model_baseline.json"
        _json_close(got, want, name)
    assert sorted(p.name for p in port_dir.glob("*.png")) == sorted(p.name for p in pdx_dir.glob("*.png"))
    assert (port_dir / "MODEL_COMPARISON.png").stat().st_size > 10_000
    assert any(port_dir.glob("FIG4_QUAL_ROLLOUT_K*.png")) and any(port_dir.glob("FIG4B_ERROR_GROWTH_PLUS_MAP_K*.png"))


def test_run_matches_pdx_registration_on():
    """The chain on 6 frames (auto mode), after reflect-border stabilisation."""
    U = as_grayscale_u8(make_synthetic_stack()[:6])
    kw = dict(data_dir="unused", max_images=6, registration=True, stabilize_translation=True,
              write_artifacts=False, **SMALL)
    want = ja.run(ja.AnalyzeConfig(**kw), U_raw=U)
    got = ta.run(ta.AnalyzeConfig(**kw), U_raw=U, device="cpu")
    _compare(got, want, 1e-5, 1e-4, 1e-5)


def test_run_matches_pdx_robust():
    """Per-model robust STRidge (trim, 30 bootstrap members, Huber) and the
    robust spatial holdouts, on frames with 0.2% noise (F6)."""
    U = make_synthetic_stack().astype(np.float64) / 60000
    U = U + 0.002 * np.random.default_rng(5).normal(size=U.shape)
    kw = dict(data_dir="unused", max_images=12, registration=False, robust_regression=True,
              write_artifacts=False, **SMALL)
    want = ja.run(ja.AnalyzeConfig(**kw), U_raw=U)
    got = ta.run(ta.AnalyzeConfig(**kw), U_raw=U, device="cpu")
    _compare(got, want, 1e-10, 1e-8)


@pytest.mark.parametrize("kw", [
    dict(register_mode="compose"),
    dict(register_mode="to_first", register_refine=0),
    dict(register_mode="chain", reference_compat_warp=True),
    dict(register_mode="auto", stabilize_translation=True, stabilize_mode="to_first"),
])
def test_preprocess_passes_every_registration_option(kw):
    """preprocess hands each registration option to the register dispatch
    and the stabiliser (both held to pdx in test_torch_patch_discovery.py
    and test_torch_phasecorr.py): its frames equal those pieces chained by
    hand, and run gives finite results."""
    U = as_grayscale_u8(make_synthetic_stack()[:6])
    cfg = ta.AnalyzeConfig(data_dir="unused", max_images=6, write_artifacts=False, **SMALL, **kw)
    V = resize_denoise_normalize(torch.from_numpy(U), out_h=64, out_w=64, sigma=1.0)
    if cfg.stabilize_translation:
        V = stabilize_translation_sequence(V, mode=cfg.stabilize_mode, estimate_sigma_px=2.0, border="reflect",
                                           smooth="reflect")
    V = register_sequence_dispatch(V, mode=cfg.register_mode, refine=cfg.register_refine,
                                   reference_compat_warp=cfg.reference_compat_warp)
    from pdx_torch.ops.filters import gaussian_filter_reflect

    want = gaussian_filter_reflect(V, 1.5)[:, 10:-10:4, 10:-10:4]
    torch.testing.assert_close(ta.preprocess(cfg, U, device="cpu"), want, rtol=0, atol=0)
    out = ta.run(cfg, U_raw=U, device="cpu")
    assert all(np.isfinite(r["r2"]) for r in out["results"]) and out["best_overall"]["name"] in ta.MODELS


def test_tables_and_sliced_fields_match_pdx():
    assert ta.MODELS == ja.MODELS and ta.ANALYZE_DISPLAY == ja.ANALYZE_DISPLAY
    assert [f.name for f in dataclasses.fields(ta.AnalyzeConfig)] == [f.name for f in dataclasses.fields(ja.AnalyzeConfig)]
    assert dataclasses.asdict(ta.AnalyzeConfig()) == dataclasses.asdict(ja.AnalyzeConfig())
    import jax.numpy as jnp

    U = np.random.default_rng(0).normal(size=(7, 9, 11))
    cfg = ta.AnalyzeConfig()
    got, got_ut, got_shape = ta.sliced_fields(cfg, torch.from_numpy(U))
    want, want_ut, want_shape = ja.sliced_fields(ja.AnalyzeConfig(), jnp.asarray(U))
    assert got_shape == want_shape == (5, 7, 9) and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12, atol=1e-12 * np.abs(np.asarray(want[k])).max())
    np.testing.assert_allclose(got_ut.numpy(), np.asarray(want_ut), rtol=1e-12)
    assert ta._equation(np.array([0.5, -1e-6, -2.0]), ["u", "ux", "lap"]) == ja._equation(
        np.array([0.5, -1e-6, -2.0]), ["u", "ux", "lap"])


def test_config_from_env(monkeypatch):
    for env in ({"PDE_ROLLOUT_STEPS": "2-4", "PDE_STABILIZE_TRANSLATION": "yes", "PDE_STABILIZE_MODE": "to_first",
                 "PDE_STABILIZE_EST_SIGMA": "3.5", "PDE_ROBUST_REGRESSION": "1"},
                {"PDE_ROLLOUT_STEPS": "5,1,3,-2"}, {"PDE_ROLLOUT_STEPS": "9-7"}, {"PDE_ROLLOUT_STEPS": " "}):
        for k in ("PDE_ROLLOUT_STEPS", "PDE_STABILIZE_TRANSLATION", "PDE_STABILIZE_MODE", "PDE_STABILIZE_EST_SIGMA",
                  "PDE_ROBUST_REGRESSION"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = ta.config_from_env(ta.AnalyzeConfig())
        assert dataclasses.asdict(got) == dataclasses.asdict(ja.config_from_env(ja.AnalyzeConfig()))


def test_cli_parse_matches_pdx(monkeypatch):
    """Every flag of `pdx analyze` gives the configuration pdx's parser
    gives; --device is the port's own (default cuda)."""
    seen = {}
    monkeypatch.setattr(ja, "run", lambda cfg, timer=None: seen.setdefault("cfg", cfg) and {
        "best_overall": {"name": "", "equation": "", "r2": 0.0}, "best_simple": {"name": "", "equation": ""}})
    monkeypatch.setenv("PDE_ROLLOUT_STEPS", "1,4")
    argv = ["--data-dir", "d", "--output-dir", "o", "--max-images", "9", "--robust", "--stabilize",
            "--no-registration", "--register-mode", "to_first", "--register-refine", "2", "--reference-compat-warp",
            "--include-fourth-order", "--dtype", "float32", "--skip", "7", "--subsample", "3"]
    for args in (argv, []):
        seen.clear()
        ja.cmd_analyze(args)
        cfg, device, profile = ta.parse_args(args)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["cfg"]) and device == "cuda" and not profile
    assert ta.parse_args(["--device", "cpu", "--profile"])[1:] == ("cpu", True)


def test_cli_device_cpu(tiff_dir, tmp_path, capsys):
    argv = ["analyze", "--data-dir", str(tiff_dir), "--output-dir", str(tmp_path), "--max-images", "12",
            "--no-registration", "--skip", "10", "--subsample", "4", "--profile", "--device", "cpu"]
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert "Best overall: Model" in out and "Best simple:  Model" in out and "models_batched" in out
    assert json.loads((tmp_path / "best_model.json").read_text())["name"].startswith("Model")


def test_run_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ta.run(ta.AnalyzeConfig(**SMALL), U_raw=as_grayscale_u8(make_synthetic_stack()[:4]))


# --- the card: analyze at the real dataset's shape, its artifacts, and against the CPU -----------------------------

# pdx's artifact schema: pdx/io_host/artifacts.py:47-147 and the baseline at pdx/pipelines/analyze.py:644-664
BEST_MODEL_KEYS = {
    "generated_at", "selection", "train_frac", "name", "r2", "rmse", "mae", "nrmse", "corr", "resid_med_abs",
    "one_step_rmse", "train_r2", "train_rmse", "train_nrmse", "train_corr", "train_one_step_rmse", "n_active",
    "n_total", "equation", "terms", "coeffs", "spatial_holdout", "spatial_holdout_top_bottom", "rollout_time_test",
    "rollout_space_test_left_right", "rollout_space_test_top_bottom",
}
COMPARISON_KEYS = {"generated_at", "train_frac", "space_train_frac", "rollout_steps", "use_robust_regression",
                   "best_simple", "best_overall", "models"}
COMPARISON_MODEL_KEYS = {"name", "r2_test", "rmse_test", "nrmse_test", "corr_test", "one_step_rmse", "n_active",
                         "n_total", "equation", "terms", "coeffs", "rollout", "rollout_curve_test"}
BASELINE_KEYS = {"selection", "name", "r2", "rmse", "nrmse", "corr", "one_step_rmse", "n_active", "n_total",
                 "equation", "terms", "coeffs", "rollout_time_test"}


def _full_size_gates(out: dict, n_models: int) -> None:
    """n_models results, every R2 and k-step metric finite, Models 1 and 2
    with equal coefficients (the reference's quirk), a known best model."""
    res = out["results"]
    assert len(res) == n_models
    for r in res:
        assert all_finite([r["r2"], r["train_r2"]] + [v for m in r["rollout"].values() for v in m.values()]), r["name"]
    np.testing.assert_array_equal(res[0]["coeffs"], res[1]["coeffs"])
    assert out["best_overall"]["name"] in list(ta.MODELS) + [ta.MODEL7]


@pytest.fixture(scope="module")
def full_run():
    """The default configuration (2x downsample, the 50-flow chain, six
    models) on the real dataset's shape read as 8-bit grayscale."""
    cfg = ta.AnalyzeConfig(data_dir="unused", write_artifacts=False)
    U = full_u8()  # skips without a card
    with launches() as moved:
        out = ta.run(cfg, U_raw=U, device=card())
    return cfg, U, out, moved


@pytest.mark.gpu
def test_full_size_on_the_card(full_run):
    _cfg, _U, out, moved = full_run
    _full_size_gates(out, 6)
    assert_no_gram_kernel(moved)


@pytest.mark.gpu
@pytest.mark.parametrize("kw,n_models", [(dict(robust_regression=True), 6), (dict(include_fourth_order=True), 7)],
                         ids=["robust", "model7"])
def test_full_size_robust_and_model7_on_the_card(full_run, kw, n_models):
    cfg, U, _out, _moved = full_run
    with launches() as moved:
        out = ta.run(dataclasses.replace(cfg, **kw), U_raw=U, device=card())
    _full_size_gates(out, n_models)
    assert_no_gram_kernel(moved)


@pytest.mark.gpu
def test_full_size_artifacts_match_pdx_schema(full_run, tmp_path):
    """best_model.json, models_comparison.json and best_model_baseline.json
    hold pdx's keys (the figures are skipped without matplotlib, as pdx
    skips them)."""
    cfg, U, _out, _moved = full_run
    ta.run(dataclasses.replace(cfg, write_artifacts=True, output_dir=str(tmp_path)), U_raw=U, device=card())
    files = {n: json.loads((tmp_path / n).read_text()) for n in
             ("best_model.json", "models_comparison.json", "best_model_baseline.json")}
    assert set(files["best_model.json"]) == BEST_MODEL_KEYS
    assert set(files["models_comparison.json"]) == COMPARISON_KEYS
    assert set(files["best_model_baseline.json"]) == BASELINE_KEYS
    models = files["models_comparison.json"]["models"]
    assert len(models) == 6 and all(set(m) == COMPARISON_MODEL_KEYS for m in models)


@pytest.mark.gpu
def test_fig4_snapshot_data_card_matches_cpu(full_run):
    """FIG4's rollouts and error maps, the device work outside the
    pipeline's figure guard, called as the pipeline calls it: the same
    horizons, error maps within 1e-6 of their max (float32), nRMSE curves
    within 1e-9 relative, NaN (a horizon with no valid start) on both
    alike."""
    from pdx_torch.report.figures import fig4_snapshot_data

    cfg, U, out, _moved = full_run
    u = ta.sliced_fields(cfg, ta.preprocess(cfg, U, device=card()))[0]["u"]
    test_sl = ta._split_slices(u.shape[0], cfg.train_frac)[1]
    kw = dict(test_start=test_sl.start, test_stop=test_sl.stop, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy,
              k_default=cfg.rollout_steps[-1] if cfg.rollout_steps else 10)
    got, want = fig4_snapshot_data(u, out["results"], **kw), fig4_snapshot_data(u.cpu(), out["results"], **kw)
    assert got["ks"] == want["ks"] and np.isfinite(got["maps"]).all()
    assert np.abs(got["maps"] - want["maps"]).max() / np.abs(want["maps"]).max() < 1e-6
    for c in ("curve4", "curve3"):
        assert np.array_equal(np.isnan(got[c]), np.isnan(want[c]))
        assert np.nanmax(np.abs(got[c] - want[c]) / np.abs(want[c])) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("registration", [False, True])
def test_card_matches_cpu(registration):
    """12 x 128 x 128 frames read as 8-bit. Registration off: Models 1-5
    within 1e-10 of max|coef|, Model 6 within 1e-9 (its 13 columns, u, u^2
    and u^3 among them, amplify the Gram's summation order: 1.2e-10 measured
    on the H100). Registration on: 1e-5 (the chain's flows are float32;
    64 px working frames run the flow at full resolution on both). The same
    supports and selections."""
    from tools.make_synth_stack import make_stack

    U = (make_stack(T=12, H=128, W=128, seed=1) >> 8).astype(np.uint8)
    cfg = ta.AnalyzeConfig(data_dir="unused", max_images=12, registration=registration, write_artifacts=False, **SMALL)
    on_card, on_cpu = (ta.run(cfg, U_raw=U, device=d) for d in (card(), "cpu"))
    for a, b in zip(on_card["results"], on_cpu["results"]):
        tol = 1e-5 if registration else 1e-9 if a["name"].startswith("Model 6") else 1e-10
        cb = np.asarray(b["coeffs"])
        assert np.abs(np.asarray(a["coeffs"]) - cb).max() / np.abs(cb).max() < tol, a["name"]
        assert a["n_active"] == b["n_active"], a["name"]
    for k in ("best_simple", "best_overall"):
        assert on_card[k]["name"] == on_cpu[k]["name"]
