"""The port's main path as a whole: pdx_torch.pipelines.ks2d_bench against
pdx.pipelines.ks2d_bench at Nx = Ny = 32, n_seconds = 0.2.

Tolerances:
* solver "auto", float64: coefficients at rtol 1e-8 (same RNG draws, same
  rows, float64 throughout). The rollout mean at rtol 1e-6, with atol 1e-16:
  its errors are ~1e-12 because the recovered coefficients sit ~1e-9 off the
  truth, so a last-bit difference in those coefficients moves it by ~1e-17,
  below the float64 resolution of the O(0.1) state.
* solver "pallas", float32 frames: coefficients at rtol 1e-3 — pdx's kernel
  sums in float32, the port's in float64 (the rich cases with an absolute
  floor of 1e-3 * max|coef|, for decoys that STRidge leaves near 0).
* prepare_frames (perturb, stabilise, denoise), float64: every frame stack
  at 1e-10 of max|ref| (host-drawn noise is the same on both sides; FFT
  round-off in the phase correlation and blur is the only difference).
* derivatives="spectral" on the auto path, float64: coefficients at 1e-8
  (the rich library's near-zero `one` coefficient: see its test).
Coefficients are compared, not the selected (alpha, threshold): R^2 ties
between thresholds may break differently in the last bit.

The configurations outside the grid-search fast path (the dataset /
regression branch) are in test_torch_ks2d_slow.py.
"""

import dataclasses
import functools
import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdx.pipelines.ks2d_bench as jb
import pdx_torch.pipelines.ks2d_bench as tb
from pdx.ops.linalg import gram_stats as jgram
from pdx_torch.__main__ import main as cli_main
from pdx_torch.interop import frames_from_numpy, stats_from_numpy
from pdx_torch.ops.kernels.fused_blockwise import fused_blockwise_gram, fused_blockwise_gram_terms
from pdx_torch.ops.kernels.fused_gram import fused_ks_gram, fused_ks_gram_terms

SMALL = dict(grid_search=True, Nx=32, Ny=32, n_seconds=0.2)
CASES = {
    "auto_f64": dict(),
    "pallas_f32": dict(solver="pallas", dtype="float32"),
    "pallas_blockwise_f32": dict(solver="pallas", dtype="float32", method="blockwise"),
    "pallas_rich_f32": dict(solver="pallas", dtype="float32", dictionary="rich"),
    "pallas_blockwise_rich_f32": dict(solver="pallas", dtype="float32", method="blockwise", dictionary="rich"),
    "pallas_adv_f32": dict(solver="pallas", dtype="float32", include_advection=True),
    "pallas_blockwise_noadv_f32": dict(
        solver="pallas", dtype="float32", method="blockwise", dictionary="rich", enforce_no_advection=True
    ),
}
PERTURBED = dict(
    method="blockwise", dictionary="rich", solver="pallas", perturbation="N5_shifts_noise",
    shift_mode="jitter", shift_max=1.0, stabilize_shifts=True, denoise_time_window=3, denoise_space_sigma=1.0,
)


@functools.lru_cache(maxsize=None)
def _pdx_run(case):
    return jb.run(jb.Ks2dBenchConfig(**SMALL, **CASES[case]))


@functools.lru_cache(maxsize=None)
def _port_run(case):
    return tb.run(tb.Ks2dBenchConfig(**SMALL, **CASES[case]), "cpu")


def _worst_gt(res):
    return max(v["rel_err_pct"] for v in res["gt_errors"].values())


def test_config_mirrors_pdx():
    want = [(f.name, f.default) for f in dataclasses.fields(jb.Ks2dBenchConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(tb.Ks2dBenchConfig)] == want
    assert (tb.KS_GT, tb.GRID_ALPHAS, tb.GRID_THRESHOLDS) == (jb.KS_GT, jb.GRID_ALPHAS, jb.GRID_THRESHOLDS)


def test_auto_f64_matches_pdx():
    got, want = _port_run("auto_f64"), _pdx_run("auto_f64")
    assert got["names"] == want["names"] and got["display_names"] == want["display_names"]
    np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=1e-8)
    np.testing.assert_allclose(got["rollout"]["mean"], want["rollout"]["mean"], rtol=1e-6, atol=1e-16)
    assert got["rollout"]["n_steps"] == want["rollout"]["n_steps"] == 50
    assert _worst_gt(got) < 1e-4


@pytest.mark.parametrize("case,counter", [
    ("pallas_f32", fused_ks_gram),
    ("pallas_blockwise_f32", fused_blockwise_gram),
])
def test_pallas_paths_match_pdx_interpret(case, counter):
    """On CPU tensors the K1/K3 wrappers take their plain versions (no launch)."""
    before = counter.launches
    got, want = _port_run(case), _pdx_run(case)
    assert counter.launches == before
    np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=1e-3)
    assert _worst_gt(got) < 1.0 and _worst_gt(want) < 1.0
    assert np.isfinite([got["rollout"][k] for k in ("first", "last", "mean")]).all()


@pytest.mark.parametrize("case,counter,n_terms", [
    ("pallas_rich_f32", fused_ks_gram_terms, 9),
    ("pallas_blockwise_rich_f32", fused_blockwise_gram_terms, 9),
    ("pallas_adv_f32", fused_ks_gram_terms, 5),
    ("pallas_blockwise_noadv_f32", fused_blockwise_gram_terms, 7),
])
def test_term_list_pallas_paths_match_pdx_interpret(case, counter, n_terms):
    """Term lists other than [lap, bih, gradsq] go to K2/K4 (plain versions
    on CPU tensors: no launch) and match pdx's generic Pallas kernels."""
    before = counter.launches
    got, want = _port_run(case), _pdx_run(case)
    assert counter.launches == before
    assert got["names"] == want["names"] and len(got["coeffs"]) == n_terms
    c, w = np.asarray(got["coeffs"]), np.asarray(want["coeffs"])
    np.testing.assert_allclose(c, w, rtol=1e-3, atol=1e-3 * np.abs(w).max())
    assert _worst_gt(got) < 2.0 and _worst_gt(want) < 2.0
    assert np.isfinite([got["rollout"][k] for k in ("first", "last", "mean")]).all()


def _frames_close(got, want, tol=1e-10):
    for k in ("U_clean", "U", "U_for_ut", "U_for_features"):
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float64 and got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=tol * np.abs(w).max(), err_msg=k)
    assert (got["dx"], got["dy"], got["DT"]) == (want["dx"], want["dy"], want["DT"])


@pytest.mark.parametrize("kw", [
    dict(perturbation="N2_noise"),
    dict(perturbation="N5_shifts_noise", shift_mode="jitter", shift_max=1.0, stabilize_shifts=True),
    dict(perturbation="N7_all", denoise_time_window=3, denoise_space_sigma=1.0),
    dict(perturbation="N1_shifts", stabilize_shifts=True, stabilize_mode="to_prev", denoise_time_window=5,
         denoise_space_sigma=0.8, denoise_space_on="all"),
], ids=["N2", "N5_jitter_stabilised", "N7_denoised", "N1_to_prev_denoise_all"])
def test_prepare_frames_matches_pdx(kw):
    cfg = dict(SMALL, n_seconds=0.1, **kw)
    got = tb.prepare_frames(tb.Ks2dBenchConfig(**cfg), "cpu")
    want = jb.prepare_frames(jb.Ks2dBenchConfig(**cfg))
    _frames_close(got, want)
    assert tb._effective_noise_rel(tb.Ks2dBenchConfig(**cfg)) == jb._effective_noise_rel(jb.Ks2dBenchConfig(**cfg))


def test_perturbed_blockwise_rich_matches_pdx():
    """The perturbed configuration of the slice: N5 jitter, stabilised,
    denoised in time and space, rich blockwise statistics (K4's plain
    version here). float32 as the Pallas cases: coefficients at rtol 1e-3."""
    cfg = dict(SMALL, dtype="float32", **PERTURBED)
    before = fused_blockwise_gram_terms.launches
    got, want = tb.run(tb.Ks2dBenchConfig(**cfg), "cpu"), jb.run(jb.Ks2dBenchConfig(**cfg))
    assert fused_blockwise_gram_terms.launches == before
    c, w = np.asarray(got["coeffs"]), np.asarray(want["coeffs"])
    assert len(c) == 9 and np.isfinite(c).all()
    np.testing.assert_allclose(c, w, rtol=1e-3, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("dictionary,floor", [("true", 1e-12), ("rich", 1e-6)])
def test_spectral_derivatives_auto_matches_pdx(dictionary, floor):
    """derivatives="spectral" on the auto (Gram) path; pdx's fast path builds
    the dictionary without spectral_cutoff, and so does the port. Rich
    library: the selected fit keeps the `one` coefficient at ~1e-7 of
    max|coef|, a value set by round-off divided by the ridge alpha (it
    shrinks 10x per decade of alpha, in pdx and the port alike), so the
    absolute floor there is 1e-6 * max|coef|; every other coefficient is
    held at rtol 1e-8."""
    kw = {**SMALL, "n_seconds": 0.1, "derivatives": "spectral", "spectral_cutoff": 0.5, "dictionary": dictionary}
    got, want = tb.run(tb.Ks2dBenchConfig(**kw), "cpu"), jb.run(jb.Ks2dBenchConfig(**kw))
    assert got["names"] == want["names"]
    w = np.asarray(want["coeffs"])
    np.testing.assert_allclose(got["coeffs"], w, rtol=1e-8, atol=floor * np.abs(w).max())
    rest = [i for i, n in enumerate(got["names"]) if n != "one"]
    np.testing.assert_allclose(np.asarray(got["coeffs"])[rest], w[rest], rtol=1e-8, atol=1e-12)


def test_pdx_trajectory_through_port_grid():
    """pdx's own frames (interop) through the port's pointwise grid: the whole
    5 x 6 coefficient grid agrees with pdx's at rtol 1e-8, so the regression
    is checked apart from the simulation."""
    cfg = jb.Ks2dBenchConfig(**SMALL)
    jfr = jb.prepare_frames(cfg)
    fr = frames_from_numpy({k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in jfr.items()})
    assert fr["U"].dtype == torch.float64 and fr["sim"].Nx == 32
    rng = np.random.default_rng(0)
    n_ut = (fr["U"].shape[0] - 1) * 32 * 32
    flat = rng.choice(n_ut, size=50_000, replace=False)
    perm = rng.permutation(50_000)
    tr, te = perm[:35_000], perm[35_000:]
    names = ("lap", "bih", "gradsq")
    want = jb._fused_pointwise_grid(
        jfr["U_for_ut"], jfr["U_for_features"], jnp.asarray(flat), jnp.asarray(tr), jnp.asarray(te),
        jfr["DT"], jfr["dx"], jfr["dy"], jnp.asarray(jb.GRID_ALPHAS), jnp.asarray(jb.GRID_THRESHOLDS),
        names, "finite", False,
    )
    got = tb._fused_pointwise_grid(
        fr["U_for_ut"], fr["U_for_features"], torch.from_numpy(flat), torch.from_numpy(tr), torch.from_numpy(te),
        fr["DT"], fr["dx"], fr["dy"], torch.tensor(tb.GRID_ALPHAS, dtype=torch.float64),
        torch.tensor(tb.GRID_THRESHOLDS, dtype=torch.float64), names, "finite", False,
    )
    assert got[0].shape == (5, 6, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-8)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    res = tb._run_fast_pointwise_grid(tb.Ks2dBenchConfig(**SMALL), fr, np.random.default_rng(0))
    np.testing.assert_allclose(res["coeffs"], _pdx_run("auto_f64")["coeffs"], rtol=1e-8)


def test_pdx_stats_through_port_grid_from_stats():
    """pdx's Gram statistics (interop) through the port's stats-only grid."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(5000, 3)) * [2.0, 30.0, 0.5]
    y = X @ [-1.0, -1.0, -0.5] + 1e-3 * rng.normal(size=5000)
    js = jgram(jnp.asarray(X), jnp.asarray(y))
    a, t = np.asarray(jb.GRID_ALPHAS), np.asarray(jb.GRID_THRESHOLDS)
    want = jb._grid_from_stats(js, jnp.asarray(a), jnp.asarray(t))
    got = tb._grid_from_stats(stats_from_numpy({k: np.asarray(v) for k, v in js.items()}), torch.from_numpy(a), torch.from_numpy(t))
    coeffs, r2, err, n_active = (g.numpy() for g in got)
    np.testing.assert_allclose(coeffs, np.asarray(want[0]), rtol=1e-8)
    np.testing.assert_allclose(r2, np.asarray(want[1]), rtol=0, atol=1e-12)
    # err = sqrt((syy - 2c.b + c'Gc) / n) cancels: its absolute error is
    # ~eps * syy, ~1e-7 relative to a residual this small
    np.testing.assert_allclose(err, np.asarray(want[2]), rtol=1e-5)
    np.testing.assert_array_equal(n_active, np.asarray(want[3]))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(method="nope"), ValueError, "method must be one of"),
    (dict(regression="nope"), ValueError, "regression must be one of"),
    (dict(solver="pallas", grid_search=False), ValueError, "fused streaming grid path"),
    (dict(solver="pallas", derivatives="spectral"), ValueError, "finite"),
    (dict(solver="pallas", method="weakform"), ValueError, "fused streaming grid path"),
    (dict(solver="pallas", regression="huber"), ValueError, "fused streaming grid path"),
    (dict(solver="pallas", robust=True), ValueError, "fused streaming grid path"),
    (dict(solver="pallas", correct_shift_ut=True), ValueError, "fused streaming grid path"),
    (dict(method="weakform", weak_operator="fd", weak_grad_cutoff=0.5), ValueError, "grad_cutoff only applies"),
    (dict(method="weakform", weak_basis="nope"), ValueError, "unknown weak-form basis"),
    (dict(dtype="float16"), ValueError, "dtype must be one of"),
])
def test_options_outside_the_slice_raise(kw, exc, match):
    """What pdx refuses, the port refuses with the same error; nothing that
    pdx accepts is refused (see test_torch_ks2d_slow.py for those runs)."""
    cfg = dict(SMALL, n_seconds=0.01, **kw)
    with pytest.raises(exc, match=match):
        tb.run(tb.Ks2dBenchConfig(**cfg), "cpu")
    if "dtype" not in kw:  # an unknown dtype fails inside jnp with its own message
        with pytest.raises(exc, match=match):
            jb.run(jb.Ks2dBenchConfig(**cfg))


def test_rich_dictionary_f64_matches_pdx():
    """The 9-term rich dictionary on the auto (Gram) path: decoys at exactly 0."""
    kw = {**SMALL, "n_seconds": 0.1, "dictionary": "rich"}
    got, want = tb.run(tb.Ks2dBenchConfig(**kw), "cpu"), jb.run(jb.Ks2dBenchConfig(**kw))
    assert got["names"] == want["names"] and len(got["coeffs"]) == 9
    np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("cmd", ["ks2d-bench", "ks2d-bench-json"])
def test_cli(cmd):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli_main([cmd, "--Nx", "16", "--Ny", "16", "--n-seconds", "0.05", "--grid-search", "--solver", "pallas", "--device", "cpu"])
    assert rc == 0
    text = out.getvalue()
    if cmd == "ks2d-bench-json":
        res = json.loads(text)
        assert res["names"] == ["lap", "bih", "gradsq"] and res["config"]["solver"] == "pallas"
    else:
        assert "Ground-truth comparison" in text and "Rollout RMSE" in text and "Train" not in text


@pytest.mark.parametrize("cmd", ["ks2d-bench", "ks2d-bench-json"])
def test_cli_default_invocation_and_robust_options(cmd):
    """Without --grid-search (pdx's own default invocation) the result has
    train metrics, which the text output prints; --robust puts tensors into
    robust_info, which the JSON output writes as lists."""
    small = ["--Nx", "16", "--Ny", "16", "--n-seconds", "0.05", "--n-sample", "1500", "--device", "cpu"]
    robust = ["--robust", "--n-bootstrap", "4", "--sign-constraints=-1,-1,-1", "--method", "weakform", "--weak-n-phi", "40"]
    for extra in ([], robust, ["--regression", "ensemble", "--n-bootstrap", "4"], ["--solver", "qr", "--correct-shift-ut"]):
        out = io.StringIO()
        with redirect_stdout(out):
            assert cli_main([cmd, *small, *extra]) == 0
        text = out.getvalue()
        if cmd == "ks2d-bench":
            assert "Train R2=" in text and "Test  R2=" in text
            continue
        res = json.loads(text)
        assert "train_r2" in res["fit"] and len(res["coeffs"]) == 3
        if extra is robust:
            info = res["robust_info"]
            assert info["n_bootstrap"] == 4 and all(len(info[k]) == 3 for k in ("std", "ci_95_low", "ci_95_high"))
        elif "ensemble" in extra:
            assert len(res["robust_info"]["std"]) == 3
        else:
            assert res["robust_info"] is None


def test_cli_without_device_needs_a_card(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU: with
    no card visible, the CLI without --device raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli_main(["ks2d-bench", "--Nx", "16", "--Ny", "16", "--n-seconds", "0.05", "--grid-search", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tb.run(tb.Ks2dBenchConfig(**dict(SMALL, n_seconds=0.01)))
