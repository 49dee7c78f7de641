"""The dataset / regression branch of pdx_torch.pipelines.ks2d_bench (every
configuration outside the grid-search fast path, and the fast path's QR
grid) against pdx.pipelines.ks2d_bench.run, end to end, at 24 x 24, 0.1 s.

Both draw the same host numpy rows (``choice`` in build_dataset, then
``permutation``; the bootstrap seeds 0 and 42), so in float64:

* coefficients agree at 1e-8 of max|coef| (observed ~1e-12; a trimmed set
  or a median would move a coefficient visibly if a round-off tie flipped,
  so the trimming cases carry a little noise: on clean data their residuals
  are round-off themselves, and the trimmed set with them);
* R^2 at 1e-9 absolute; RMSEs and rollout errors at rtol 1e-6 with an
  absolute floor of 1e-9 (clean fits leave residuals of ~1e-11, which are
  round-off themselves);
* the selected (alpha, threshold) equal.

The float32 QR grid is held to pdx in float32 at 1e-3 of max|coef|.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdx.pipelines.ks2d_bench as jb
import pdx_torch.pipelines.ks2d_bench as tb
from pdx_torch.interop import dataset_from_numpy, frames_from_numpy

SMALL = dict(Nx=24, Ny=24, n_seconds=0.1)
BLOCKS = dict(method="blockwise", block_x=4, block_y=4)
# one configuration for each row of chip_smoke.py's table of this branch, and the variants beside them
CASES = {
    "slow_pointwise": dict(),
    "slow_grid_blockwise": dict(grid_search=True, **BLOCKS),
    "weakform_fourier": dict(method="weakform", weak_basis="fourier", grid_search=True),
    "weakform_rich_fd": dict(
        method="weakform", dictionary="rich", weak_operator="fd", weak_basis="gaussian", grid_search=True
    ),
    "weakform_noisy_motion": dict(
        method="weakform", perturbation="N5_shifts_noise", shift_mode="jitter", weak_motion_correct=True
    ),
    "weakform_gaussian_spectral": dict(method="weakform", weak_n_phi=16, alpha=1e-6, threshold=1e-10),
    "huber_noisy": dict(regression="huber", perturbation="N2_noise", **BLOCKS),
    "robust_noisy": dict(
        robust=True, perturbation="N2_noise", noise_rel=0.002, n_bootstrap=6, sign_constraints=(-1, -1, -1), **BLOCKS
    ),
    "robust_signs_dropped": dict(
        robust=True, n_sample=3000, n_bootstrap=5, sign_constraints=(-1, 1), perturbation="N2_noise", noise_rel=0.002
    ),
    "ensemble": dict(regression="ensemble", n_sample=3000, n_bootstrap=6),
    "trimmed": dict(regression="trimmed", n_sample=3000, perturbation="N2_noise", noise_rel=0.002),
    "sign_constrained": dict(regression="sign_constrained", n_sample=3000, sign_constraints=(-1, -1, 1)),
    "qr_f64": dict(solver="qr", n_sample=5000),
    "qr_grid_f64": dict(solver="qr", n_sample=5000, grid_search=True),
    "qr_rich_f32": dict(dictionary="rich", dtype="float32", grid_search=True, n_sample=5000),
    "shift_ut": dict(perturbation="N1_shifts", correct_shift_ut=True, grid_search=True),
    "shift_ut_finite_adv": dict(
        perturbation="N1_shifts", shift_mode="jitter", shift_max=0.8, correct_shift_ut=True, ut_adv_deriv="finite",
        dictionary="rich", enforce_no_advection=True, derivatives="spectral", spectral_cutoff=0.6, n_sample=4000,
    ),
}


@functools.lru_cache(maxsize=None)
def _both(case):
    kw = {**SMALL, **CASES[case]}
    return tb.run(tb.Ks2dBenchConfig(**kw), "cpu"), jb.run(jb.Ks2dBenchConfig(**kw))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9, err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_run_matches_pdx(case):
    got, want = _both(case)
    assert list(got) == list(want), "same keys in the same order"
    assert got["names"] == want["names"] and got["display_names"] == want["display_names"]
    assert got["config"] == want["config"]
    f32 = CASES[case].get("dtype") == "float32"
    w = np.asarray(want["coeffs"])
    assert np.isfinite(w).all() and np.abs(w).max() > 0
    np.testing.assert_allclose(got["coeffs"], w, rtol=0, atol=(1e-3 if f32 else 1e-8) * np.abs(w).max())
    assert got["fit"]["n_active"] == want["fit"]["n_active"] and set(got["fit"]) == set(want["fit"])
    if f32:
        return
    for k in want["gt_errors"]:
        _close(got["gt_errors"][k]["rel_err_pct"], want["gt_errors"][k]["rel_err_pct"], k)
    for k, v in want["fit"].items():
        if k.endswith("r2"):
            np.testing.assert_allclose(got["fit"][k], v, rtol=0, atol=1e-9, err_msg=k)
        else:
            _close(got["fit"][k], v, k)
    for k, v in want["rollout"].items():
        _close(got["rollout"][k], v, k)
    if "grid_best" in want:
        gb, wb = got["grid_best"], want["grid_best"]
        assert (gb["alpha"], gb["threshold"], gb["n_active"]) == (wb["alpha"], wb["threshold"], wb["n_active"])
        np.testing.assert_allclose(gb["r2_test"], wb["r2_test"], rtol=0, atol=1e-9)
        _close(gb["rmse_test"], wb["rmse_test"], "rmse_test")


def test_robust_info_matches_pdx():
    """reg_info is merged into the result: robust_info with the members'
    spread (tensors, as pdx leaves arrays), {"std": ...} for the ensemble,
    None for a plain fit, absent under grid search."""
    got, want = _both("robust_noisy")
    gi, wi = got["robust_info"], want["robust_info"]
    assert set(gi) == set(wi) == {"std", "ci_95_low", "ci_95_high", "n_trimmed", "n_bootstrap"}
    assert (gi["n_trimmed"], gi["n_bootstrap"]) == (wi["n_trimmed"], wi["n_bootstrap"])
    scale = np.abs(np.asarray(want["coeffs"])).max()
    for k in ("std", "ci_95_low", "ci_95_high"):
        np.testing.assert_allclose(gi[k].numpy(), np.asarray(wi[k]), rtol=0, atol=1e-8 * scale, err_msg=k)
    got, want = _both("ensemble")
    assert set(got["robust_info"]) == set(want["robust_info"]) == {"std"}
    np.testing.assert_allclose(got["robust_info"]["std"].numpy(), np.asarray(want["robust_info"]["std"]), rtol=0, atol=1e-10)
    assert _both("slow_pointwise")[0]["robust_info"] is None and _both("slow_pointwise")[1]["robust_info"] is None
    assert "robust_info" not in _both("shift_ut")[0] and "grid_best" in _both("shift_ut")[0]


def test_sign_constraints_of_the_wrong_length_are_dropped():
    got, _want = _both("robust_signs_dropped")
    assert all(c < 0 for c in got["coeffs"])  # (-1, 1) on three terms would have zeroed `bih`


def test_auto_solver_probes_the_condition_in_float32(monkeypatch):
    """solver="auto" outside the fast path: float64 never probes; float32
    takes QR when cond of the standardized Gram in float32 exceeds 1e4
    (the rich library) and the Gram path otherwise (the true library)."""
    calls = []
    real = tb.stridge_qr_grid
    monkeypatch.setattr(tb, "stridge_qr_grid", lambda *a, **k: calls.append(1) or real(*a, **k))
    base = dict(SMALL, grid_search=True, **BLOCKS)
    for kw, expect_qr in [
        (dict(dtype="float32", dictionary="rich"), True),
        (dict(dtype="float32"), False),
        (dict(dtype="float64", dictionary="rich"), False),
        (dict(dtype="float32", solver="gram", dictionary="rich"), False),
    ]:
        calls.clear()
        res = tb.run(tb.Ks2dBenchConfig(**base, **kw), "cpu")
        assert bool(calls) == expect_qr, kw
        assert np.isfinite(res["coeffs"]).all()
    kw = dict(base, dtype="float32", dictionary="rich")
    got, want = tb.run(tb.Ks2dBenchConfig(**kw), "cpu"), jb.run(jb.Ks2dBenchConfig(**kw))
    w = np.asarray(want["coeffs"])
    np.testing.assert_allclose(got["coeffs"], w, rtol=0, atol=1e-3 * np.abs(w).max())


def test_pdx_rows_through_port_regression_grid_loop():
    """pdx's own dataset (interop) through the port's run_regression: the
    Python double loop over the grid that the robust regressions take, so
    the regression is checked apart from the dataset."""
    cfg = dict(SMALL, regression="sign_constrained", sign_constraints=(-1, -1, -1), grid_search=True, n_sample=2000)
    jcfg = jb.Ks2dBenchConfig(**cfg)
    names, X, y = jb.build_dataset(jcfg, jb.prepare_frames(jcfg), np.random.default_rng(0))
    X, y = np.asarray(X), np.asarray(y)
    tr, te = slice(0, 1400), slice(1400, None)
    want_c, want_info = jb.run_regression(jcfg, names, *map(jnp.asarray, (X[tr], y[tr], X[te], y[te])))
    tn, Xtr, ytr = dataset_from_numpy(names, X[tr], y[tr])
    _, Xte, yte = dataset_from_numpy(names, X[te], y[te])
    assert tn == names and Xtr.dtype == torch.float64 and Xtr.shape == (1400, 3)
    got_c, got_info = tb.run_regression(tb.Ks2dBenchConfig(**cfg), tn, Xtr, ytr, Xte, yte)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-8)
    gb, wb = got_info["grid_best"], want_info["grid_best"]
    assert set(gb) == set(wb)  # pdx leaves its sort key in this branch's grid_best, and so does the port
    assert (gb["alpha"], gb["threshold"], gb["n_active"]) == (wb["alpha"], wb["threshold"], wb["n_active"])


def test_pdx_frames_through_port_build_dataset():
    """pdx's frames (interop) through the port's build_dataset, with the
    u_t advection correction: the same rows at 1e-10 of each column's scale."""
    cfg = dict(SMALL, perturbation="N5_shifts_noise", shift_mode="jitter", shift_max=0.8, correct_shift_ut=True,
               ut_shift_smooth=3, dictionary="rich", n_sample=1500)
    jfr = jb.prepare_frames(jb.Ks2dBenchConfig(**cfg))
    fr = frames_from_numpy({k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in jfr.items()})
    gn, gX, gy = tb.build_dataset(tb.Ks2dBenchConfig(**cfg), fr, np.random.default_rng(0))
    wn, wX, wy = jb.build_dataset(jb.Ks2dBenchConfig(**cfg), jfr, np.random.default_rng(0))
    wX, wy = np.asarray(wX), np.asarray(wy)
    assert gn == wn and gX.shape == wX.shape == (1500, 9)
    np.testing.assert_allclose(gy.numpy(), wy, rtol=0, atol=1e-10 * np.abs(wy).max())
    for j, name in enumerate(wn):
        np.testing.assert_allclose(gX[:, j].numpy(), wX[:, j], rtol=0, atol=1e-10 * np.abs(wX[:, j]).max(), err_msg=name)


def test_rows_that_are_not_finite_are_filtered_before_the_split(monkeypatch):
    """Rows with a NaN or an inf leave before the permutation is drawn, so
    the split is over the valid rows, in pdx and in the port alike."""
    bad = [3, 17, 400, 401]

    def poisoned(real, to_host, from_host):
        def build(cfg, fr, rng):
            names, X, y = real(cfg, fr, rng)
            X, y = np.array(to_host(X)), np.array(to_host(y))
            X[bad[0], 1], X[bad[1], 0], y[bad[2]], y[bad[3]] = np.nan, np.inf, np.nan, -np.inf
            return names, from_host(X), from_host(y)
        return build

    monkeypatch.setattr(tb, "build_dataset", poisoned(tb.build_dataset, lambda t: t.numpy(), torch.from_numpy))
    monkeypatch.setattr(jb, "build_dataset", poisoned(jb.build_dataset, np.asarray, jnp.asarray))
    kw = dict(SMALL, n_sample=1000)
    got, want = tb.run(tb.Ks2dBenchConfig(**kw), "cpu"), jb.run(jb.Ks2dBenchConfig(**kw))
    assert np.isfinite(got["coeffs"]).all()
    np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=1e-8)
    _close(got["fit"]["test_rmse"], want["fit"]["test_rmse"], "test_rmse")
