"""pdx_torch.pipelines.sindy1d against pdx.pipelines.sindy1d, float64, at
n_steps=400 (20 time units of KS-1D, N = 200).

Every scenario (clean, noisy, shifted with and without registration by
either method, varying_ic), both derivatives, every denoiser and every
regressor: coefficients within 1e-9 of max|coef| (measured <= 4e-12; the
trajectories agree to ~5e-12, the FFT derivatives and the fits add no more),
R2 and the MAD noise estimate within 1e-9, the same F1 support score. The
noise, shift and subsample draws are numpy generators on the host in both
packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pdx_torch import __main__ as tmain
from pdx_torch.pipelines import sindy1d as ts
from pdx_torch.sim import ks1d as tks
from torch_card import GRAM_KERNELS, cuda, launches

TOL = 1e-9
STEPS = 400


@pytest.fixture(scope="module")
def js():
    """pdx's pipeline, imported by the tests that use it, so that the
    ``gpu`` tests run on a machine without jax (``pytest --noconftest -m
    gpu``)."""
    from pdx.pipelines import sindy1d

    return sindy1d

CASES = [dict(scenario=s, derivative=d, regressor=r)
         for s in ("clean", "noisy", "shifted", "varying_ic")
         for d in ("spectral", "finite") for r in ("lasso", "stridge", "lstsq")]
CASES += [dict(scenario="noisy", denoise=dn, regressor="stridge") for dn in ("spectral", "gaussian", "savgol")]
CASES += [dict(scenario="shifted", register=True, register_method=m, regressor=r)
          for m in ("crosscorr", "phasecorr") for r in ("stridge", "lasso")]


def _id(kw):
    return "-".join(str(v) for v in kw.values())


@pytest.mark.parametrize("kw", CASES, ids=[_id(k) for k in CASES])
def test_run_matches_pdx(kw, js):
    want = js.run(js.Sindy1dConfig(n_steps=STEPS, **kw))
    got = ts.run(ts.Sindy1dConfig(n_steps=STEPS, **kw), "cpu")
    assert set(got) == set(want)
    assert got["config"] == want["config"] and got["term_names"] == want["term_names"]
    c, cj = got["coeffs"], np.asarray(want["coeffs"])
    np.testing.assert_allclose(c, cj, rtol=0, atol=TOL * np.abs(cj).max())
    np.testing.assert_allclose(got["rel_err_pct"], want["rel_err_pct"], rtol=0, atol=TOL * 100)
    np.testing.assert_array_equal(got["true_coeffs"], want["true_coeffs"])
    assert abs(got["r2"] - want["r2"]) < TOL
    assert got["f1_support"] == want["f1_support"]
    np.testing.assert_allclose(got["noise_mad_estimate"], want["noise_mad_estimate"], rtol=TOL)


def test_config_fields(js):
    assert [(f.name, f.default) for f in dataclasses.fields(ts.Sindy1dConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(js.Sindy1dConfig)]


def test_clean_recovery_and_registration_helps():
    clean = ts.run(ts.Sindy1dConfig(n_steps=STEPS, regressor="stridge"), "cpu")
    assert clean["rel_err_pct"].max() < 5.0 and clean["f1_support"] == 1.0
    bad = ts.run(ts.Sindy1dConfig(n_steps=STEPS, scenario="shifted", regressor="stridge"), "cpu")
    good = ts.run(ts.Sindy1dConfig(n_steps=STEPS, scenario="shifted", register=True, regressor="stridge"), "cpu")
    assert good["rel_err_pct"].max() < bad["rel_err_pct"].max()


@pytest.mark.parametrize("n_steps", [30, 2000])
def test_register_1d_recovers_the_shifts_exactly(n_steps, js):
    """Cross-correlation against the mean frame undoes
    spatially_shifted_data's integer rolls (the first maximum of each
    correlation, the wrap of shifts above n / 2, one roll a frame), as pdx's
    does. The initial condition sin(16 pi x / L) repeats every 25 samples
    and the flow keeps that period to round-off, so a shift is recovered up
    to a multiple of 25 samples, which moves the values by ~1e-13: the
    aligned frames equal the clean ones, and pdx's, within 1e-12 of max|u|
    (every frame is aligned to the true shift, modulo 25)."""
    import jax.numpy as jnp

    cfg = tks.Ks1dConfig(n_steps=n_steps)
    shifted, shifts = tks.spatially_shifted_data(cfg)
    assert len(set(shifts.tolist())) > 1
    aligned = ts.register_1d(shifted, "crosscorr")
    clean = tks.simulate_ks1d(cfg)
    scale = float(clean.abs().max())
    np.testing.assert_allclose(aligned.numpy(), clean.numpy(), rtol=0, atol=1e-12 * scale)
    want = np.asarray(js.register_1d(jnp.asarray(shifted.numpy())))
    np.testing.assert_allclose(aligned.numpy(), want, rtol=0, atol=1e-12 * scale)
    for t in range(0, n_steps + 1, max(1, n_steps // 20)):  # the recovered shift, frame by frame
        off = [float((aligned[t] - torch.roll(clean[t], c)).abs().max()) for c in range(-12, 13)]
        assert (int(np.argmin(off)) - 12) % 25 == 0


def test_register_1d_phasecorr_matches_pdx(js):
    import jax.numpy as jnp

    shifted, _ = tks.spatially_shifted_data(tks.Ks1dConfig(n_steps=60))
    noisy = shifted + 0.05 * torch.from_numpy(np.random.default_rng(1).normal(size=tuple(shifted.shape)))
    got = ts.register_1d(noisy, "phasecorr").numpy()
    np.testing.assert_array_equal(got, np.asarray(js.register_1d(jnp.asarray(noisy.numpy()), "phasecorr")))


def test_noise_mad_averages_the_middle_pair(js):
    """jnp.median averages the two middle values of an even count;
    torch.median would take the lower one."""
    import jax.numpy as jnp

    U = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 5)))  # 4 x 5 = 20 second differences
    d2 = (U[2:] - 2 * U[1:-1] + U[:-2]).abs().reshape(-1)
    s = torch.sort(d2).values
    assert s[9] != s[10]
    got = float(ts.estimate_noise_mad(U))
    np.testing.assert_allclose(got, 1.4826 * float(0.5 * (s[9] + s[10])) / np.sqrt(6.0), rtol=1e-15)
    np.testing.assert_allclose(got, float(js.estimate_noise_mad(jnp.asarray(U.numpy()))), rtol=1e-15)
    assert got != 1.4826 * float(torch.median(d2)) / np.sqrt(6.0)


def test_ensemble_over_ics_matches_pdx(js):
    want = js.ensemble_over_ics(js.Sindy1dConfig(n_steps=STEPS))
    got = ts.ensemble_over_ics(ts.Sindy1dConfig(n_steps=STEPS), device="cpu")
    assert set(got) == set(want) and got["all"].shape == (5, 3)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL * np.abs(want["all"]).max())


def test_build_library_matches_pdx(js):
    import jax.numpy as jnp

    U = tks.simulate_ks1d(tks.Ks1dConfig(n_steps=30))
    for deriv in ("spectral", "finite"):
        X, y = ts.build_library_1d(U, 100.0, 0.05, deriv)
        Xj, yj = js.build_library_1d(jnp.asarray(U.numpy()), 100.0, 0.05, deriv)
        np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-12 * np.abs(np.asarray(Xj)).max())
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-12 * np.abs(np.asarray(yj)).max())


def test_entry_points_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.run(ts.Sindy1dConfig(n_steps=10))
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.ensemble_over_ics(ts.Sindy1dConfig(n_steps=10))


def test_cli(capsys):
    assert tmain.main(["sindy1d", "--n-steps", "200", "--regressor", "stridge", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Estimated noise (MAD)" in out and "F1(support)=1.000" in out and "u_xxxx" in out


@pytest.mark.gpu
@pytest.mark.parametrize("kw", CASES, ids=[_id(k) for k in CASES])
def test_run_on_the_card(cuda, kw):
    got = ts.run(ts.Sindy1dConfig(n_steps=STEPS, **kw), cuda)
    want = ts.run(ts.Sindy1dConfig(n_steps=STEPS, **kw), "cpu")
    np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=0, atol=TOL * np.abs(want["coeffs"]).max())
    assert got["f1_support"] == want["f1_support"]


# the worst relative error of clean STRidge at the default size, from pdx on the CPU in float64; the flow is chaotic
# over 2000 steps, so the card's run (or the port's on the CPU: 0.46590%) lands near it, not on it: 10% more allowed
PDX_CLEAN_STRIDGE_WORST = 0.46654244087340757


@pytest.mark.gpu
def test_every_configuration_at_full_size_on_the_card(cuda):
    """Every configuration at the default size (KS-1D, N = 200, 2000 ETD
    steps) and ensemble_over_ics: finite coefficients and R2, clean STRidge
    at pdx's error, registration lowering the shifted data's error, no
    kernel launched."""
    worst = {}
    with launches(GRAM_KERNELS) as moved:
        for kw in CASES:
            out = ts.run(ts.Sindy1dConfig(**kw), cuda)
            assert np.isfinite(out["coeffs"]).all() and np.isfinite(out["r2"]), kw
            worst[_id(kw)] = float(out["rel_err_pct"].max())
        ens = ts.ensemble_over_ics(ts.Sindy1dConfig(), device=cuda)
    assert not any(moved.values()), moved
    assert np.isfinite(ens["all"]).all()
    assert worst["clean-spectral-stridge"] < 1.1 * PDX_CLEAN_STRIDGE_WORST
    assert worst["shifted-True-crosscorr-stridge"] < worst["shifted-spectral-stridge"]
