"""pdx_torch.sim.ks1d against pdx.sim.ks1d, float64.

The ETD step runs the same rfft / irfft formulas on both sides (pocketfft
against XLA's FFT, and XLA's own sin and exp), so one step agrees to ~1e-15
and 400 steps to ~5e-12 of max|u|: the tests hold trajectories of 400 steps
within 1e-9 of max|u|. Over the default 2000 steps (100 time units) the
chaotic flow amplifies these last bits to O(0.1), in either package against
itself under a perturbation of one ulp, so longer runs are compared only
through statistics (the sindy1d pipeline's fits at 400 steps).
"""

import numpy as np
import pytest
import torch

import pdx_torch.sim.ks1d as tks
from torch_card import cuda


@pytest.fixture(scope="module")
def jks():
    """pdx's module, imported by the tests that use it, so that the ``gpu``
    test runs on a machine without jax (``pytest --noconftest -m gpu``)."""
    import pdx.sim.ks1d

    return pdx.sim.ks1d

TOL = 1e-9


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def test_config_fields(jks):
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(tks.Ks1dConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jks.Ks1dConfig)]


@pytest.mark.parametrize("N", [64, 200, 201])
def test_operators_and_ic(N, jks):
    import jax.numpy as jnp

    cfg = jks.Ks1dConfig(N=N)
    tcfg = tks.Ks1dConfig(N=N)
    # XLA's exp and sin against PyTorch's: ~2e-14 of the largest entry
    for got, want in zip(tks._operators(tcfg, torch.float64), jks._operators(cfg, jnp.float64)):
        _close(got, want, 1e-13)
    _close(tks.default_ic(tcfg), jks.default_ic(cfg), 1e-13)


def test_alias_mask_is_strict_two_thirds():
    """freqs < 2/3 max: the bin at exactly 2/3 of the top is dropped."""
    cfg = tks.Ks1dConfig(N=12)
    mask = tks._operators(cfg, torch.float64)[3]
    assert mask.tolist() == [1, 1, 1, 1, 0, 0, 0]  # rfftfreq bins 0..6, 2/3 * 6 = 4


def test_one_step_matches_numpy_formula():
    """One step against a numpy transcription of the ETD1 scheme."""
    cfg = tks.Ks1dConfig(N=64)
    u0 = tks.default_ic(cfg).numpy()
    got = tks.ks1d_step(cfg, torch.from_numpy(u0))
    dx = cfg.L / cfg.N
    freqs = np.fft.rfftfreq(cfg.N, d=dx)
    k = 2 * np.pi * freqs
    lin = cfg.a * (-(k**2)) + cfg.b * (k**4)
    e = np.exp(cfg.dt * lin)
    with np.errstate(invalid="ignore"):  # the k = 0 bin, replaced by dt
        coef = np.where(lin == 0.0, cfg.dt, (e - 1.0) / lin)
    nl = (freqs < 2 / 3 * freqs.max()) * np.fft.rfft(cfg.c * u0**2)
    _close(got, np.fft.irfft(e * np.fft.rfft(u0) + coef * (1j * k * nl), n=cfg.N), 1e-13)


def test_trajectory_matches_pdx_and_holds_u0(jks):
    cfg = jks.Ks1dConfig(n_steps=400)
    got = tks.simulate_ks1d(tks.Ks1dConfig(n_steps=400))
    assert got.shape == (401, 200)
    assert torch.equal(got[0], tks.default_ic(tks.Ks1dConfig()))
    _close(got, jks.simulate_ks1d(cfg))
    assert 0.5 < float(got[-1].abs().max()) < 10


def test_batched_initial_conditions_step_together():
    """u0 (B, N): each row's trajectory equals its own run."""
    cfg = tks.Ks1dConfig(n_steps=50)
    u0 = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, size=(3, 200)))
    batch = tks.simulate_ks1d(cfg, u0=u0)
    assert batch.shape == (51, 3, 200)
    for b in range(3):
        _close(batch[:, b], tks.simulate_ks1d(cfg, u0=u0[b]).numpy(), 1e-13)


def test_spatially_shifted_data_is_one_roll_a_frame(jks):
    cfg = tks.Ks1dConfig(n_steps=20)
    got, shifts = tks.spatially_shifted_data(cfg)
    want, jshifts = jks.spatially_shifted_data(jks.Ks1dConfig(n_steps=20))
    np.testing.assert_array_equal(shifts, jshifts)
    assert shifts.min() >= -3 and shifts.max() <= 3
    _close(got, want)
    clean = tks.simulate_ks1d(cfg)
    for i in range(21):
        assert torch.equal(got[i], torch.roll(clean[i], int(shifts[i])))


def test_varying_ic_row_i_is_captured_before_step_i(jks):
    """Frame i is i steps from its own perturbed IC: the batched loop
    captures row i before it steps, matching a re-simulation of each row
    and pdx's batched scan."""
    cfg = tks.Ks1dConfig(N=64, n_steps=5)
    got = tks.varying_ic_data(cfg, seed=42, noise_level=0.02)
    _close(got, jks.varying_ic_data(jks.Ks1dConfig(N=64, n_steps=5), seed=42, noise_level=0.02), 1e-12)
    rng = np.random.default_rng(42)
    base = tks.default_ic(cfg).numpy()
    ics = base[None, :] + 0.02 * rng.normal(0, 1, size=(6, 64))
    for i in range(6):
        u = torch.from_numpy(ics[i])
        for _ in range(i):
            u = tks.ks1d_step(cfg, u)
        _close(got[i], u.numpy(), 1e-13)
    assert torch.equal(got[0], torch.from_numpy(ics[0]))


def test_varying_ic_matches_pdx_at_400_steps(jks):
    _close(tks.varying_ic_data(tks.Ks1dConfig(n_steps=400)), jks.varying_ic_data(jks.Ks1dConfig(n_steps=400)))


@pytest.mark.gpu
def test_trajectories_on_the_card(cuda):
    cfg = tks.Ks1dConfig(n_steps=400)
    _close(tks.simulate_ks1d(cfg, device=cuda).cpu(), tks.simulate_ks1d(cfg).numpy())
    _close(tks.varying_ic_data(cfg, device=cuda).cpu(), tks.varying_ic_data(cfg).numpy())
