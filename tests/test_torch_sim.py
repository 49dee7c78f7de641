"""pdx_torch.sim.ks2d against pdx.sim.ks2d, float64.

Both run the same explicit-Euler operations in the same order; XLA's
reassociation inside the scan is the only source of difference, so the
trajectories agree to a max relative difference of 1e-9 after 200 steps.
The spectral stepper: the same FFT operations in both (pocketfft), 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.sim import ks2d as jks
from pdx_torch.sim import ks2d as tks

RTOL = 1e-9


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_initial_condition_identical():
    cfg = tks.Ks2dConfig(Nx=32, Ny=32)
    np.testing.assert_array_equal(tks.initial_condition(cfg), jks.initial_condition(jks.Ks2dConfig(Nx=32, Ny=32)))


def test_ks_rhs():
    u = np.random.default_rng(0).uniform(-0.1, 0.1, size=(32, 32))
    got = tks.ks_rhs(torch.from_numpy(u), 0.5, 0.5).numpy()
    want = np.asarray(jks.ks_rhs(jnp.asarray(u), 0.5, 0.5))
    assert _max_rel(got, want) <= 1e-12


@pytest.mark.parametrize("save_every", [1, 3])
def test_simulate_matches_pdx(save_every):
    kw = dict(Nx=32, Ny=32, n_seconds=0.2, save_every=save_every)
    U, dx, dy, DT = tks.simulate_ks2d(tks.Ks2dConfig(**kw), dtype=torch.float64)
    JU, jdx, jdy, jDT = jks.simulate_ks2d(jks.Ks2dConfig(**kw), dtype=jnp.float64)
    assert U.shape == JU.shape == (200 // save_every, 32, 32)
    assert (dx, dy, DT) == (jdx, jdy, jDT)
    assert _max_rel(U.numpy(), JU) <= RTOL


def test_frame_convention_first_frame_is_one_step():
    cfg = tks.Ks2dConfig(Nx=16, Ny=16, n_seconds=0.003)
    U, dx, dy, _ = tks.simulate_ks2d(cfg)
    u0 = torch.from_numpy(tks.initial_condition(cfg))
    torch.testing.assert_close(U[0], u0 + cfg.dt * tks.ks_rhs(u0, dx, dy), rtol=0, atol=0)


@pytest.mark.parametrize("save_every", [1, 3])
def test_simulate_spectral_matches_pdx(save_every):
    """Random initial condition (the default draw), dt ten times the Euler
    stepper's; frame j is the state after (j + 1) * save_every steps."""
    kw = dict(Nx=32, Ny=24, n_seconds=0.6, dt=1e-2, save_every=save_every)
    U, dx, dy, DT = tks.simulate_ks2d_spectral(tks.Ks2dConfig(**kw), dtype=torch.float64)
    JU, jdx, jdy, jDT = jks.simulate_ks2d_spectral(jks.Ks2dConfig(**kw), dtype=jnp.float64)
    assert U.shape == JU.shape == (60 // save_every, 32, 24) and U.dtype == torch.float64
    assert (dx, dy, DT) == (jdx, jdy, jDT)
    assert _max_rel(U.numpy(), JU) <= 1e-10


def test_simulate_spectral_float32_and_own_u0():
    """The result is cast to the requested dtype and a given u0 is used
    (held to the port's own float64 run: pdx's stepper does not trace in
    float32 once x64 is enabled); on a smooth field the spectral and the
    Euler stepper agree to 1e-4, as pdx's own test has it."""
    cfg = tks.Ks2dConfig(Nx=32, Ny=32, n_seconds=0.1, dt=1e-3)
    x = np.linspace(0, 50, 32, endpoint=False)
    u0 = 0.1 * np.sin(2 * np.pi * x / 50)[:, None] * np.cos(2 * np.pi * x / 50)[None, :]
    U32, *_ = tks.simulate_ks2d_spectral(cfg, u0=u0, dtype=torch.float32)
    U64, *_ = tks.simulate_ks2d_spectral(cfg, u0=u0, dtype=torch.float64)
    assert U32.dtype == torch.float32 and U32.shape == U64.shape == (100, 32, 32)
    assert _max_rel(U32.numpy(), U64.numpy()) <= 1e-5
    U_e, *_ = tks.simulate_ks2d(cfg, u0=u0)
    assert float((U_e[-1] - U64[-1]).abs().max()) < 1e-4
