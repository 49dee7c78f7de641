"""pdx_torch.sim.ks2d against pdx.sim.ks2d, float64.

Both run the same explicit-Euler operations in the same order; XLA's
reassociation inside the scan is the only source of difference, so the
trajectories agree to a max relative difference of 1e-9 after 200 steps.
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
