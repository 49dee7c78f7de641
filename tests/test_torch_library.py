"""pdx_torch.library (pointwise, dictionaries, blockwise) and
pdx_torch.validate.rollout against their pdx counterparts, float64.

Same numpy inputs and the same operation order in both packages: the
stencil and gather results agree at rtol 1e-12 (XLA reassociation is the
only difference); block means and rollout errors, which are sums, at 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.library import blockwise as jbw
from pdx.library import dictionaries as jdict
from pdx.library import pointwise as jpw
from pdx.validate import rollout as jroll
from pdx_torch.library import blockwise as tbw
from pdx_torch.library import dictionaries as tdict
from pdx_torch.library import pointwise as tpw
from pdx_torch.validate import rollout as troll


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture
def stack():
    return np.random.default_rng(0).uniform(-0.1, 0.1, size=(6, 16, 20))


def test_forward_difference_and_sampling(stack):
    _close(tpw.forward_difference_ut(torch.from_numpy(stack), 1e-3), jpw.forward_difference_ut(jnp.asarray(stack), 1e-3))
    got = tpw.sample_flat_indices(1000, 200, np.random.default_rng(5))
    want = jpw.sample_flat_indices(1000, 200, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)


def test_build_pointwise_dataset(stack):
    terms = np.stack([stack, stack**2, np.sin(stack)])[:, :-1]
    Ut = np.diff(stack, axis=0)
    idx = tpw.sample_flat_indices(Ut.size, 300, np.random.default_rng(1))
    X, y = tpw.build_pointwise_dataset(torch.from_numpy(Ut), torch.from_numpy(terms), idx)
    JX, jy = jpw.build_pointwise_dataset(jnp.asarray(Ut), jnp.asarray(terms), idx)
    assert X.shape == (300, 3)
    _close(X, JX)
    _close(y, jy)


@pytest.mark.parametrize("advection", [False, True])
def test_dictionary_true(stack, advection):
    names, terms = tdict.build_dictionary_true(torch.from_numpy(stack), 0.5, 0.25, include_advection=advection)
    jnames, jterms = jdict.build_dictionary_true(jnp.asarray(stack), 0.5, 0.25, include_advection=advection)
    assert names == jnames
    _close(terms, jterms)


@pytest.mark.parametrize("drop", [False, True])
def test_dictionary_rich(stack, drop):
    names, terms = tdict.build_dictionary_rich(torch.from_numpy(stack), 0.5, 0.25, drop_advection=drop)
    jnames, jterms = jdict.build_dictionary_rich(jnp.asarray(stack), 0.5, 0.25, drop_advection=drop)
    assert names == jnames
    _close(terms, jterms)


def test_dictionary_names_and_spectral_deferred(stack):
    """Display names match pdx; spectral derivatives now run (their parity
    is in test_torch_spectral.py) and an unknown kind still raises."""
    assert tdict.TERM_DISPLAY == jdict.TERM_DISPLAY
    assert tdict.KS_GROUND_TRUTH == jdict.KS_GROUND_TRUTH
    assert tdict.display_names(["lap", "bih", "zz"]) == jdict.display_names(["lap", "bih", "zz"])
    names, terms = tdict.build_dictionary_true(torch.from_numpy(stack), 0.5, 0.5, deriv="spectral")
    assert names == ["lap", "bih", "gradsq"] and terms.shape == (3,) + stack.shape
    with pytest.raises(ValueError, match="deriv"):
        tdict.build_dictionary_true(torch.from_numpy(stack), 0.5, 0.5, deriv="wavelet")


@pytest.mark.parametrize("shape,blocks", [
    ((9, 32, 24), (3, 8, 8)),
    ((8, 30, 126), (3, 8, 8)),  # ragged on every axis
    ((5, 7, 9), (2, 3, 4)),
])
def test_blockwise_dataset(shape, blocks):
    rng = np.random.default_rng(2)
    Ut = rng.normal(size=shape)
    terms = rng.normal(size=(3,) + shape)
    bt, bx, by = blocks
    X, y = tbw.build_blockwise_dataset(torch.from_numpy(Ut), torch.from_numpy(terms), block_t=bt, block_x=bx, block_y=by)
    JX, jy = jbw.build_blockwise_dataset(jnp.asarray(Ut), jnp.asarray(terms), block_t=bt, block_x=bx, block_y=by)
    _close(X, JX, 1e-10)
    _close(y, jy, 1e-10)
    with pytest.raises(ValueError, match="positive"):
        tbw.build_blockwise_dataset(torch.from_numpy(Ut), torch.from_numpy(terms), block_t=0, block_x=bx, block_y=by)


@pytest.mark.parametrize("names,coeffs", [
    (["lap", "bih", "gradsq"], [-1.0, -1.0, -0.5]),
    (["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"], [1e-4, -0.01, 0.02, 0.01, -0.01, -1.0, -1.0, -0.5, 0.1]),
])
def test_rollout_curve_named(names, coeffs):
    from pdx_torch.sim.ks2d import Ks2dConfig, simulate_ks2d

    U, dx, dy, DT = simulate_ks2d(Ks2dConfig(Nx=16, Ny=16, n_seconds=0.03))
    coeffs = np.asarray(coeffs) * (1 + 1e-3)  # off the truth, so the errors are O(1e-6)
    got = troll.rollout_rmse_curve_named(U, coeffs, names, 20, DT, dx, dy)
    want = jroll.rollout_rmse_curve_named(jnp.asarray(U.numpy()), coeffs, names, 20, DT, dx, dy)
    assert got.shape == (20,)
    _close(got, want, 1e-10)
