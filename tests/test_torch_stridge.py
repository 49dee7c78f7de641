"""pdx_torch.solve.stridge against pdx.solve.stridge and the numpy oracle.

Inputs are test_solvers.py's sparse problems (the oracle's golden inputs);
coefficients agree at rtol 1e-10 (float64, same fixed-iteration algorithm,
LAPACK LU in both), masks exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from pdx.ops.linalg import gram_stats as jgram
from pdx_torch.ops.linalg import gram_stats as tgram
from pdx_torch.solve import stridge as tst

jst = importlib.import_module("pdx.solve.stridge")  # pdx.solve re-exports a function named stridge

RTOL, ATOL = 1e-10, 1e-12


def make_problem(n=2000, p=8, noise=0.01, sparsity=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=p)
    true = np.zeros(p)
    idx = rng.choice(p, size=sparsity, replace=False)
    true[idx] = rng.normal(size=sparsity) * 2.0
    y = X @ true + noise * rng.normal(size=n)
    return X, y, true


def _both_stats(X, y):
    return tgram(torch.from_numpy(X), torch.from_numpy(y)), jgram(jnp.asarray(X), jnp.asarray(y))


@pytest.mark.parametrize("alpha,threshold", [(1e-3, 1e-6), (1e-6, 0.05), (1e-2, 0.5), (1.0, 10.0)])
def test_stridge_from_stats_matches_pdx_and_oracle(alpha, threshold):
    X, y, _ = make_problem()
    ts, js = _both_stats(X, y)
    got = tst.stridge_from_stats(ts, alpha=alpha, threshold=threshold)
    want = jst.stridge_from_stats(js, alpha=alpha, threshold=threshold)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.n_active) == int(want.n_active)
    np.testing.assert_allclose(
        got.coeffs.numpy(), oracle.stridge(X, y, alpha=alpha, threshold=threshold), rtol=1e-8, atol=1e-10
    )


def test_stridge_grid_matches_pdx():
    X, y, _ = make_problem(seed=1)
    ts, js = _both_stats(X, y)
    alphas = np.array([1e-6, 1e-4, 1e-2, 1.0])
    thresholds = np.array([1e-8, 1e-3, 0.1, 0.5, 10.0])
    got_c, got_m = tst.stridge_grid(ts, torch.from_numpy(alphas), torch.from_numpy(thresholds))
    want_c, want_m = jst.stridge_grid(js, jnp.asarray(alphas), jnp.asarray(thresholds))
    assert got_c.shape == (4, 5, 8)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_stridge_init_mask_and_all_small():
    X, y, _ = make_problem(seed=2)
    ts, js = _both_stats(X, y)
    init = np.array([1, 1, 0, 1, 0, 1, 1, 1], float)
    got = tst.stridge_from_stats(ts, alpha=1e-4, threshold=1e-3, init_mask=torch.from_numpy(init))
    want = jst.stridge_from_stats(js, alpha=1e-4, threshold=1e-3, init_mask=jnp.asarray(init))
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), rtol=RTOL, atol=ATOL)
    zero = tst.stridge(torch.from_numpy(X), torch.from_numpy(y), alpha=1e-3, threshold=1e9)
    np.testing.assert_array_equal(zero.numpy(), np.zeros(8))


def test_recovers_sparse_truth():
    X, y, true = make_problem(noise=1e-6, seed=3)
    got = tst.stridge(torch.from_numpy(X), torch.from_numpy(y), alpha=1e-8, threshold=1e-3)
    np.testing.assert_allclose(got.numpy(), true, atol=1e-4)
