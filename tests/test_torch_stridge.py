"""pdx_torch.solve.stridge against pdx.solve.stridge and the numpy oracle.

Inputs are test_solvers.py's sparse problems (the oracle's golden inputs);
coefficients agree at rtol 1e-10 (float64, same fixed-iteration algorithm,
LAPACK LU in both), masks exactly. The QR variant: 1e-9 of max|coef| in
float64 (Householder QR in both; Q's signs differ, the solution does not)
and 1e-3 of max|coef| in float32 against pdx in float32.
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


def make_illconditioned(n=3000, seed=4):
    """Columns with near-collinear pairs and scales decades apart, like the
    rich KS library's: cond of the standardized Gram ~1e4."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 6))
    X = np.column_stack([
        z[:, 0], z[:, 0] + 3e-2 * z[:, 1], 50.0 * z[:, 2], z[:, 3], 1e-2 * (z[:, 3] + 3e-2 * z[:, 4]), z[:, 5] ** 2,
    ])
    y = X @ np.array([1.0, 0.0, -0.02, 0.5, 0.0, -1.0]) + 1e-4 * rng.normal(size=n)
    return X, y


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-3)])
@pytest.mark.parametrize("alpha,threshold", [(1e-6, 1e-8), (1e-3, 0.05), (1e-2, 1e4)])
def test_stridge_qr_matches_pdx(dtype, tol, alpha, threshold):
    X, y = make_illconditioned()
    X, y = X.astype(dtype), y.astype(dtype)
    got = tst.stridge_qr(torch.from_numpy(X), torch.from_numpy(y), alpha=alpha, threshold=threshold)
    want = np.asarray(jst.stridge_qr(jnp.asarray(X), jnp.asarray(y), alpha=alpha, threshold=threshold))
    assert got.dtype == getattr(torch, dtype) and want.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)


def test_masked_ridge_qr_equals_gram_solve():
    """Same minimizer as the normal equations on the active support, for a
    batch of masks and alphas in one QR."""
    X, y, _ = make_problem(seed=5)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    rng = np.random.default_rng(6)
    masks = torch.from_numpy((rng.uniform(size=(2, 3, 8)) > 0.4).astype(float))
    alphas = torch.tensor([[1e-6, 1e-3, 1e-1], [1e-4, 1e-2, 1.0]], dtype=torch.float64)
    got = tst._masked_ridge_qr(Xt, yt, masks, alphas)
    want = tst.masked_ridge_solve(Xt.T @ Xt, Xt.T @ yt, masks, alphas)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9, atol=1e-12)
    for i, j in [(0, 0), (1, 2)]:
        one = jst._masked_ridge_qr(jnp.asarray(X), jnp.asarray(y), jnp.asarray(masks[i, j].numpy()), float(alphas[i, j]))
        np.testing.assert_allclose(got[i, j].numpy(), np.asarray(one), rtol=1e-9, atol=1e-12)


def test_stridge_qr_grid_matches_pdx():
    """The (A, T) grid as one batched QR per iteration against pdx's vmapped
    grid with its test metrics."""
    X, y = make_illconditioned(n=1500, seed=7)
    X_te, y_te = make_illconditioned(n=400, seed=8)
    alphas, thresholds = np.array([1e-6, 1e-3, 1e-1]), np.array([1e-8, 0.05, 0.5, 1e4])
    scale = np.ones(6)
    want = jst._grid_solve_qr(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(X_te), jnp.asarray(y_te), jnp.asarray(scale),
        jnp.asarray(alphas), jnp.asarray(thresholds), 25,
    )
    got = tst.stridge_qr_grid(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(alphas), torch.from_numpy(thresholds))
    assert got.shape == (3, 4, 6)
    w = np.asarray(want[0])
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-9 * np.abs(w).max())
    np.testing.assert_array_equal((got != 0).sum(-1).numpy(), np.asarray(want[3]))
    for i in range(3):
        for j in range(4):
            one = tst.stridge_qr(torch.from_numpy(X), torch.from_numpy(y), alpha=alphas[i], threshold=thresholds[j])
            np.testing.assert_allclose(got[i, j].numpy(), one.numpy(), rtol=0, atol=1e-12 * np.abs(w).max())


def test_threshold_loop_stops_at_the_fixed_point():
    """The loop ends once no mask changed; running on would repeat the same
    solve, so max_iter beyond that point changes nothing, bit for bit."""
    X, y, _ = make_problem(seed=9)
    ts, _ = _both_stats(X, y)
    calls = []
    Gs, bs, _mean, _scale = tst.standardized_stats(ts)

    def solve_fn(m):
        calls.append(m.clone())
        return tst.masked_ridge_solve(Gs, bs, m, 1e-3)

    m0 = torch.ones_like(bs)
    c, m = tst.threshold_loop(solve_fn, solve_fn(m0), m0, 0.05, 25)
    assert 2 <= len(calls) < 8
    assert torch.equal(c, tst.masked_ridge_solve(Gs, bs, m, 1e-3))
    for k in (len(calls), 25, 100):
        again = tst.stridge_from_stats(ts, alpha=1e-3, threshold=0.05, max_iter=k)
        assert torch.equal(again.mask, m) and torch.equal(again.coeffs, c / (_scale + 1e-12))


@pytest.mark.parametrize("threshold", [1e-5, 0.3])
def test_batched_init_masks_match_pdx_vmap(threshold):
    """analyze's six model masks over one 13-column Gram, as one (6, 13)
    batch of initial masks with a scalar threshold, against pdx's
    jax.vmap over the masks: within 1e-10 of max|coef|, masks equal."""
    import jax

    from pdx_torch.pipelines.analyze import MODELS
    from pdx_torch.validate.rollout import ANALYZE13

    X, y, _ = make_problem(p=13, sparsity=6, seed=7)
    masks = np.array([[1.0 if n in names else 0.0 for n in ANALYZE13] for names in MODELS.values()])
    ts, js = _both_stats(X, y)
    got = tst.stridge_from_stats(ts, alpha=0.01, threshold=threshold, max_iter=20, init_mask=torch.from_numpy(masks))

    def one(m):
        r = jst.stridge_from_stats(js, alpha=0.01, threshold=threshold, max_iter=20, init_mask=m)
        return r.coeffs, r.mask

    want_c, want_m = jax.vmap(one)(jnp.asarray(masks))
    assert got.coeffs.shape == (6, 13)
    want_c = np.asarray(want_c)
    np.testing.assert_allclose(got.coeffs.numpy(), want_c, rtol=0, atol=1e-10 * np.abs(want_c).max())
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want_m))
    assert np.all(got.coeffs.numpy()[masks == 0] == 0)
