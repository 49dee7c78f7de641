"""pdx_torch.solve.robust against pdx.solve.robust, float64.

The same numpy rows (a sparse problem with a few gross outliers, from a
seed) go through both packages; bootstrap index sets are host numpy draws
with the same seeds, so the members fit the same rows. Every variant is a
fixed sequence of small solves, so coefficients agree at 1e-10 of
max|coef| (RTOL below); where a test is looser it says why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.solve import robust as jr
from pdx_torch.solve import robust as tr

RTOL = 1e-10


def make_problem(n=300, p=4, seed=0, outliers=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=p)
    true = np.array([1.5, 0.0, -2.0, 0.0])[:p]
    y = X @ true + 0.01 * rng.normal(size=n)
    y[rng.choice(n, size=outliers, replace=False)] += rng.normal(size=outliers) * 5.0
    return X, y


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def test_huber_weight_and_bootstrap_indices():
    r = np.random.default_rng(1).normal(size=200) * 3
    _close(tr.huber_weight(_t(r), 1.35), jr.huber_weight(jnp.asarray(r), 1.35), rtol=1e-15)
    for seed in (0, 42):
        np.testing.assert_array_equal(tr.bootstrap_indices(50, 40, 6, seed), jr.bootstrap_indices(50, 40, 6, seed))


@pytest.mark.parametrize("n", [7, 8])
def test_median_averages_the_middle_pair(n):
    """Odd and even counts, along either axis, as numpy (and jnp) do it."""
    x = np.random.default_rng(n).normal(size=(n, 5))
    for dim in (0, 1):
        np.testing.assert_allclose(tr.median(_t(x), dim=dim).numpy(), np.median(x, axis=dim), rtol=1e-15)
    if n % 2 == 0:
        assert not np.allclose(torch.median(_t(x), dim=0).values.numpy(), np.median(x, axis=0))


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0, 1.0]])
def test_irls_huber_matches_pdx(mask):
    X, y = make_problem()
    tm = None if mask is None else _t(np.array(mask))
    jm = None if mask is None else jnp.asarray(mask)
    got = tr.irls_huber(_t(X), _t(y), alpha=1e-3, col_mask=tm)
    want = jr.irls_huber(jnp.asarray(X), jnp.asarray(y), alpha=1e-3, col_mask=jm)
    _close(got, want)


def test_irls_huber_returns_previous_iterate_on_convergence():
    """The reference's quirk: the step that detects convergence is thrown
    away. With a tolerance that the first step already meets, the result is
    the plain ridge start, not the first reweighted fit; with the default
    tolerance the loop converges well before max_iter and more iterations
    change nothing."""
    X, y = make_problem(seed=2)
    Xt, yt = _t(X), _t(y)
    ones = torch.ones(4, dtype=torch.float64)
    start = tr._masked_weighted_ridge(Xt, yt, torch.ones_like(yt), ones, 1e-3)
    got = tr.irls_huber(Xt, yt, alpha=1e-3, tol=1e3)
    assert torch.equal(got, start)
    _close(got, jr.irls_huber(jnp.asarray(X), jnp.asarray(y), alpha=1e-3, tol=1e3))
    assert torch.equal(tr.irls_huber(Xt, yt, alpha=1e-3, max_iter=50), tr.irls_huber(Xt, yt, alpha=1e-3, max_iter=500))
    assert not torch.equal(tr.irls_huber(Xt, yt, alpha=1e-3, max_iter=50), tr.irls_huber(Xt, yt, alpha=1e-3, max_iter=2))


def test_irls_huber_batch_members_stop_on_their_own():
    """A batch of three problems that converge after different numbers of
    steps (one has no outliers, one is capped by max_iter): each member
    equals its own unbatched fit (to the round-off between a batched and a
    plain matrix product), and pdx's vmapped loop."""
    probs = [make_problem(seed=3, outliers=0), make_problem(seed=4, outliers=12), make_problem(seed=5, outliers=90)]
    X = np.stack([q[0] for q in probs])
    y = np.stack([q[1] for q in probs])
    got = tr.irls_huber(_t(X), _t(y), alpha=1e-3, max_iter=6)
    for i in range(3):
        alone = tr.irls_huber(_t(X[i]), _t(y[i]), alpha=1e-3, max_iter=6)
        np.testing.assert_allclose(got[i].numpy(), alone.numpy(), rtol=0, atol=1e-13 * float(alone.abs().max()))
    want = jax.vmap(lambda a, b: jr.irls_huber(a, b, alpha=1e-3, max_iter=6))(jnp.asarray(X), jnp.asarray(y))
    _close(got, want)


@pytest.mark.parametrize("threshold", [1e-6, 0.3])
def test_stridge_huber_matches_pdx(threshold):
    X, y = make_problem(seed=6)
    kw = dict(alpha=1e-3, threshold=threshold, huber_delta=1.35)
    _close(tr.stridge_huber(_t(X), _t(y), **kw), jr.stridge_huber(jnp.asarray(X), jnp.asarray(y), **kw))


@pytest.mark.parametrize("trim_frac", [0.0, 0.001, 0.1])
def test_trimmed_stridge_matches_pdx(trim_frac):
    """trim_frac 0 and 0.001 give n_trim == 0 (every row kept)."""
    X, y = make_problem(seed=7)
    kw = dict(alpha=1e-3, threshold=0.3, trim_frac=trim_frac)
    got = tr.trimmed_stridge(_t(X), _t(y), **kw)
    _close(got, jr.trimmed_stridge(jnp.asarray(X), jnp.asarray(y), **kw))
    assert int((got != 0).sum()) == 2


@pytest.mark.parametrize("signs", [None, [1, 1, 1, -1], [-1, 0, -1, 0]])
def test_stridge_sign_constrained_matches_pdx(signs):
    X, y = make_problem(seed=8, outliers=0)
    kw = dict(alpha=1e-3, threshold=1e-4, signs=signs)
    got = tr.stridge_sign_constrained(_t(X), _t(y), **kw)
    _close(got, jr.stridge_sign_constrained(jnp.asarray(X), jnp.asarray(y), **kw))
    if signs == [1, 1, 1, -1]:
        assert got[2] == 0  # the true coefficient there is -2: the constraint removes it


@pytest.mark.parametrize("use_huber,n_bootstrap", [(False, 6), (True, 6), (True, 5)])
def test_ensemble_stridge_matches_pdx(use_huber, n_bootstrap):
    """Members are restandardized one by one; the median over an even member
    count averages the middle pair."""
    X, y = make_problem(seed=9)
    kw = dict(alpha=1e-3, threshold=0.3, n_bootstrap=n_bootstrap, use_huber=use_huber)
    got_c, got_s = tr.ensemble_stridge(_t(X), _t(y), **kw)
    want_c, want_s = jr.ensemble_stridge(jnp.asarray(X), jnp.asarray(y), **kw)
    _close(got_c, want_c)
    _close(got_s, want_s, rtol=1e-8)  # a std of values that agree to ~1e-13: cancellation


@pytest.mark.parametrize("kw", [
    dict(),
    dict(signs=[1, 0, -1, 0]),
    dict(use_huber=False, n_bootstrap=7),
    dict(trim_frac=0.0, n_bootstrap=4),
], ids=["default", "signs", "ridge_members_odd", "no_trim"])
def test_robust_stridge_matches_pdx(kw):
    """One global standardization, members not restandardized, signs applied
    once after each member's loop."""
    X, y = make_problem(seed=10)
    kw = dict(dict(alpha=1e-3, threshold=0.3, n_bootstrap=6), **kw)
    got, ginfo = tr.robust_stridge(_t(X), _t(y), **kw)
    want, winfo = jr.robust_stridge(jnp.asarray(X), jnp.asarray(y), **kw)
    _close(got, want)
    assert set(ginfo) == set(winfo)
    assert (ginfo["n_trimmed"], ginfo["n_bootstrap"]) == (winfo["n_trimmed"], winfo["n_bootstrap"])
    scale = float(np.abs(np.asarray(want)).max())
    for k in ("std", "ci_95_low", "ci_95_high"):
        np.testing.assert_allclose(ginfo[k].numpy(), np.asarray(winfo[k]), rtol=0, atol=1e-8 * scale, err_msg=k)
