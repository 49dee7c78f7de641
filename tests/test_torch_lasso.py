"""pdx_torch.solve.lasso against pdx.solve.lasso, float64.

pdx runs FISTA in a while_loop per alpha; the port carries the alphas as
one batch, freezes each at the iteration where its own loop stops, and
looks at the host only every ``CHECK_EVERY`` iterations. Tolerance: 1e-9 of
max|coef| and of |intercept| (the same iteration in another summation
order; measured <= 3e-11 on these problems, the largest where an alpha
runs to max_iter unconverged).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.solve import lasso as jl
from pdx_torch.solve import lasso as tl

ALPHAS = np.array([0.001, 0.01, 0.1])


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 8))
    X[:, 3] = X[:, 2] + 0.01 * rng.normal(size=500)  # nearly collinear: slow convergence at small alpha
    y = X @ np.array([1.0, 0.0, 2.0, 0.0, 0.0, -1.0, 0.0, 0.5]) + 0.1 * rng.normal(size=500) + 3.0
    mask = (rng.random(500) > 0.2).astype(float)
    return X, y, mask


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_alpha_batch_matches_pdx(problem, fit_intercept, masked):
    X, y, mask = problem
    rm = mask if masked else None
    coef, intercept, n_iter, _ = tl.lasso_fista(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(ALPHAS), max_iter=5000,
        fit_intercept=fit_intercept, row_mask=None if rm is None else torch.from_numpy(rm),
    )
    assert coef.shape == (3, 8) and intercept.shape == (3,) and n_iter.shape == (3,)
    assert len(set(n_iter.tolist())) >= 2  # the alphas stop at iterations of their own
    for i, a in enumerate(ALPHAS):
        wj, bj = jl.lasso_ista(jnp.asarray(X), jnp.asarray(y), a, max_iter=5000, fit_intercept=fit_intercept,
                               row_mask=None if rm is None else jnp.asarray(rm))
        wj = np.asarray(wj)
        np.testing.assert_allclose(coef[i].numpy(), wj, rtol=0, atol=1e-9 * np.abs(wj).max())
        np.testing.assert_allclose(float(intercept[i]), float(bj), rtol=0, atol=1e-9 * max(abs(float(bj)), 1.0))


def test_scalar_alpha_check_interval_and_max_iter(problem, monkeypatch):
    """A float alpha gives pdx's (p,) shapes; the host-check interval does
    not change the result, only the host syncs counted; an alpha cut at
    max_iter reports max_iter."""
    X, y, _ = problem
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    coef, intercept = tl.lasso_ista(Xt, yt, 0.01, max_iter=3000)
    assert coef.shape == (8,) and intercept.shape == ()
    wj, bj = jl.lasso_ista(jnp.asarray(X), jnp.asarray(y), 0.01, max_iter=3000)
    np.testing.assert_allclose(coef.numpy(), np.asarray(wj), rtol=0, atol=1e-9 * np.abs(np.asarray(wj)).max())
    every, syncs = [], []
    for c in (1, 7, 50):
        monkeypatch.setattr(tl, "CHECK_EVERY", c)
        *res, n = tl.lasso_fista(Xt, yt, torch.from_numpy(ALPHAS), max_iter=300)
        every.append(res)
        syncs.append(n)
    for other in every[1:]:
        for a, b in zip(every[0], other):
            assert torch.equal(a, b)
    assert int(every[0][2].max()) == 300
    # the step size's read, then checks after 1, 2, 4, ... up to CHECK_EVERY and every CHECK_EVERY to 300
    assert syncs == [1 + 300, 1 + 3 + 300 // 7, 1 + 6 + 300 // 50]


def test_lstsq_solve(problem):
    X, y, _ = problem
    got = tl.lstsq_solve(torch.from_numpy(X), torch.from_numpy(y))
    want = np.asarray(jl.lstsq_solve(jnp.asarray(X), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    # against numpy's SVD solve: the tiny ridge and the near-collinear pair move it ~2e-8
    np.testing.assert_allclose(got.numpy(), np.linalg.lstsq(X, y, rcond=None)[0], rtol=1e-6)
