"""pdx_torch.validate.rollout (the real-image rollouts of analyze) against
pdx.validate.rollout, float64, on one smooth (10, 12, 14) stack.

Tolerance: 1e-10 relative. The port accumulates the right-hand side in
pdx's term order and steps the same Euler recursion; only the summation
order of the metric reductions differs (measured ~1e-14). NaN rows (horizons
with no valid start) must be NaN in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.library.dictionaries import FOURTH_ORDER_TERMS
from pdx.validate import rollout as jroll
from pdx_torch.validate import rollout as troll

RTOL = 1e-10
DT, DX, DY = 1.0, 0.1, 0.1
C13 = np.array([0.01, -0.02, 1e-3, -1e-3, 1e-4, 2e-4, 3e-4, 0.01, 1e-3, -1e-3, -0.01, 1e-5, 2e-5])


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=rtol * np.abs(want[ok]).max(initial=0.0))


@pytest.fixture(scope="module")
def u():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    base = gaussian_filter(rng.normal(size=(12, 14)), 2.0, mode="wrap")
    frames = [np.roll(base, (t // 3, t // 2), axis=(0, 1)) * (1 + 0.02 * t) for t in range(10)]
    return np.stack(frames) / np.abs(base).max()


@pytest.fixture(scope="module")
def coeffs13():
    rng = np.random.default_rng(1)
    return np.stack([C13, C13 * rng.uniform(0.5, 1.5, 13), C13 * (np.arange(13) % 2)])


@pytest.fixture(scope="module")
def masks(u):
    m = np.zeros((2,) + u.shape[1:])
    m[0, :, 9:] = 1.0  # right columns
    m[1, 8:, :] = 1.0  # bottom rows
    return m


@pytest.mark.parametrize("t0,t1,k_max", [(0, 10, 4), (2, 7, 6)])
def test_rollout_curve_bundle_real13(u, coeffs13, masks, t0, t1, k_max):
    """Three models, two masks; (2, 7, 6) leaves horizons 5 and 6 without a
    valid start: NaN rows in both."""
    got = troll.rollout_curve_bundle(torch.from_numpy(u), torch.from_numpy(coeffs13), DT, DX, DY,
                                     torch.from_numpy(masks), k_max=k_max, t0=t0, t1=t1)
    want = jroll.rollout_curve_bundle(jnp.asarray(u), jnp.asarray(coeffs13), DT, DX, DY, jnp.asarray(masks),
                                      k_max=k_max, t0=t0, t1=t1)
    assert got[0].shape == (3, k_max, 3)
    for g, w in zip(got, want):
        _close(g, w)
    if t1 - t0 - 1 < k_max:
        assert np.isnan(got[0][:, t1 - t0 - 1 :].numpy()).all()


def test_rollout_curve_bundle_fourth25(u, masks):
    """Model 7's 25-term library, no mask and one mask."""
    c = np.zeros((1, 25))
    c[0, :6] = [0.01, -0.02, 1e-3, -1e-3, 1e-4, 2e-4]
    c[0, 20:23] = [-1e-8, -2e-8, -1e-8]
    for m in (masks[:0], masks[:1]):
        got = troll.rollout_curve_bundle(torch.from_numpy(u), torch.from_numpy(c), DT, DX, DY, torch.from_numpy(m),
                                         k_max=3, t0=1, t1=9, term_set="fourth25")
        want = jroll.rollout_curve_bundle(jnp.asarray(u), jnp.asarray(c), DT, DX, DY, jnp.asarray(m),
                                          k_max=3, t0=1, t1=9, term_set="fourth25")
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("t_start,t0,t1,k_max", [(3, 6, 10, 5), (0, 0, 10, 3)])
def test_fig4_rollout_bundle(u, coeffs13, t_start, t0, t1, k_max):
    """(6, 10, 5): horizons 4 and 5 have no valid start and take the first
    start alone (pdx's ``roll[k - 1, :1]``)."""
    got = troll.fig4_rollout_bundle(torch.from_numpy(u), torch.from_numpy(coeffs13[:2]), DT, DX, DY,
                                    k_max=k_max, t_start=t_start, t0=t0, t1=t1)
    want = jroll.fig4_rollout_bundle(jnp.asarray(u), jnp.asarray(coeffs13[:2]), DT, DX, DY,
                                     k_max=k_max, t_start=t_start, t0=t0, t1=t1)
    assert got[0].shape == (2, k_max) + u.shape[1:] and got[1].shape == (2, k_max)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("kind", ["reflect", "fourth", "periodic"])
@pytest.mark.parametrize("k,masked", [(1, False), (3, True), (9, False)])
def test_rollout_k_rmse(u, kind, k, masked):
    """Closure right-hand sides, masked and not; k = 9 leaves no start: NaN."""
    if kind == "reflect":
        names, c = ["one", "u", "lap", "u_ux"], [0.01, -0.02, 3e-4, 1e-3]
    elif kind == "fourth":
        names, c = ["u", "lap", "bih", "u_uxxxx"], [-0.02, 3e-4, -1e-8, 1e-9]
    else:
        names, c = ["u", "lap", "bih", "gradsq"], [-0.02, 3e-4, -1e-8, 1e-4]
    make_t = {"reflect": troll.make_rhs_reflect, "fourth": troll.make_rhs_fourth_order, "periodic": troll.make_rhs_periodic}
    make_j = {"reflect": jroll.make_rhs_reflect, "fourth": jroll.make_rhs_fourth_order, "periodic": jroll.make_rhs_periodic}
    mask = np.zeros(u.shape[1:], bool)
    mask[2:9, 3:] = True
    sm_t, sm_j = (torch.from_numpy(mask), jnp.asarray(mask)) if masked else (None, None)
    got = troll.rollout_k_rmse(torch.from_numpy(u), make_t[kind](names, c, DX, DY), k, 0, 10, DT, sm_t)
    want = jroll.rollout_k_rmse(jnp.asarray(u), make_j[kind](names, c, DX, DY), k, 0, 10, DT, sm_j)
    for key in ("rmse", "nrmse"):
        _close(got[key], want[key])
    curve_t = troll.rollout_curve(torch.from_numpy(u), make_t[kind](names, c, DX, DY), [1, k], 1, 9, DT, sm_t)
    curve_j = jroll.rollout_curve(jnp.asarray(u), make_j[kind](names, c, DX, DY), [1, k], 1, 9, DT, sm_j)
    for kk in curve_j:
        _close(torch.stack([curve_t[kk]["rmse"], curve_t[kk]["nrmse"]]), [curve_j[kk]["rmse"], curve_j[kk]["nrmse"]])


@pytest.mark.parametrize("names", [["one", "u", "ux", "lap"], ["u", "lap", "u_lap", "bih"]])
def test_rollout_k_rmse_dense(u, masks, names):
    """Dense coefficients as data: real13 or fourth25 by the names; the
    batch form over models, masked."""
    c = np.array([0.01, -0.02, 1e-3, 3e-4])
    if "bih" in names:
        c = np.array([-0.02, 3e-4, 1e-3, -1e-8])
    got = troll.rollout_k_rmse_dense(torch.from_numpy(u), names, c, 2, 0, 10, DT, DX, DY)
    want = jroll.rollout_k_rmse_dense(jnp.asarray(u), names, jnp.asarray(c), 2, 0, 10, DT, DX, DY)
    _close(torch.stack([got["rmse"], got["nrmse"]]), [want["rmse"], want["nrmse"]])
    superset = list(jroll.ANALYZE13) if set(names) <= set(jroll.ANALYZE13) else FOURTH_ORDER_TERMS
    dense = np.stack([troll.dense_coeffs(names, c, superset), 2 * troll.dense_coeffs(names, c, superset)])
    np.testing.assert_array_equal(dense[0], jroll.dense_coeffs(names, c, superset))
    term_set = "real13" if superset is not FOURTH_ORDER_TERMS else "fourth25"
    got_b = troll.rollout_k_rmse_dense_batch(torch.from_numpy(u), dense, 3, 1, 10, DT, DX, DY,
                                             torch.from_numpy(masks[0]), term_set)
    want_b = jroll.rollout_k_rmse_dense_batch(jnp.asarray(u), jnp.asarray(dense), 3, 1, 10, DT, DX, DY,
                                              jnp.asarray(masks[0]), term_set)
    for g, w in zip(got_b, want_b):
        _close(g, w)
    nan_b = troll.rollout_k_rmse_dense_batch(torch.from_numpy(u), dense, 9, 1, 10, DT, DX, DY)
    assert np.isnan(nan_b[0]).all() and nan_b[0].shape == (2,)


@pytest.mark.parametrize("masked", [False, True])
def test_one_step_prediction_rmse(u, masked):
    ut = np.random.default_rng(3).normal(size=(8,) + u.shape[1:]) * 0.01
    mask = np.zeros(u.shape[1:], bool)
    mask[:, :7] = True
    got = troll.one_step_prediction_rmse(torch.from_numpy(u), torch.from_numpy(ut), 0.5,
                                         torch.from_numpy(mask) if masked else None)
    want = jroll.one_step_prediction_rmse(jnp.asarray(u), jnp.asarray(ut), 0.5, jnp.asarray(mask) if masked else None)
    _close(got, want)


def test_rollout_predict_and_trajectories(u):
    rhs_t = troll.make_rhs_reflect(["u", "lap"], [-0.02, 3e-4], DX, DY)
    rhs_j = jroll.make_rhs_reflect(["u", "lap"], [-0.02, 3e-4], DX, DY)
    _close(troll.rollout_predict(rhs_t, torch.from_numpy(u[0]), 4, DT), jroll.rollout_predict(rhs_j, jnp.asarray(u[0]), 4, DT))
    got = troll.rollout_trajectories(rhs_t, torch.from_numpy(u[:3]), 4, DT)
    assert got.shape == (4, 3) + u.shape[1:]
    _close(got, jroll.rollout_trajectories(rhs_j, jnp.asarray(u[:3]), 4, DT))
