"""pdx_torch.preprocess (the comprehensive benchmark's preprocessor bank)
against pdx.preprocess, float64.

The same numpy stacks go through both packages. Every preprocessor keeps
``pdx``'s operation order; only the order of XLA's and PyTorch's sums
(Gaussian taps, means, standard deviations, cumulative sums) separates them,
so each result is held within 1e-12 of max|result| of ``pdx``'s. The TV
iteration is held over its first steps only (``tests/test_torch_filters.py``:
over 50 steps it amplifies round-off, fault F8), and here through the bank
at ``n_iter=2``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdx.preprocess as jpre
import pdx_torch.preprocess as tpre

TOL = 1e-12


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture
def stack():
    return np.random.default_rng(0).normal(size=(9, 14, 17)) + 3.0


def test_bank_names():
    assert list(tpre.PREPROCESSORS) == list(jpre.PREPROCESSORS)


@pytest.mark.parametrize("name", [n for n in jpre.PREPROCESSORS if n != "tv"])
def test_bank_matches_pdx(stack, name):
    got = tpre.PREPROCESSORS[name](torch.from_numpy(stack))
    assert got.shape == stack.shape and got.dtype == torch.float64
    _close(got, jpre.PREPROCESSORS[name](jnp.asarray(stack)))


def test_tv_first_steps_match_pdx(stack):
    _close(tpre.preprocess_tv(torch.from_numpy(stack), 0.1, 2), jpre.preprocess_tv(jnp.asarray(stack), 0.1, 2))


@pytest.mark.parametrize("kw", [
    dict(sigma=0.7), dict(sigma=2.5),
])
def test_gaussian_sigma(stack, kw):
    _close(tpre.preprocess_gaussian(torch.from_numpy(stack), **kw), jpre.preprocess_gaussian(jnp.asarray(stack), **kw))


@pytest.mark.parametrize("size", [3, 5])
def test_median_size(stack, size):
    np.testing.assert_array_equal(tpre.preprocess_median(torch.from_numpy(stack), size).numpy(),
                                  np.asarray(jpre.preprocess_median(jnp.asarray(stack), size)))


def test_bilateral_matches_reference_formula(stack):
    from scipy.ndimage import gaussian_filter

    got = tpre.preprocess_bilateral(torch.from_numpy(stack), sigma_s=2.0, sigma_r=0.3).numpy()
    sm = np.stack([gaussian_filter(f, 2.0) for f in stack])
    w = np.exp(-((stack - sm) ** 2) / (2 * 0.3**2))
    np.testing.assert_allclose(got, w * stack + (1 - w) * sm, rtol=0, atol=TOL * np.abs(stack).max())


@pytest.mark.parametrize("window", [1, 3, 4, 5, 9, 13])
def test_temporal_window_is_clamped_not_reflected(stack, window):
    """Frame i averages frames [max(0, i - h), min(T, i + h + 1)): the edge
    windows shrink (the reference's loop), where a reflected window would
    count frames 1, 2, ... twice. A window wider than the stack averages it
    all."""
    got = tpre.preprocess_temporal(torch.from_numpy(stack), window).numpy()
    T, half = stack.shape[0], window // 2
    want = np.stack([stack[max(0, i - half): min(T, i + half + 1)].mean(axis=0) for i in range(T)])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    _close(torch.from_numpy(got), jpre.preprocess_temporal(jnp.asarray(stack), window))
    if 1 < window < T:
        reflected = np.pad(stack, ((half, half), (0, 0), (0, 0)), mode="reflect")
        assert np.abs(got[0] - reflected[:window].mean(axis=0)).max() > 1e-3


def test_detrend_uses_the_population_std(stack):
    got = tpre.preprocess_detrend(torch.from_numpy(stack)).numpy()
    np.testing.assert_allclose(got.std(axis=(1, 2)), 1.0, rtol=1e-9)
    m, s = stack.mean(axis=(1, 2), keepdims=True), stack.std(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got, (stack - m) / (s + 1e-10), rtol=0, atol=TOL * np.abs(got).max())


def test_detrend_global_removes_an_exponential():
    base = np.random.default_rng(1).uniform(0.5, 1.0, size=(1, 8, 8))
    U = base * np.exp(-0.05 * np.arange(20))[:, None, None]
    got = tpre.preprocess_detrend_global(torch.from_numpy(U))
    _close(got, jpre.preprocess_detrend_global(jnp.asarray(U)))
    assert got.numpy().mean(axis=(1, 2)).std() < 1e-8
    np.testing.assert_allclose(float(got.std(correction=0)), 1.0, rtol=1e-9)


@pytest.mark.parametrize("noise_type,noise_level", [
    ("gaussian", 0.05), ("gaussian", 0.3), ("gaussian", 0.8), ("impulse", 0.05), ("impulse", 0.3),
])
def test_adaptive_policy(stack, noise_type, noise_level):
    got = tpre.preprocess_adaptive(torch.from_numpy(stack), noise_type, noise_level)
    _close(got, jpre.preprocess_adaptive(jnp.asarray(stack), noise_type, noise_level))


@pytest.mark.parametrize("poisson", [True, False])
def test_poisson_noise_check(poisson):
    """Bins, counts and the slope: ~1 for photon noise, ~0 for additive
    noise; every output within 1e-12 of its largest entry of pdx's."""
    rng = np.random.default_rng(3)
    lam = np.linspace(5, 200, 30 * 30).reshape(1, 30, 30)
    U = rng.poisson(lam, size=(25, 30, 30)).astype(float) if poisson else lam + 3.0 * rng.normal(size=(25, 30, 30))
    got = tpre.poisson_noise_check(torch.from_numpy(U))
    want = jpre.poisson_noise_check(jnp.asarray(U))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].reshape(np.shape(want[k])), want[k])
    assert abs(float(got["slope"]) - (1.0 if poisson else 0.0)) < 0.2
