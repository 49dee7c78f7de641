"""pdx_torch.ops.filters against pdx.ops.filters, float64.

Moving averages: the same cumulative-sum formulation on both sides; only
the order of XLA's and PyTorch's cumulative sums differs. Gaussian filters:
``pdx`` adds shifted copies tap by tap, the port multiplies the sliding
windows by the taps; the same products summed in another order. Either way
the results agree at rtol 1e-12 with an absolute floor of 1e-12 * max|ref|,
and the Gaussians also match scipy.ndimage (whose "reflect" border is the
symmetric padding both use) at the same limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, gaussian_filter1d

from pdx.ops import filters as jfl
from pdx_torch.ops import filters as tfl

TOL = 1e-12


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("T,window", [(9, 1), (9, 3), (9, 5), (4, 7), (2, 3)])
def test_time_smooth_moving_average(T, window):
    U = np.random.default_rng(T).normal(size=(T, 6, 7))
    got = tfl.time_smooth_moving_average(torch.from_numpy(U), window)
    assert got.shape == U.shape
    _close(got, jfl.time_smooth_moving_average(jnp.asarray(U), window))


@pytest.mark.parametrize("window", [2, 4])
def test_time_smooth_even_window_raises(window):
    U = torch.zeros((5, 3, 3))
    with pytest.raises(ValueError, match="odd"):
        tfl.time_smooth_moving_average(U, window)
    with pytest.raises(ValueError, match="odd"):
        jfl.time_smooth_moving_average(jnp.zeros((5, 3, 3)), window)


@pytest.mark.parametrize("window", [0, 1, 2, 3, 6, 7, 15])
def test_smooth_1d(window):
    """Even windows are bumped to the next odd one, as in pdx."""
    x = np.random.default_rng(window).normal(size=(2, 11))
    got = tfl.smooth_1d(torch.from_numpy(x), window)
    assert got.shape == x.shape
    _close(got, jfl.smooth_1d(jnp.asarray(x), window))


@pytest.mark.parametrize("sigma", [0.0, 0.5, 1.0, 1.2, 2.0])
def test_gaussian_filter_reflect(sigma):
    f = np.random.default_rng(3).normal(size=(3, 21, 17))
    got = tfl.gaussian_filter_reflect(torch.from_numpy(f), sigma)
    assert got.shape == f.shape
    _close(got, jfl.gaussian_filter_reflect(jnp.asarray(f), sigma))
    if sigma > 0:
        _close(got, gaussian_filter(f, (0, sigma, sigma), mode="reflect"))


@pytest.mark.parametrize("sigma,truncate", [(3.0, 4.0), (6.0, 4.0), (2.0, 9.0)])
def test_gaussian_filter_taps_outnumber_pixels(sigma, truncate):
    """Radius int(truncate * sigma + 0.5) > the 5 x 7 frame: the symmetric
    padding folds more than once."""
    f = np.random.default_rng(4).normal(size=(2, 5, 7))
    radius = int(truncate * sigma + 0.5)
    assert radius > 7
    got = tfl.gaussian_filter_reflect(torch.from_numpy(f), sigma, truncate)
    _close(got, jfl.gaussian_filter_reflect(jnp.asarray(f), sigma, truncate))
    _close(got, gaussian_filter(f, (0, sigma, sigma), mode="reflect", truncate=truncate))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gaussian_filter1d_reflect(axis):
    x = np.random.default_rng(5).normal(size=(9, 6, 11))
    got = tfl.gaussian_filter1d_reflect(torch.from_numpy(x), 1.5, axis=axis)
    _close(got, jfl.gaussian_filter1d_reflect(jnp.asarray(x), 1.5, axis=axis))
    _close(got, gaussian_filter1d(x, 1.5, axis=axis, mode="reflect"))


def test_symmetric_padding_is_not_reflect_101():
    """The edge sample is repeated (scipy's "reflect"), unlike
    torch.nn.functional.pad(mode="reflect")."""
    x = torch.arange(4.0)
    win = tfl.symmetric_windows(x, 5, 0)
    assert win[0].tolist() == [1.0, 0.0, 0.0, 1.0, 2.0]
    assert win[-1].tolist() == [1.0, 2.0, 3.0, 3.0, 2.0]

