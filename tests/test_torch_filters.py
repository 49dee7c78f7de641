"""pdx_torch.ops.filters against pdx.ops.filters, float64.

Moving averages: the same cumulative-sum formulation on both sides; only
the order of XLA's and PyTorch's cumulative sums differs. Gaussian filters:
``pdx`` adds shifted copies tap by tap, the port multiplies the sliding
windows by the taps; the same products summed in another order. Either way
the results agree at rtol 1e-12 with an absolute floor of 1e-12 * max|ref|,
and the Gaussians also match scipy.ndimage (whose "reflect" border is the
symmetric padding both use) at the same limit.

``savgol_time``: ``pdx`` adds the interior taps one shifted copy at a time,
the port contracts the frame axis with a banded matrix; both fit the edges
with the same host float64 projectors. Within 1e-10 of max|value| of
``pdx``'s result (measured ~2e-16), and scipy.signal.savgol_filter's
``mode="interp"`` within 1e-12 of max|value| (scipy fits its edges by
``polyfit``, another rounding; measured ~2e-14).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, gaussian_filter1d
from scipy.signal import savgol_filter

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



@pytest.mark.parametrize("T,window,poly", [(9, 3, 2), (12, 7, 3), (7, 7, 3), (5, 5, 2), (20, 5, 2), (3, 3, 2)])
def test_savgol_time(T, window, poly):
    U = np.random.default_rng(T + window).normal(size=(T, 6, 5))
    got = tfl.savgol_time(torch.from_numpy(U), window, poly).numpy()
    want = np.asarray(jfl.savgol_time(jnp.asarray(U), window, poly))
    assert got.shape == U.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got, savgol_filter(U, window, poly, axis=0, mode="interp"), rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("T,window,match", [(5, 4, "odd"), (4, 5, "longer")])
def test_savgol_time_raises(T, window, match):
    """An even window, and a window longer than the sequence, as in pdx."""
    with pytest.raises(ValueError, match=match):
        tfl.savgol_time(torch.zeros((T, 3, 3), dtype=torch.float64), window, 2)
    with pytest.raises(ValueError, match=match):
        jfl.savgol_time(jnp.zeros((T, 3, 3)), window, 2)
