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


# The comprehensive benchmark's bank: median, the two TV iterations and the
# separable 3-D Gaussian, float64, at TOL.


@pytest.mark.parametrize("size", [1, 3, 5])
def test_median_filter_2d(size):
    """The sorted middle of the k^2 shifted views of the symmetric pad:
    bitwise pdx's and scipy.ndimage.median_filter's (default "reflect")."""
    from scipy.ndimage import median_filter

    U = np.random.default_rng(size).normal(size=(4, 11, 13))
    got = tfl.median_filter_2d(torch.from_numpy(U), size).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfl.median_filter_2d(jnp.asarray(U), size)))
    np.testing.assert_array_equal(got, np.stack([median_filter(u, size=size) for u in U]))
    np.testing.assert_array_equal(tfl.median_filter_3x3(torch.from_numpy(U)).numpy(),
                                  np.asarray(jfl.median_filter_3x3(jnp.asarray(U))))


@pytest.mark.parametrize("size", [0, 2, 4])
def test_median_filter_even_size_raises(size):
    """Even (and empty) windows have no middle sample; both packages refuse
    them rather than pick one of the two middles."""
    with pytest.raises(ValueError, match="odd"):
        tfl.median_filter_2d(torch.zeros((2, 5, 5), dtype=torch.float64), size)
    with pytest.raises(ValueError, match="odd"):
        jfl.median_filter_2d(jnp.zeros((2, 5, 5)), size)


def _tv_reference_loop(f, weight, n_iter):
    """comprehensive_benchmark.py:190-203 transcribed in numpy."""
    u = f.copy()
    for _ in range(n_iter):
        gx = np.roll(u, -1, axis=-2) - u
        gy = np.roll(u, -1, axis=-1) - u
        norm = np.sqrt(gx**2 + gy**2 + 1e-8)
        div = (gx - np.roll(gx, 1, axis=-2)) / norm + (gy - np.roll(gy, 1, axis=-1)) / norm
        u = f + weight * div
    return u


@pytest.mark.parametrize("n_iter", [1, 2, 3])
def test_tv_denoise_steps_match_pdx_and_the_reference_loop(n_iter):
    """The first steps against pdx's jitted scan and the reference's numpy
    loop at TOL. Over the default 50 steps the iteration amplifies
    round-off: pdx, numpy and PyTorch part by an ulp in the first step, by
    ~1e-10 (numpy) to ~1e-7 (pdx) of max|u| after 50 steps on white noise,
    and by O(1) on the benchmark's KS fields. That is a fault of the
    reference method (F8), so only the first steps are held."""
    import jax

    U = np.random.default_rng(n_iter).normal(size=(3, 12, 14))
    got = tfl.tv_denoise(torch.from_numpy(U), 0.1, n_iter)
    _close(got, jax.jit(lambda f: jfl.tv_denoise(f, 0.1, n_iter))(jnp.asarray(U)))
    _close(got, _tv_reference_loop(U, 0.1, n_iter))


def test_tv_denoise_reanchors_to_the_input():
    """Every step is u = f + weight * div(u): two steps are not one step
    taken again from the first step's output."""
    U = np.random.default_rng(7).normal(size=(3, 12, 14))
    one = tfl.tv_denoise(torch.from_numpy(U), 0.1, 1).numpy()
    two = tfl.tv_denoise(torch.from_numpy(U), 0.1, 2).numpy()
    _close(torch.from_numpy(two), _tv_reference_loop(U, 0.1, 2))
    assert np.abs(two - _tv_reference_loop(one, 0.1, 1)).max() > 1e-3


@pytest.mark.parametrize("n_iter", [1, 2, 3])
def test_tv_denoise_curvature(n_iter):
    """jnp.gradient's derivatives (one-sided first-order edges, unit
    spacing), no re-anchoring; against pdx and numpy's gradient."""
    import jax

    U = np.random.default_rng(n_iter + 10).normal(size=(3, 12, 14))
    got = tfl.tv_denoise_curvature(torch.from_numpy(U), 0.05, n_iter)
    _close(got, jax.jit(lambda f: jfl.tv_denoise_curvature(f, 0.05, n_iter))(jnp.asarray(U)))
    img = U.copy()
    for _ in range(n_iter):
        gx, gy = np.gradient(img, axis=-2), np.gradient(img, axis=-1)
        mag = np.sqrt(gx**2 + gy**2) + 1e-8
        img = img + 0.05 * (np.gradient(gx / mag, axis=-2) + np.gradient(gy / mag, axis=-1))
    _close(got, img)


@pytest.mark.parametrize("sigma_t,sigma_s", [(1.0, 1.5), (0.0, 2.0), (1.5, 0.0)])
def test_gaussian_filter3d_reflect(sigma_t, sigma_s):
    U = np.random.default_rng(5).normal(size=(8, 10, 12))
    got = tfl.gaussian_filter3d_reflect(torch.from_numpy(U), sigma_t, sigma_s)
    _close(got, jfl.gaussian_filter3d_reflect(jnp.asarray(U), sigma_t, sigma_s))
    _close(got, gaussian_filter(U, (sigma_t, sigma_s, sigma_s)))
