"""pdx_torch.ops.filters (moving averages) against pdx.ops.filters, float64.

Same cumulative-sum formulation on both sides; only the order of XLA's and
PyTorch's cumulative sums differs, so the results agree at rtol 1e-12 with
an absolute floor of 1e-12 * max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
