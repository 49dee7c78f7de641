"""pdx_torch.ops.spectral and the spectral dictionaries against pdx, float64.

Both packages take the same numpy input through the same FFT formulas, so
the results agree at rtol 1e-12 with an absolute floor of 1e-12 * max|ref|
(FFT round-off of pocketfft vs XLA's FFT on values that cancel to ~0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.library import dictionaries as jdict
from pdx.ops import spectral as jsp
from pdx_torch.library import dictionaries as tdict
from pdx_torch.ops import spectral as tsp

TOL = 1e-12


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.fixture
def field():
    return np.random.default_rng(0).normal(size=(3, 20, 24))


@pytest.mark.parametrize("n,d", [(20, 0.5), (21, 0.25), (1, 1.0)])
def test_wavenumbers(n, d):
    KX, KY = tsp.spectral_wavenumbers(n, 16, d, 0.3)
    JX, JY = jsp.spectral_wavenumbers(n, 16, d, 0.3)
    np.testing.assert_array_equal(KX.numpy(), np.asarray(JX))
    np.testing.assert_array_equal(KY.numpy(), np.asarray(JY))


@pytest.mark.parametrize("cutoff", [0.3, 0.65, 1.0, 1.5])
def test_mask(cutoff):
    KX, KY = tsp.spectral_wavenumbers(20, 24, 0.5, 0.25)
    JX, JY = jsp.spectral_wavenumbers(20, 24, 0.5, 0.25)
    got, want = tsp.spectral_mask(KX, KY, cutoff), jsp.spectral_mask(JX, JY, cutoff)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if cutoff >= 1.0:
        assert bool((got == 1).all())
    with pytest.raises(ValueError, match="positive"):
        tsp.spectral_mask(KX, KY, 0.0)


@pytest.mark.parametrize("cutoff", [1.0, 0.5])
def test_derivatives(field, cutoff):
    u, ju = torch.from_numpy(field), jnp.asarray(field)
    gx, gy = tsp.gradients_spectral(u, 0.5, 0.25, cutoff_frac=cutoff)
    jx, jy = jsp.gradients_spectral(ju, 0.5, 0.25, cutoff_frac=cutoff)
    _close(gx, jx)
    _close(gy, jy)
    _close(tsp.laplacian_spectral(u, 0.5, 0.25, cutoff_frac=cutoff), jsp.laplacian_spectral(ju, 0.5, 0.25, cutoff_frac=cutoff))
    _close(tsp.biharmonic_spectral(u, 0.5, 0.25, cutoff_frac=cutoff), jsp.biharmonic_spectral(ju, 0.5, 0.25, cutoff_frac=cutoff))


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5])
def test_gaussian_smooth_periodic(field, sigma):
    u = torch.from_numpy(field)
    got = tsp.gaussian_smooth_periodic(u, sigma)
    _close(got, jsp.gaussian_smooth_periodic(jnp.asarray(field), sigma))
    assert (got is u) == (sigma == 0.0)


def test_gaussian_smooth_float32_builds_float32_transfer(field):
    """pdx builds the transfer function in result_type(f.dtype, float32)."""
    f32 = field.astype(np.float32)
    got = tsp.gaussian_smooth_periodic(torch.from_numpy(f32), 1.5)
    assert got.dtype == torch.float32
    _close(got, jsp.gaussian_smooth_periodic(jnp.asarray(f32), 1.5), 1e-5)


@pytest.mark.parametrize("kind,flag", [("true", False), ("true", True), ("rich", False), ("rich", True)])
def test_spectral_dictionaries(field, kind, flag):
    u = field * 0.1
    if kind == "true":
        names, terms = tdict.build_dictionary_true(torch.from_numpy(u), 0.5, 0.25, deriv="spectral", spectral_cutoff=0.7, include_advection=flag)
        jnames, jterms = jdict.build_dictionary_true(jnp.asarray(u), 0.5, 0.25, deriv="spectral", spectral_cutoff=0.7, include_advection=flag)
    else:
        names, terms = tdict.build_dictionary_rich(torch.from_numpy(u), 0.5, 0.25, deriv="spectral", spectral_cutoff=0.7, drop_advection=flag)
        jnames, jterms = jdict.build_dictionary_rich(jnp.asarray(u), 0.5, 0.25, deriv="spectral", spectral_cutoff=0.7, drop_advection=flag)
    assert names == jnames
    _close(terms, jterms)
