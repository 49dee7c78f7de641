"""pdx_torch.ops.interp (reflect-101 sampler, shifts, warps, resizes) and
pdx_torch.preprocess against pdx, float64.

Both sides gather the same four corner values and weigh them with the same
products; the resizes and the Gaussian of the preprocessing head sum the
same products in another order (two interpolation matrices where ``pdx``
gathers on the CPU; a window product where it adds shifted copies). So the
results agree at rtol 1e-12 with an absolute floor of 1e-12 * max|ref|.
``pdx`` runs with its CPU defaults, the taps sampler and shifted-add passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.ops import interp as ji
from pdx.preprocess import resize_denoise_normalize as j_rdn
from pdx_torch.ops import interp as ti
from pdx_torch.preprocess import resize_denoise_normalize as t_rdn

TOL = 1e-12


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_reflect101_index(n):
    i = np.arange(-40, 41)
    np.testing.assert_array_equal(ti._reflect101_index(_t(i), n).numpy(), np.asarray(ji._reflect101_index(jnp.asarray(i), n)))


@pytest.fixture(scope="module")
def field():
    return np.random.default_rng(0).normal(size=(3, 20, 17))


def test_bilinear_sample_reflect_shared_grid(field):
    """Coordinates far outside the frame fold more than once."""
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-45, 60, size=(2, 11, 13))
    _close(ti.bilinear_sample_reflect(_t(field), _t(x), _t(y)), ji.bilinear_sample_reflect(jnp.asarray(field), x, y))


def test_bilinear_sample_reflect_grid_per_frame(field):
    """Coordinates with leading axes sample each frame at its own grid:
    pdx's batched sampler."""
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-5, 25, size=(2, 3, 20, 17))
    want = ji.bilinear_sample_reflect_batch(jnp.asarray(field), jnp.asarray(x), jnp.asarray(y))
    _close(ti.bilinear_sample_reflect(_t(field), _t(x), _t(y)), want)


@pytest.mark.parametrize("sx,sy", [(1.3, -2.7), (0.0, 0.5), (-7.25, 4.0)])
def test_shift_reflect(field, sx, sy):
    _close(ti.shift_reflect(_t(field), sx, sy), ji.shift_reflect(jnp.asarray(field), sx, sy))


def test_shift_reflect_one_shift_per_frame(field):
    sx, sy = np.array([0.4, -1.6, 2.2]), np.array([-0.3, 0.0, 1.9])
    want = jax.vmap(ji.shift_reflect)(jnp.asarray(field), jnp.asarray(sx), jnp.asarray(sy))
    _close(ti.shift_reflect(_t(field), _t(sx), _t(sy)), want)


@pytest.mark.parametrize("border", ["reflect", "wrap"])
def test_remap_bilinear(field, border):
    rng = np.random.default_rng(3)
    mx, my = rng.uniform(-8, 28, size=(2, 20, 17))
    got = ti.remap_bilinear(_t(field), _t(mx), _t(my), border=border)
    _close(got, ji.remap_bilinear(jnp.asarray(field), jnp.asarray(mx), jnp.asarray(my), border=border))
    with pytest.raises(ValueError):
        ti.remap_bilinear(_t(field), _t(mx), _t(my), border="nearest")


def test_warp_flow_and_batch(field):
    rng = np.random.default_rng(4)
    fx, fy = rng.normal(scale=2.0, size=(2, 20, 17))
    _close(ti.warp_flow(_t(field), _t(fx), _t(fy)), ji.warp_flow(jnp.asarray(field), jnp.asarray(fx), jnp.asarray(fy)))
    bx, by = rng.normal(scale=2.0, size=(2, 3, 20, 17))
    want = ji.warp_flow_batch(jnp.asarray(field), jnp.asarray(bx), jnp.asarray(by))
    _close(ti.warp_flow_batch(_t(field), _t(bx), _t(by)), want)


@pytest.mark.parametrize("shape", [(10, 17), (5, 5), (7, 6), (20, 17)])
def test_resize_area(field, shape):
    """Integer factors (10, 17): a block mean; others: coverage weights."""
    _close(ti.resize_area(_t(field), *shape), ji.resize_area(jnp.asarray(field), *shape))


def test_resize_area_uint16_promotes_to_float32():
    u = np.random.default_rng(5).integers(0, 65536, size=(4, 24, 18)).astype(np.uint16)
    for shape in ((12, 9), (10, 7)):
        got = ti.resize_area(_t(u), *shape)
        want = np.asarray(ji.resize_area(jnp.asarray(u), *shape))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the 2x block mean of integers is exact in float32
    np.testing.assert_array_equal(ti.resize_area(_t(u), 12, 9).numpy(), u.reshape(4, 12, 2, 9, 2).mean(axis=(2, 4)))


@pytest.mark.parametrize("shape", [(10, 8), (7, 5), (40, 30), (20, 17), (3, 33)])
def test_resize_bilinear(field, shape):
    _close(ti.resize_bilinear(_t(field), *shape), ji.resize_bilinear(jnp.asarray(field), *shape))


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_resize_denoise_normalize(dtype_name):
    """The preprocessing head on uint16 frames: downsample at the input
    dtype, cast, blur, min-max. float32 at rtol 1e-6."""
    u = np.random.default_rng(6).integers(0, 60000, size=(3, 32, 40)).astype(np.uint16)
    kw = dict(out_h=16, out_w=20, sigma=1.0, eps=1e-12, dtype_name=dtype_name)
    got = t_rdn(_t(u), **kw)
    want = np.asarray(j_rdn(jnp.asarray(u), **kw))
    assert got.dtype == getattr(torch, dtype_name) and got.shape == want.shape
    tol = TOL if dtype_name == "float64" else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert float(got.min()) == 0.0 and abs(float(got.max()) - 1.0) < 1e-6
