"""pdx_torch.library.localpoly against pdx.library.localpoly and the
reference's per-point lstsq, float64.

The extraction operator is the same host numpy computation on both sides
(equal to the last bit). The derivatives are one gather and one (N, K) x
(K, 6) product on both sides, summed in another order: rtol 1e-12 with an
absolute floor of 1e-12 * max|ref|. Against the per-point lstsq oracle
(pinv and lstsq solve the same least-squares problem by different
factorisations): rtol 1e-7, atol 1e-9, as pdx's own test
(tests/test_real_pipelines.py:348-380).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.library import localpoly as jlp
from pdx_torch.library import localpoly as tlp


@pytest.mark.parametrize("deg", [1, 2, 3, 4])
def test_exponents_and_operator(deg):
    assert tlp.poly3d_exponents(deg) == jlp.poly3d_exponents(deg)
    args = (2, 3, deg, 1.0, 0.1, 0.1)
    E = tlp._extraction_operator(*args)
    np.testing.assert_array_equal(E, jlp._extraction_operator(*args))
    assert not E.flags.writeable  # shared by every caller of the cache


@pytest.fixture(scope="module")
def stack():
    return np.random.default_rng(3).normal(size=(9, 20, 22))


@pytest.mark.parametrize("rt,rs,deg,dt,dx,dy", [(2, 3, 3, 1.0, 0.1, 0.1), (1, 2, 2, 0.5, 0.2, 0.3)])
def test_matches_pdx(stack, rt, rs, deg, dt, dx, dy):
    rng = np.random.default_rng(4)
    pts = np.stack([rng.integers(rt, 9 - rt, 50), rng.integers(rs, 20 - rs, 50), rng.integers(rs, 22 - rs, 50)], 1)
    kw = dict(rt=rt, rs=rs, deg=deg, dt=dt, dx=dx, dy=dy)
    got = tlp.local_poly_derivatives_batch(torch.from_numpy(stack), pts, **kw)
    want = np.asarray(jlp.local_poly_derivatives_batch(jnp.asarray(stack), pts, **kw))
    assert got.shape == (50, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_matches_per_point_lstsq(stack):
    U = stack
    rt, rs, deg = 2, 3, 3
    dt, dx, dy = 1.0, 0.1, 0.1
    pts = np.array([[3, 5, 7], [4, 10, 12], [6, 8, 15]])
    got = tlp.local_poly_derivatives_batch(torch.from_numpy(U), torch.from_numpy(pts), rt=rt, rs=rs, deg=deg,
                                           dt=dt, dx=dx, dy=dy).numpy()
    exps = tlp.poly3d_exponents(deg)
    for row, (t0, y0, x0) in zip(got, pts):
        t_idx = np.arange(t0 - rt, t0 + rt + 1)
        y_idx = np.arange(y0 - rs, y0 + rs + 1)
        x_idx = np.arange(x0 - rs, x0 + rs + 1)
        Tt, Yy, Xx = np.meshgrid((t_idx - t0) * dt, (y_idx - y0) * dy, (x_idx - x0) * dx, indexing="ij")
        vals = U[np.ix_(t_idx, y_idx, x_idx)]
        A = np.column_stack([(Tt.ravel() ** a) * (Xx.ravel() ** b) * (Yy.ravel() ** c) for a, b, c in exps])
        coef, *_ = np.linalg.lstsq(A, vals.ravel(), rcond=None)

        def g(a, b, c):
            return coef[exps.index((a, b, c))]

        want = [g(0, 0, 0), g(1, 0, 0), g(0, 1, 0), g(0, 0, 1), 2 * g(0, 2, 0), 2 * g(0, 0, 2)]
        np.testing.assert_allclose(row, want, rtol=1e-7, atol=1e-9)


def test_float32_stack_keeps_its_dtype(stack):
    pts = np.array([[4, 10, 10]])
    got = tlp.local_poly_derivatives_batch(torch.from_numpy(stack.astype(np.float32)), pts, rt=2, rs=3, deg=3,
                                           dt=1.0, dx=0.1, dy=0.1)
    assert got.dtype == torch.float32
