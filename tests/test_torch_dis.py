"""pdx_torch.register.dis, .tvl1 and .quality against pdx.register, float64,
on smooth random fields shifted by known amounts (one 70 x 64 shape, so that
the finest DIS level leaves uncovered rows that keep the initial flow).

Tolerances: ``dis_flow`` and ``tvl1_flow`` within 1e-10 of max|flow| of
``pdx``'s (measured ~6e-15 and ~4e-12: the sampler's blend, the reductions,
the densification sums and TV-L1's 150 iterations a level round in another
order). ``registration_improvement`` of given stacks (float64 Farnebäck
flows on both sides) within 1e-10 relative; after ``pdx``'s and the port's
own Farnebäck chains, whose flows are float32 on a float64 stack, within
1e-6 relative (the registered frames differ by ~1e-7).

The ``gpu`` tests hold the card against the CPU and check that the card's
DIS flow repeats bit for bit (its densification is a gather, no float
atomics); ``pdx`` is imported inside the tests.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

from pdx_torch.ops.kernels.dis_patches import _densify, _patch_grid_coords, _patches
from pdx_torch.register import dis as tdis
from pdx_torch.register import quality as tq
from pdx_torch.register import tvl1 as ttv
from pdx_torch.register.farneback import farneback_register_sequence
from torch_card import cuda

SHAPE = (70, 64)


def field(seed=9, sigma=5):
    f = gaussian_filter(np.random.default_rng(seed).normal(size=SHAPE), sigma)
    return (f - f.min()) / (f.max() - f.min())


def _pair(s=(1.5, -1.0)):
    base = field()
    return base, ndshift(base, s, mode="reflect")


def _stack(T=4):
    base = field(seed=12, sigma=6)
    rng = np.random.default_rng(2)
    return np.stack([base] + [ndshift(base, rng.uniform(-1.5, 1.5, 2), mode="reflect") for _ in range(T - 1)])


def _close(got, want, tol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def test_dis_flow_equals_pdx():
    import jax.numpy as jnp
    from pdx.register.dis import dis_flow

    base, mov = _pair()
    got = tdis.dis_flow(torch.from_numpy(base), torch.from_numpy(mov))
    want = dis_flow(jnp.asarray(base), jnp.asarray(mov))
    for g, w in zip(got, want):
        _close(g, w)
    m = slice(16, -16)  # and it recovers the shift, as pdx's own test asks
    assert abs(float(got[0][m, m].median()) - 1.5) < 0.5 and abs(float(got[1][m, m].median()) + 1.0) < 0.5


@pytest.mark.parametrize("ps,st", [(8, 4), (8, 3), (4, 2)])
def test_densification_is_the_scatter_add(ps, st):
    """fold's per-pixel sums equal pdx's scatter-add (``.at[].add``, here
    ``index_put_`` with accumulate on the CPU) of the patch values (within
    1e-14 relative: another summation order), with 0 where no patch lies;
    the patches are the grid's."""
    H, W = SHAPE
    coords = _patch_grid_coords(H, W, ps, st)
    P = coords.shape[0]
    vals = torch.from_numpy(np.random.default_rng(ps + st).uniform(0.5, 2.0, size=(3, P)))
    got = _densify(vals, H, W, ps, st)
    r = torch.as_tensor(coords[:, 0, None] + np.arange(ps))[:, :, None].expand(P, ps, ps)
    c = torch.as_tensor(coords[:, 1, None] + np.arange(ps))[:, None, :].expand(P, ps, ps)
    want = torch.stack([
        torch.zeros(SHAPE, dtype=torch.float64).index_put_((r, c), v[:, None, None].expand(P, ps, ps), accumulate=True)
        for v in vals
    ])
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0)
    assert (got[2] == 0).any() or (H - ps) % st == 0  # uncovered margins stay 0
    img = torch.from_numpy(field())
    assert torch.equal(_patches(img, ps, st), torch.stack([img[r[k], c[k]] for k in range(P)]))


def test_uncovered_pixels_keep_the_initial_flow():
    """70 rows, 8-pixel patches at stride 4: rows 68 and 69 lie in no patch
    and keep the initial flow."""
    base, mov = _pair()
    init = torch.full(SHAPE, 0.25, dtype=torch.float64)
    fx, fy = tdis._level_flow(torch.from_numpy(base), torch.from_numpy(mov), init, -init, 8, 4, 3)
    assert torch.equal(fx[68:], init[68:]) and torch.equal(fy[68:], -init[68:])
    assert not torch.equal(fx[:68], init[:68])


def test_tvl1_flow_equals_pdx():
    import jax.numpy as jnp
    from pdx.register.tvl1 import tvl1_flow

    base, mov = _pair((0.8, -0.6))
    got = ttv.tvl1_flow(torch.from_numpy(base), torch.from_numpy(mov))
    want = tvl1_flow(jnp.asarray(base), jnp.asarray(mov))
    for g, w in zip(got, want):
        _close(g, w)
    m = slice(16, -16)
    assert abs(float(got[0][m, m].median()) - 0.8) < 0.3 and abs(float(got[1][m, m].median()) + 0.6) < 0.3
    # identical frames: no flow
    still = ttv.tvl1_flow(torch.from_numpy(base), torch.from_numpy(base))
    assert max(float(f.abs().max()) for f in still) < 1e-6


def test_registration_improvement_equals_pdx():
    """On given stacks (float64 flows on both sides), and after each
    package's own Farnebäck chain."""
    import jax.numpy as jnp
    from pdx.register import farneback_register_sequence as j_register
    from pdx.register.quality import registration_improvement

    U = _stack()
    shifted = np.roll(U, 1, axis=-1)
    got = tq.registration_improvement(torch.from_numpy(U), torch.from_numpy(shifted))
    want = registration_improvement(jnp.asarray(U), jnp.asarray(shifted))
    assert set(got) == set(want) == {"avg_flow_before", "avg_flow_after", "improvement_pct"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-10)
    assert float(tq.mean_flow_magnitude(torch.from_numpy(U))) == pytest.approx(float(got["avg_flow_before"]), rel=0)

    got = tq.registration_improvement(torch.from_numpy(U), farneback_register_sequence(torch.from_numpy(U)))
    want = registration_improvement(jnp.asarray(U), j_register(jnp.asarray(U)))
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert float(got["improvement_pct"]) > 20.0


@pytest.mark.gpu
def test_dis_flow_card_equals_cpu_and_repeats(cuda):
    base, mov = (torch.from_numpy(a) for a in _pair())
    first = tdis.dis_flow(base.to(cuda), mov.to(cuda))
    again = tdis.dis_flow(base.to(cuda), mov.to(cuda))
    on_cpu = tdis.dis_flow(base, mov)
    for a, b, c in zip(first, again, on_cpu):
        assert torch.equal(a, b)
        _close(a.cpu(), c)


@pytest.mark.gpu
def test_tvl1_and_quality_card_equal_cpu(cuda):
    base, mov = (torch.from_numpy(a) for a in _pair((0.8, -0.6)))
    for a, b in zip(ttv.tvl1_flow(base.to(cuda), mov.to(cuda)), ttv.tvl1_flow(base, mov)):
        _close(a.cpu(), b)
    U = torch.from_numpy(_stack())
    np.testing.assert_allclose(float(tq.mean_flow_magnitude(U.to(cuda))), float(tq.mean_flow_magnitude(U)), rtol=1e-10)
