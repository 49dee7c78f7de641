"""Kernels K1 (fused_ks_gram) and K3 (fused_blockwise_gram) of pdx_torch.

On the CPU the wrappers take their plain PyTorch versions, which are held
to pdx's Pallas kernels in interpret mode at test_pallas.py's own tolerance
(rtol 2e-4, atol 1e-4 * max|ref|: the TPU kernel sums in float32, the port
in float64) and to pdx's XLA references on float64 inputs at 1e-5 relative
to max|ref| (the port computes the fields in float32, as the kernel does).
The CUDA kernels themselves are compared with the plain versions by the
``gpu``-marked test, which skips without a card. The JAX side is imported
inside the tests, so that on a machine without jax the ``gpu`` tests run
with ``python -m pytest --noconftest -m gpu tests/test_torch_fused_gram.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pdx_torch.ops.kernels import fused_blockwise as tfb
from pdx_torch.ops.kernels import fused_gram as tfg

KEYS = ("G", "b", "sx", "syy", "sy", "n")


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(dtype), rng.normal(size=shape).astype(dtype)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, want, rtol, atol_rel, floor=0.0):
    for k in KEYS:
        g, w = _np(got[k]), _np(want[k])
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * max(np.abs(w).max(), floor), err_msg=k)


@pytest.fixture
def jx():
    import jax.numpy as jnp
    from pdx.ops.pallas import fused_blockwise, fused_gram

    return SimpleNamespace(jnp=jnp, fg=fused_gram, fb=fused_blockwise)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


class TestK1Plain:
    @pytest.mark.parametrize("shape,seed,dx,dy,floor", [
        ((8, 32, 128), 0, 0.5, 0.25, 0.0),
        ((7, 16, 128), 1, 1.0, 1.0, 1.0),  # T not a block_t multiple in pdx
    ])
    def test_matches_pdx_kernel_interpret(self, jx, shape, seed, dx, dy, floor):
        U, Ut = _inputs(shape, seed)
        want = jx.fg.fused_ks_gram(jx.jnp.asarray(U), jx.jnp.asarray(Ut), dx=dx, dy=dy, block_t=4, interpret=True)
        got = tfg.fused_ks_gram(torch.from_numpy(U), torch.from_numpy(Ut), dx=dx, dy=dy)
        assert got["G"].dtype == torch.float64
        _compare(got, want, 2e-4, 1e-4, floor)

    def test_matches_pdx_reference_f64(self, jx):
        U, Ut = _inputs((6, 24, 40), 2, np.float64)
        want = jx.fg.fused_ks_gram_reference(jx.jnp.asarray(U), jx.jnp.asarray(Ut), 0.5, 0.25)
        got = tfg.fused_ks_gram_reference(torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.25)
        _compare(got, want, 1e-5, 1e-5)

    def test_cpu_tensor_takes_plain_version(self):
        U, Ut = _inputs((4, 16, 16), 3)
        before = tfg.fused_ks_gram.launches
        got = tfg.fused_ks_gram(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5)
        want = tfg.fused_ks_gram_reference(torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.5)
        assert tfg.fused_ks_gram.launches == before
        for k in KEYS:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)

    def test_term_fields_match_pdx(self, jx):
        u = np.random.default_rng(4).normal(size=(3, 16, 20))
        got = tfg._term_fields(torch.from_numpy(u), 0.5, 0.25, tfg.RICH_TERM_NAMES)
        want = jx.fg._term_fields(jx.jnp.asarray(u), 0.5, 0.25, jx.fg.RICH_TERM_NAMES)
        assert tfg.RICH_TERM_NAMES == jx.fg.RICH_TERM_NAMES
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12 * np.abs(w).max())

    def test_rejects_bad_inputs(self):
        U = torch.zeros((4, 8, 8))
        with pytest.raises(ValueError, match="equal"):
            tfg.fused_ks_gram(U, torch.zeros((4, 8, 9)), dx=1.0, dy=1.0)
        with pytest.raises(TypeError, match="float32 or float64"):
            tfg.fused_ks_gram(U.half(), U.half(), dx=1.0, dy=1.0)


class TestK3Plain:
    @pytest.mark.parametrize("shape,seed", [
        ((9, 32, 128), 0),
        ((8, 30, 126), 1),  # ragged on all three axes
    ])
    def test_matches_pdx_kernel_interpret(self, jx, shape, seed):
        U, Ut = _inputs(shape, seed)
        want = jx.fb.fused_blockwise_gram(
            jx.jnp.asarray(U), jx.jnp.asarray(Ut), dx=0.5, dy=0.25, block_t=3, block_x=8, block_y=8, interpret=True
        )
        got = tfb.fused_blockwise_gram(
            torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.25, block_t=3, block_x=8, block_y=8
        )
        assert got["G"].dtype == torch.float64
        _compare(got, want, 2e-4, 1e-4, 1.0)

    def test_matches_pdx_reference_f64(self, jx):
        U, Ut = _inputs((8, 30, 126), 5, np.float64)
        kw = dict(block_t=3, block_x=8, block_y=8)
        want = jx.fb.fused_blockwise_gram_reference(jx.jnp.asarray(U), jx.jnp.asarray(Ut), 0.5, 0.25, **kw)
        got = tfb.fused_blockwise_gram_reference(torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.25, **kw)
        _compare(got, want, 1e-5, 1e-5)

    def test_cpu_tensor_takes_plain_version(self):
        U, Ut = _inputs((7, 20, 20), 6)
        before = tfb.fused_blockwise_gram.launches
        got = tfb.fused_blockwise_gram(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5, block_t=2)
        want = tfb.fused_blockwise_gram_reference(
            torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.5, block_t=2, block_x=8, block_y=8
        )
        assert tfb.fused_blockwise_gram.launches == before
        for k in KEYS:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)

    def test_rejects_nonpositive_blocks(self):
        U = torch.zeros((4, 8, 8))
        with pytest.raises(ValueError, match="positive"):
            tfb.fused_blockwise_gram(U, U, dx=1.0, dy=1.0, block_x=0)


@pytest.mark.parametrize("n,unit", [(100, 1), (100, 8), (30, 8), (126, 8), (16, 1), (5, 200)])
def test_tiles_cover_axis_in_whole_blocks(n, unit):
    tile, n_tiles = tfg._tile(n, unit)
    assert tile % unit == 0
    assert (n_tiles - 1) * tile < n <= n_tiles * tile
    assert tile <= max(tfg._MAX_TILE, unit)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,blocks", [
    ((1999, 100, 100), (3, 8, 8)),  # the main path
    ((8, 30, 126), (3, 8, 8)),  # ragged on every axis
    ((7, 3, 5), (2, 2, 3)),  # frames smaller than the halo
    ((9, 130, 257), (4, 16, 5)),  # several tiles per axis
    ((5, 100, 70), (5, 100, 1)),  # one block spans the frame height
])
def test_kernels_match_plain_on_card(cuda, shape, blocks):
    """K1 and K3 against their plain versions on the card, 1e-5 of max|plain|."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, 7))
    k1 = tfg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5)
    _compare(k1, tfg.fused_ks_gram_reference(U, Ut, 0.5, 0.5), 1e-5, 1e-5)
    kw = dict(zip(("block_t", "block_x", "block_y"), blocks))
    k3 = tfb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw)
    _compare(k3, tfb.fused_blockwise_gram_reference(U, Ut, 0.5, 0.5, **kw), 1e-5, 1e-5)


@pytest.mark.gpu
def test_wrappers_count_launches_and_refuse_oversized_blocks(cuda):
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs((4, 300, 300), 8))
    before = (tfg.fused_ks_gram.launches, tfb.fused_blockwise_gram.launches)
    tfg.fused_ks_gram(U, Ut, dx=1.0, dy=1.0)
    tfb.fused_blockwise_gram(U, Ut, dx=1.0, dy=1.0)
    assert (tfg.fused_ks_gram.launches, tfb.fused_blockwise_gram.launches) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="shared memory"):
        tfb.fused_blockwise_gram(U, Ut, dx=1.0, dy=1.0, block_x=300, block_y=300)
