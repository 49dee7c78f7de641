"""Kernels K1 (fused_ks_gram), K2 (fused_ks_gram_terms), K3
(fused_blockwise_gram) and K4 (fused_blockwise_gram_terms) of pdx_torch.

On the CPU the wrappers take their plain PyTorch versions, which are held
to pdx's Pallas kernels in interpret mode at test_pallas.py's own tolerances
(K1/K3: rtol 2e-4, atol 1e-4 * max|ref|; K2/K4: rtol 3e-4,
atol 2e-4 * max(|ref|, 1); the TPU kernels sum in float32, the port in
float64) and to pdx's XLA references on float64 inputs at 1e-5 relative to
max|ref| (the port computes the fields in float32, as the kernels do). The
CUDA kernels themselves are compared with the plain versions by the
``gpu``-marked tests, which skip without a card, each entry within 1e-5 of
its own Cauchy-Schwarz scale: sqrt(G_ii G_jj) for G_ij, sqrt(G_ii syy) for
b_i, sqrt(G_ii n) for sx_i, sqrt(n syy) for sy, syy and n for themselves. The JAX side is imported inside the tests, so that on a
machine without jax the ``gpu`` tests run with
``python -m pytest --noconftest -m gpu tests/test_torch_fused_gram.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pdx_torch.ops.kernels import fused_blockwise as tfb
from pdx_torch.ops.kernels import fused_gram as tfg
from pdx_torch.utils.profiling import total

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


def _compare_scaled(got, want, tol):
    """Each entry of each statistic within tol of its Cauchy-Schwarz scale."""
    d = np.abs(np.diagonal(_np(want["G"])))
    n, syy = abs(float(_np(want["n"]))), abs(float(_np(want["syy"])))
    scales = {"G": np.sqrt(np.outer(d, d)), "b": np.sqrt(d * syy), "sx": np.sqrt(d * n),
              "n": n, "sy": np.sqrt(n * syy), "syy": syy}
    for k in KEYS:
        err = np.abs(_np(got[k]) - _np(want[k]))
        assert np.all(err <= tol * scales[k]), (k, err, tol * scales[k])


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
        before = total("fused_ks_gram.launches")
        got = tfg.fused_ks_gram(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5)
        want = tfg.fused_ks_gram_reference(torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.5)
        assert total("fused_ks_gram.launches") == before
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
        before = total("fused_blockwise_gram.launches")
        got = tfb.fused_blockwise_gram(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5, block_t=2)
        want = tfb.fused_blockwise_gram_reference(
            torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.5, block_t=2, block_x=8, block_y=8
        )
        assert total("fused_blockwise_gram.launches") == before
        for k in KEYS:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)

    def test_rejects_nonpositive_blocks(self):
        U = torch.zeros((4, 8, 8))
        with pytest.raises(ValueError, match="positive"):
            tfb.fused_blockwise_gram(U, U, dx=1.0, dy=1.0, block_x=0)


RICH = tfg.RICH_TERM_NAMES
NO_ADV = tuple(n for n in RICH if n not in ("ux", "uy"))
ADV = ("lap", "bih", "gradsq", "ux", "uy")


class TestK2Plain:
    @pytest.mark.parametrize("shape,seed,names,dx,dy", [
        ((8, 32, 128), 0, RICH, 0.5, 0.25),
        ((7, 16, 128), 1, RICH, 1.0, 1.0),  # T not a block multiple: pdx pads and corrects <one, one>
        ((8, 24, 40), 2, ADV, 0.5, 0.5),
        ((6, 20, 24), 3, NO_ADV, 0.5, 0.5),
    ])
    def test_matches_pdx_kernel_interpret(self, jx, shape, seed, names, dx, dy):
        U, Ut = _inputs(shape, seed)
        U = 0.3 * U  # KS-like amplitudes keep the f32 TPU sums meaningful
        want = jx.fg.fused_ks_gram_terms(
            jx.jnp.asarray(U), jx.jnp.asarray(Ut), dx=dx, dy=dy, names=names, block_t=4, interpret=True
        )
        got = tfg.fused_ks_gram_terms(torch.from_numpy(U), torch.from_numpy(Ut), dx=dx, dy=dy, names=names)
        assert got["G"].shape == (len(names), len(names)) and got["G"].dtype == torch.float64
        _compare(got, want, 3e-4, 2e-4, 1.0)
        if "one" in names:
            i = names.index("one")
            assert float(got["G"][i, i]) == float(np.prod(shape)) == float(got["sx"][i])

    def test_matches_pdx_reference_f64(self, jx):
        U, Ut = _inputs((6, 24, 40), 4, np.float64)
        want = jx.fg._terms_reference(jx.jnp.asarray(U), jx.jnp.asarray(Ut), 0.5, 0.25, RICH)
        got = tfg._terms_reference(torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.25, RICH)
        _compare(got, want, 1e-5, 1e-5)

    def test_cpu_tensor_takes_plain_version(self):
        U, Ut = _inputs((4, 16, 16), 5)
        before = total("fused_ks_gram_terms.launches")
        got = tfg.fused_ks_gram_terms(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5, names=ADV)
        want = tfg._terms_reference(torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.5, ADV)
        assert total("fused_ks_gram_terms.launches") == before
        for k in KEYS:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)

    def test_true_list_equals_k1(self):
        """The generic path on [lap, bih, gradsq] gives K1's statistics."""
        U, Ut = _inputs((5, 12, 14), 6)
        got = tfg.fused_ks_gram_terms(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5, names=("lap", "bih", "gradsq"))
        want = tfg.fused_ks_gram(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5)
        _compare(got, want, 1e-12, 1e-12)

    @pytest.mark.parametrize("names", [(), ("lap", "nope"), RICH + ("u",)])
    def test_rejects_bad_term_lists(self, names):
        U = torch.zeros((2, 8, 8))
        with pytest.raises(ValueError, match="names"):
            tfg.fused_ks_gram_terms(U, U, dx=1.0, dy=1.0, names=names)


class TestK4Plain:
    @pytest.mark.parametrize("shape,seed,names", [
        ((9, 32, 128), 0, RICH),
        ((8, 30, 126), 1, RICH),  # ragged on all three axes
        ((8, 30, 126), 2, NO_ADV),
        ((7, 24, 40), 3, ADV),
    ])
    def test_matches_pdx_kernel_interpret(self, jx, shape, seed, names):
        U, Ut = _inputs(shape, seed)
        U = 0.3 * U
        kw = dict(block_t=3, block_x=8, block_y=8)
        want = jx.fb.fused_blockwise_gram_terms(
            jx.jnp.asarray(U), jx.jnp.asarray(Ut), dx=0.5, dy=0.25, names=names, interpret=True, **kw
        )
        got = tfb.fused_blockwise_gram_terms(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.25, names=names, **kw)
        assert got["G"].dtype == torch.float64
        _compare(got, want, 3e-4, 2e-4, 1.0)
        if "one" in names:  # every block mean of `one` is 1, ragged tails included
            i = names.index("one")
            assert float(got["G"][i, i]) == float(got["n"]) == float(got["sx"][i])

    def test_matches_pdx_reference_f64(self, jx):
        U, Ut = _inputs((8, 30, 126), 4, np.float64)
        kw = dict(names=RICH, block_t=3, block_x=8, block_y=8)
        want = jx.fb.fused_blockwise_gram_terms_reference(jx.jnp.asarray(U), jx.jnp.asarray(Ut), 0.5, 0.25, **kw)
        got = tfb.fused_blockwise_gram_terms_reference(torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.25, **kw)
        _compare(got, want, 1e-5, 1e-5)

    def test_cpu_tensor_takes_plain_version(self):
        U, Ut = _inputs((7, 20, 20), 5)
        before = total("fused_blockwise_gram_terms.launches")
        got = tfb.fused_blockwise_gram_terms(torch.from_numpy(U), torch.from_numpy(Ut), dx=0.5, dy=0.5, names=NO_ADV, block_t=2)
        want = tfb.fused_blockwise_gram_terms_reference(
            torch.from_numpy(U), torch.from_numpy(Ut), 0.5, 0.5, names=NO_ADV, block_t=2, block_x=8, block_y=8
        )
        assert total("fused_blockwise_gram_terms.launches") == before
        for k in KEYS:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)

    def test_rejects_bad_input(self):
        U = torch.zeros((4, 8, 8))
        with pytest.raises(ValueError, match="positive"):
            tfb.fused_blockwise_gram_terms(U, U, dx=1.0, dy=1.0, names=RICH, block_y=0)
        with pytest.raises(ValueError, match="names"):
            tfb.fused_blockwise_gram_terms(U, U, dx=1.0, dy=1.0, names=("u3",))


def test_terms_stats_layout():
    """Row layout of K2/K4: Gram upper triangle row-major, b, sx, sy, syy."""
    p = 3
    row = torch.arange(p * (p + 1) // 2 + 2 * p + 2, dtype=torch.float64)
    st = tfg._terms_stats_from_row(row, p, 10.0)
    assert st["G"].tolist() == [[0, 1, 2], [1, 3, 4], [2, 4, 5]]
    assert st["b"].tolist() == [6, 7, 8] and st["sx"].tolist() == [9, 10, 11]
    assert (float(st["sy"]), float(st["syy"]), float(st["n"])) == (12.0, 13.0, 10.0)


@pytest.mark.parametrize("n,unit", [(100, 1), (100, 8), (30, 8), (126, 8), (16, 1), (5, 200)])
def test_tiles_cover_axis_in_whole_blocks(n, unit):
    tile, n_tiles = tfg._tile(n, unit)
    assert tile % unit == 0
    assert (n_tiles - 1) * tile < n <= n_tiles * tile
    assert tile <= max(tfg._MAX_TILE, unit)


@pytest.mark.parametrize("n", [100, 30, 126, 3, 7, 257, 40, 41])
def test_term_tiles_cover_axis(n):
    """K2's tiles: balanced, at most _TERMS_MAX_TILE points, covering the axis."""
    tile, n_tiles = tfg._tile(n, 1, tfg._TERMS_MAX_TILE)
    assert tile <= tfg._TERMS_MAX_TILE
    assert (n_tiles - 1) * tile < n <= n_tiles * tile


@pytest.mark.parametrize("H,W,bx,by", [
    (100, 100, 8, 8),  # the main path
    (30, 126, 8, 8),  # ragged on both axes
    (3, 5, 2, 3),  # frames smaller than the halo
    (130, 257, 16, 5),  # several tiles per axis
    (100, 70, 100, 1),  # one block spans the frame height
    (300, 300, 8, 8),
    (300, 300, 300, 300),  # too large for shared memory: the wrapper refuses it
])
def test_blockwise_plan_covers_frame(H, W, bx, by):
    """K4's launch shape: G a power of two <= 32, at most 256 threads, whole
    blocks, balanced tiles that cover the frame, the patch within its cap."""
    kbx, kby, G, ntx, nty = tfb._blockwise_plan(H, W, bx, by)
    nbx, nby = -(-H // bx), -(-W // by)
    assert G & (G - 1) == 0 and 1 <= G <= 32
    assert kbx * kby * G <= tfb._K4_THREADS
    assert (ntx - 1) * kbx < nbx <= ntx * kbx and (nty - 1) * kby < nby <= nty * kby
    if (kbx, kby) != (1, 1):
        assert (kbx * bx + 4) * (kby * by + 4) <= tfb._K4_MAX_PATCH
    if (H, W, bx, by) == (100, 100, 8, 8):  # the 13 x 13 blocks waste no tile row
        assert ntx * kbx * nty * kby <= 13 * 14


def test_kernel_inputs_round_like_torch():
    """K1-K4 take float64 as it is only when both inputs are float64; a mixed
    pair goes to float32, which is what the kernels' rounding on load gives.
    No wrapper casts on its own: the module has no other input helper."""
    assert not hasattr(tfg, "_f32") and not hasattr(tfb, "_f32")
    a64 = torch.from_numpy(np.random.default_rng(10).normal(size=(2, 3, 4)))
    a32 = a64.to(torch.float32)
    U, Ut, f64 = tfg._kernel_inputs(a64, a64)
    assert f64 == 1 and U.dtype == Ut.dtype == torch.float64
    U, Ut, f64 = tfg._kernel_inputs(a64, a32)
    assert f64 == 0 and torch.equal(U, a32) and torch.equal(Ut, a32)


BAND_FRAMES = [
    (100, 100, 8, 8),  # the main path
    (30, 126, 8, 8),  # ragged on both axes
    (3, 5, 2, 3),  # frames smaller than the halo
    (130, 257, 16, 5),  # several bands
    (100, 70, 100, 1),  # one block spans the frame height
    (300, 300, 8, 8),
]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("H,W,bx,by", BAND_FRAMES)
def test_blockwise_bands_are_whole_block_rows(H, W, bx, by, itemsize):
    """K3's bands: whole block-rows at full width that cover every row once,
    G a power of two <= 32, the CTA's threads and shared memory within the
    card's limits; float64 whose one block-row does not fit as it is takes
    float32's plan, rounded in flight."""
    route, kb, G, n_bands, threads = tfb._blockwise_route_plan(H, W, bx, by, itemsize, tfg._ROUTE_BULK)
    if (H, W, bx, by, itemsize) == (100, 70, 100, 1, 8):
        assert route == tfg._ROUTE_ROUNDED
    else:
        assert route == tfg._ROUTE_BULK
        assert (kb, G, n_bands, threads) == tfb._blockwise_band_plan(H, W, bx, by, itemsize)
    if route == tfg._ROUTE_ROUNDED:
        itemsize = 4  # what the stages hold
    nbx, nby = -(-H // bx), -(-W // by)
    assert G & (G - 1) == 0 and 1 <= G <= 32
    assert threads % 32 == 0 and kb * nby * G <= threads <= tfg._BAND_MAX_THREADS
    assert (n_bands - 1) * kb < nbx <= n_bands * kb  # no empty band, every block-row in one band
    rows = [r for b in range(n_bands) for r in range(b * kb * bx, min(H, (b + 1) * kb * bx))]
    assert rows == list(range(H))
    assert tfb._blockwise_smem_bytes(W, bx, by, kb, G, itemsize) <= tfg._SMEM_PER_CTA
    if (H, W, bx, by) == (100, 100, 8, 8):  # 13 block-rows in 5 bands of 3, two CTAs an SM: 15 slots
        assert (kb, n_bands) == (3, 5)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("H,W", [(100, 100), (30, 126), (3, 5), (130, 257), (600, 100), (1, 1), (2000, 500)])
def test_gram_bands_cover_rows(H, W, itemsize):
    """K1's bands: balanced, covering every row once, within shared memory;
    the whole frame where it fits."""
    TH, n_bands = tfg._band_rows(H, W, itemsize)
    assert (n_bands - 1) * TH < H <= n_bands * TH
    assert tfg._band_smem_bytes(TH, W, itemsize) <= tfg._SMEM_PER_CTA
    if n_bands > 1:  # one band fewer would not fit
        assert tfg._band_smem_bytes(-(-H // (n_bands - 1)), W, itemsize) > tfg._SMEM_PER_CTA
    if (H, W) == (100, 100):
        assert (TH, n_bands) == ((100, 1) if itemsize == 4 else (50, 2))


@pytest.mark.parametrize("W,itemsize,offset,bulk", [
    (100, 4, 0, 1),  # the main path, float32: 400-byte rows
    (100, 8, 0, 1),  # ... and float64
    (126, 4, 0, 0),  # 504-byte rows
    (30, 4, 0, 0),
    (7, 4, 0, 0),
    (126, 8, 0, 1),  # 1008-byte rows are aligned
    (7, 8, 0, 0),
    (100, 4, 4, 0),  # a view that starts 4 bytes into its storage
    (100, 8, 8, 0),
])
def test_band_route_by_shape_and_pointer(W, itemsize, offset, bulk):
    """Bulk copies need 16-byte aligned rows and pointers; anything else
    takes the element-wise route."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    n = 3 * 8 * W
    base = torch.zeros(2 * n + 8, dtype=dtype)
    U = base[offset // itemsize : offset // itemsize + n].view(3, 8, W)
    Ut = base[n + 4 : 2 * n + 4].view(3, 8, W)  # 16-byte aligned for both types
    assert base.data_ptr() % 16 == 0 and U.is_contiguous()
    assert tfg._band_route(W, itemsize, U.data_ptr(), Ut.data_ptr()) == bulk
    assert tfg._band_route(W, itemsize, Ut.data_ptr(), U.data_ptr()) == bulk


def test_band_smem_at_the_main_shape():
    """Planned shared memory at (100, 100), both input types, under the
    H100's 227 KB a CTA; the whole float64 frame would not fit."""
    for itemsize in (4, 8):
        TH, _ = tfg._band_rows(100, 100, itemsize)
        kb, G, *_ = tfb._blockwise_band_plan(100, 100, 8, 8, itemsize)
        assert tfg._band_smem_bytes(TH, 100, itemsize) <= 227 * 1024
        assert tfb._blockwise_smem_bytes(100, 8, 8, kb, G, itemsize) <= 227 * 1024
    assert tfg._band_smem_bytes(100, 100, 8) > 227 * 1024 >= tfg._band_smem_bytes(100, 100, 4)


def test_frame_too_wide_for_one_band_raises():
    """A band of one block-row (K3) or one row (K1) that does not fit shared
    memory is refused by name, before any launch."""
    with pytest.raises(ValueError, match=r"blocks \(300, 300\).*shared memory"):
        tfb._blockwise_band_plan(300, 300, 300, 300, 4)
    with pytest.raises(ValueError, match=r"blocks \(8, 1\).*threads"):
        tfb._blockwise_band_plan(16, 1000, 8, 1, 4)  # 1000 blocks across: more than a CTA's threads
    with pytest.raises(ValueError, match="shared memory"):
        tfg._band_rows(8, 5000, 4)
    for itemsize in (4, 8):  # float64 is refused only where float32 is
        with pytest.raises(ValueError, match=r"blocks \(300, 300\).*shared memory"):
            tfb._blockwise_route_plan(300, 300, 300, 300, itemsize, tfg._ROUTE_BULK)
        with pytest.raises(ValueError, match="shared memory"):
            tfg._gram_band_plan(8, 5000, itemsize, tfg._ROUTE_BULK)


@pytest.mark.parametrize("route", [tfg._ROUTE_BULK, tfg._ROUTE_ELEMENTWISE])
@pytest.mark.parametrize("H,W,bx,by", [
    (100, 70, 100, 1),  # one block spans the frame height
    (100, 100, 56, 8),  # the first block height past float64's two raw stages at this width
    (100, 100, 100, 100),  # one block a frame
    (8, 3000, 1, 8),  # very wide rows
])
def test_float64_too_large_for_raw_stages_is_rounded_in_flight(H, W, bx, by, route):
    """Every frame and block shape that K1 and K3 take in float32 they take
    in float64: where no band of raw float64 fits shared memory, the plan is
    float32's on the rounded route, whatever the pointers' alignment."""
    want = tfb._blockwise_route_plan(H, W, bx, by, 4, route)
    got = tfb._blockwise_route_plan(H, W, bx, by, 8, route)
    assert want[0] == route and got[0] == tfg._ROUTE_ROUNDED and got[1:] == want[1:]
    with pytest.raises(ValueError, match="shared memory"):
        tfb._blockwise_band_plan(H, W, bx, by, 8)
    if W == 3000:  # K1 too: not even one row of raw float64
        assert tfg._gram_band_plan(H, W, 4, route) == (route, 1, H)
        assert tfg._gram_band_plan(H, W, 8, route) == (tfg._ROUTE_ROUNDED, 1, H)
    else:  # K1 shrinks its bands instead
        assert tfg._gram_band_plan(H, W, 8, route)[0] == route


@pytest.mark.gpu
def test_planned_shared_memory_is_the_kernels_layout(cuda):
    """``_band_smem_bytes`` and ``_blockwise_smem_bytes`` restate
    ``band_layout`` of ``csrc/band_common.cuh``: the same bytes for many band
    heights, widths, group sizes and both staged types."""
    from pdx_torch.ops.kernels._build import library

    lib = library()
    for staged64 in (0, 1):
        itemsize = 8 if staged64 else 4
        for TH in (1, 2, 3, 8, 21, 24, 25, 50, 100, 333):
            for W in (1, 3, 7, 30, 100, 126, 257, 3000):
                assert tfg._band_smem_bytes(TH, W, itemsize) == lib.pdx_band_smem_bytes(TH, W, staged64)
        for W, bx, by, kb, G in [(100, 8, 8, 3, 8), (100, 8, 8, 7, 8), (126, 8, 8, 2, 8), (5, 2, 3, 2, 1),
                                 (257, 16, 5, 1, 8), (70, 100, 1, 1, 8), (300, 8, 8, 2, 8), (40, 4, 4, 5, 2)]:
            assert tfb._blockwise_smem_bytes(W, bx, by, kb, G, itemsize) == (
                lib.pdx_fused_blockwise_smem_bytes(W, bx, by, kb, G, staged64))


@pytest.mark.parametrize("n_items,n_bands,slots", [(1999, 1, 132), (667, 2, 132), (667, 3, 264), (3, 1, 132), (1, 5, 132)])
def test_long_chunks_cover_items(n_items, n_bands, slots):
    """Few, long CTAs: every item in one chunk, no empty chunk, at most one
    CTA a slot (unless there are more bands than slots)."""
    per, n_chunks = tfg._long_chunks(n_items, n_bands, slots)
    assert (n_chunks - 1) * per < n_items <= n_chunks * per
    assert n_chunks * n_bands <= max(slots, n_bands)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,blocks", [
    ((1999, 100, 100), (3, 8, 8)),  # the main path
    ((8, 30, 126), (3, 8, 8)),  # ragged on every axis
    ((7, 3, 5), (2, 2, 3)),  # frames smaller than the halo
    ((9, 130, 257), (4, 16, 5)),  # several tiles per axis
    ((5, 100, 70), (5, 100, 1)),  # one block spans the frame height
])
def test_kernels_match_plain_on_card(cuda, shape, blocks):
    """K1 and K3 against their plain versions on the card, each entry within
    1e-5 of its own scale."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, 7))
    k1 = tfg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5)
    _compare_scaled(k1, tfg.fused_ks_gram_reference(U, Ut, 0.5, 0.5), 1e-5)
    kw = dict(zip(("block_t", "block_x", "block_y"), blocks))
    k3 = tfb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw)
    _compare_scaled(k3, tfb.fused_blockwise_gram_reference(U, Ut, 0.5, 0.5, **kw), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,blocks,names", [
    ((1999, 100, 100), (3, 8, 8), RICH),  # the main path
    ((1999, 100, 100), (3, 8, 8), ADV),  # the main path with advection
    ((8, 30, 126), (3, 8, 8), NO_ADV),  # ragged on every axis
    ((8, 30, 126), (3, 8, 8), ADV),
    ((9, 130, 257), (4, 16, 5), RICH),  # several tiles per axis
    ((7, 3, 5), (2, 2, 3), ("u",)),  # p = 1, frames smaller than the halo
    ((5, 100, 70), (5, 100, 1), ("one", "u_lap")),  # one block spans the frame height
    ((5, 3, 7), (2, 2, 3), RICH),  # 21-point tile: not a multiple of the mma's 4 samples
    ((8, 30, 126), (3, 8, 8), RICH[:6]),  # p = 6 with `one`: X~ is exactly 8 columns
    ((8, 30, 126), (3, 8, 8), ("u", "u2", "lap", "bih", "gradsq", "u_lap")),  # p = 6 without `one`
    ((8, 30, 126), (3, 8, 8), RICH[1:8]),  # p = 7 without `one`: the first list with a second group
])
def test_term_kernels_match_plain_on_card(cuda, shape, blocks, names):
    """K2 and K4 against their plain versions on the card, each entry within
    1e-5 of its own scale; two launches give the same bits."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, 9))
    k2 = tfg.fused_ks_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names)
    _compare_scaled(k2, tfg._terms_reference(U, Ut, 0.5, 0.5, names), 1e-5)
    kw = dict(zip(("block_t", "block_x", "block_y"), blocks))
    k4 = tfb.fused_blockwise_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names, **kw)
    _compare_scaled(k4, tfb.fused_blockwise_gram_terms_reference(U, Ut, 0.5, 0.5, names=names, **kw), 1e-5)
    again2 = tfg.fused_ks_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names)
    again4 = tfb.fused_blockwise_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names, **kw)
    for k in KEYS:
        assert torch.equal(k2[k], again2[k]) and torch.equal(k4[k], again4[k]), k
    if "one" in names:
        i = names.index("one")
        assert float(k2["G"][i, i]) == float(np.prod(shape)) and float(k4["G"][i, i]) == float(k4["n"])


@pytest.mark.gpu
def test_wrappers_count_launches_and_refuse_oversized_blocks(cuda):
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs((4, 300, 300), 8))
    wrappers = ("fused_ks_gram", "fused_blockwise_gram", "fused_ks_gram_terms", "fused_blockwise_gram_terms")
    before = [total(f"{w}.launches") for w in wrappers]
    tfg.fused_ks_gram(U, Ut, dx=1.0, dy=1.0)
    tfb.fused_blockwise_gram(U, Ut, dx=1.0, dy=1.0)
    tfg.fused_ks_gram_terms(U, Ut, dx=1.0, dy=1.0)
    tfb.fused_blockwise_gram_terms(U, Ut, dx=1.0, dy=1.0, names=RICH)
    assert [total(f"{w}.launches") for w in wrappers] == [b + 1 for b in before]
    with pytest.raises(ValueError, match="shared memory"):
        tfb.fused_blockwise_gram(U, Ut, dx=1.0, dy=1.0, block_x=300, block_y=300)
    with pytest.raises(ValueError, match="shared memory"):
        tfb.fused_blockwise_gram_terms(U, Ut, dx=1.0, dy=1.0, names=RICH, block_x=300, block_y=300)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,blocks,names", [
    ((1999, 100, 100), (3, 8, 8), RICH),  # the main path's float64 input
    ((8, 30, 126), (3, 8, 8), ADV),
])
def test_term_kernels_take_float64(cuda, shape, blocks, names):
    """On float64 U and Ut, K2 and K4 round each value on load: the plain
    versions agree within 1e-5 of each entry's scale and the float32 input's
    launch gives the same bits."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, 11, np.float64))
    kw = dict(zip(("block_t", "block_x", "block_y"), blocks))
    k2 = tfg.fused_ks_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names)
    _compare_scaled(k2, tfg._terms_reference(U, Ut, 0.5, 0.5, names), 1e-5)
    k4 = tfb.fused_blockwise_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names, **kw)
    _compare_scaled(k4, tfb.fused_blockwise_gram_terms_reference(U, Ut, 0.5, 0.5, names=names, **kw), 1e-5)
    U32, Ut32 = U.to(torch.float32), Ut.to(torch.float32)
    k2_32 = tfg.fused_ks_gram_terms(U32, Ut32, dx=0.5, dy=0.5, names=names)
    k4_32 = tfb.fused_blockwise_gram_terms(U32, Ut32, dx=0.5, dy=0.5, names=names, **kw)
    for k in KEYS:
        assert torch.equal(k2[k], k2_32[k]) and torch.equal(k4[k], k4_32[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dx,dy", [(0.3, 0.7), (0.123, 1.7)])
def test_term_kernels_any_grid_spacing(cuda, dx, dy):
    """Spacings whose squares and doubles are not powers of two, so that the
    kernels' division by a constant is not a plain multiplication: K2 and K4
    agree with the plain versions' division within 1e-5 of each entry's scale."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs((8, 30, 126), 12))
    k2 = tfg.fused_ks_gram_terms(U, Ut, dx=dx, dy=dy, names=RICH)
    _compare_scaled(k2, tfg._terms_reference(U, Ut, dx, dy, RICH), 1e-5)
    kw = dict(block_t=3, block_x=8, block_y=8)
    k4 = tfb.fused_blockwise_gram_terms(U, Ut, dx=dx, dy=dy, names=RICH, **kw)
    _compare_scaled(k4, tfb.fused_blockwise_gram_terms_reference(U, Ut, dx, dy, names=RICH, **kw), 1e-5)


TRUE_CASES = [
    ((1999, 100, 100), (3, 8, 8)),  # the main path
    ((8, 30, 126), (3, 8, 8)),  # ragged on every axis
    ((5, 3, 7), (2, 2, 3)),  # frames smaller than the halo
    ((1, 100, 100), (3, 8, 8)),  # fewer frames than stages, bt > T
    ((2, 100, 100), (3, 8, 8)),
    ((3, 600, 100), (2, 8, 8)),  # a frame taller than one band
    ((5, 100, 70), (5, 100, 1)),  # one block spans the frame height: float64 is rounded in flight
    ((4, 8, 3000), (2, 1, 8)),  # rows too wide for one row (K1) or one block-row (K3) of raw float64
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,blocks", TRUE_CASES)
def test_true_kernels_match_plain_on_card(cuda, shape, blocks, dtype):
    """K1 and K3 on float32 and on float64 input (rounded on load, no cast
    before the kernel) against their plain versions, each entry within 1e-5
    of its own scale; two launches give the same bits."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, 13, dtype))
    kw = dict(zip(("block_t", "block_x", "block_y"), blocks))
    k1 = tfg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5)
    _compare_scaled(k1, tfg.fused_ks_gram_reference(U, Ut, 0.5, 0.5), 1e-5)
    k3 = tfb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw)
    _compare_scaled(k3, tfb.fused_blockwise_gram_reference(U, Ut, 0.5, 0.5, **kw), 1e-5)
    again1 = tfg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5)
    again3 = tfb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw)
    for k in KEYS:
        assert torch.equal(k1[k], again1[k]) and torch.equal(k3[k], again3[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_true_kernels_take_an_offset_view(cuda, dtype):
    """A contiguous view that starts one element into its storage is not
    16-byte aligned: K1 and K3 take the element-wise route and agree with
    the plain versions and with the aligned copy's bulk route."""
    shape = (7, 40, 100)
    U0, Ut0 = _inputs(shape, 14, dtype)
    n = int(np.prod(shape))
    base = torch.zeros(n + 1, dtype=torch.from_numpy(U0).dtype, device=cuda)
    base[1:] = torch.from_numpy(U0).to(cuda).reshape(-1)
    U, Ut = base[1:].view(shape), torch.from_numpy(Ut0).to(cuda)
    assert U.is_contiguous() and U.data_ptr() % 16 != 0
    assert tfg._band_route(100, U.element_size(), U.data_ptr(), Ut.data_ptr()) == 0
    assert tfg._band_route(100, U.element_size(), U.clone().data_ptr(), Ut.data_ptr()) == 1
    kw = dict(block_t=3, block_x=8, block_y=8)
    k1 = tfg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5)
    k3 = tfb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw)
    _compare_scaled(k1, tfg.fused_ks_gram_reference(U, Ut, 0.5, 0.5), 1e-5)
    _compare_scaled(k3, tfb.fused_blockwise_gram_reference(U, Ut, 0.5, 0.5, **kw), 1e-5)
    bulk1 = tfg.fused_ks_gram(U.clone(), Ut, dx=0.5, dy=0.5)
    bulk3 = tfb.fused_blockwise_gram(U.clone(), Ut, dx=0.5, dy=0.5, **kw)
    for k in KEYS:  # the routes differ in how a frame arrives, not in any sum
        assert torch.equal(k1[k], bulk1[k]) and torch.equal(k3[k], bulk3[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dx,dy", [(0.3, 0.7), (0.123, 1.7)])
def test_true_kernels_any_grid_spacing(cuda, dx, dy):
    """Spacings whose squares and doubles are not powers of two: K1's and
    K3's division by a constant gives the statistics of bitwise-equal fields,
    so they equal K2's and K4's on the same term list to the last bits a
    different summation order leaves, and the plain versions within 1e-5 of
    each entry's scale."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs((8, 30, 126), 12))
    true = ("lap", "bih", "gradsq")
    kw = dict(block_t=3, block_x=8, block_y=8)
    k1 = tfg.fused_ks_gram(U, Ut, dx=dx, dy=dy)
    _compare_scaled(k1, tfg.fused_ks_gram_reference(U, Ut, dx, dy), 1e-5)
    _compare_scaled(k1, tfg.fused_ks_gram_terms(U, Ut, dx=dx, dy=dy, names=true), 1e-12)
    k3 = tfb.fused_blockwise_gram(U, Ut, dx=dx, dy=dy, **kw)
    _compare_scaled(k3, tfb.fused_blockwise_gram_reference(U, Ut, dx, dy, **kw), 1e-5)
    _compare_scaled(k3, tfb.fused_blockwise_gram_terms(U, Ut, dx=dx, dy=dy, names=true, **kw), 1e-12)


@pytest.mark.gpu
def test_true_kernels_round_float64_like_a_cast(cuda):
    """On float64 input K1 and K3 give the bits of the same launch shape on
    the float32-rounded copy when both take one plan (a frame small enough
    for one band in either type)."""
    U, Ut = (torch.from_numpy(a).to(cuda) for a in _inputs((9, 24, 40), 15, np.float64))
    assert tfg._band_rows(24, 40, 8) == tfg._band_rows(24, 40, 4)
    assert tfb._blockwise_band_plan(24, 40, 8, 8, 8) == tfb._blockwise_band_plan(24, 40, 8, 8, 4)
    kw = dict(block_t=3, block_x=8, block_y=8)
    U32, Ut32 = U.to(torch.float32), Ut.to(torch.float32)
    k1, k1_32 = tfg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5), tfg.fused_ks_gram(U32, Ut32, dx=0.5, dy=0.5)
    k3 = tfb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw)
    k3_32 = tfb.fused_blockwise_gram(U32, Ut32, dx=0.5, dy=0.5, **kw)
    for k in KEYS:
        assert torch.equal(k1[k], k1_32[k]) and torch.equal(k3[k], k3_32[k]), k
