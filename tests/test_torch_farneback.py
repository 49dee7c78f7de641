"""pdx_torch.register.farneback against pdx.register.farneback.

Tolerances, and why:

* expansion, blur, composition and flows on float64 frames (``pdx``
  computes them in float64 too): the same products summed in another order
  (window products and matrices where ``pdx`` adds shifted copies), so
  1e-12 of the largest value for the linear stages and 1e-9 px for the
  flows, through 5 levels x 5 iterations and 2 refine passes of per-pixel
  2x2 solves (measured ~1e-14 px);
* registered stacks: the chain and the pair flows compute the flow in
  float32 when the stack is float64, as ``pdx`` does. Float32 rounding
  (eps 1.2e-7) in another summation order moves the flows by ~1e-6 px,
  and the registered frames (values in [0, 1], gradients ~0.05 a pixel)
  by ~3e-7 (measured); the limit is 5e-6 absolute, ~40 float32 ulps of 1.

``pdx`` runs with its CPU defaults (per-step chain, shifted-add passes,
taps sampler). Frames are smooth random fields at ``tests/test_register.py``'s
sizes, jittered by sub-pixel shifts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

from pdx.register import farneback as jfb
from pdx_torch.interop import flows_from_numpy
from pdx_torch.ops.kernels import flow_windows
from pdx_torch.register import farneback as tfb
from pdx_torch.utils.profiling import total

FRAME_TOL = 5e-6
FLOW_TOL = 1e-9


def smooth_field(n=64, sigma=4.0, seed=0):
    rng = np.random.default_rng(seed)
    f = gaussian_filter(rng.normal(size=(n, n)), sigma, mode="wrap")
    return (f - f.min()) / (f.max() - f.min())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def jitter():
    """Five 128 x 128 frames: a field and four jittered copies."""
    base = smooth_field(n=128, sigma=8, seed=7)
    rng = np.random.default_rng(1)
    return np.stack([base] + [ndshift(base, rng.uniform(-1.5, 1.5, 2), mode="reflect") for _ in range(4)])


def test_make_invG():
    g, x, invG = flow_windows._make_invG(3, 1.5)
    jg, jx, jinv = jfb._make_invG(3, 1.5, np.float64)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_allclose(invG, np.asarray(jinv), rtol=1e-15, atol=0)


@pytest.mark.parametrize("n,sigma", [(3, 1.5), (2, 1.2)])
def test_poly_exp(n, sigma):
    f = smooth_field(n=40, sigma=3, seed=2)[:, :33]
    g, x, invG = jfb._make_invG(n, sigma, np.float64)
    want = np.stack([np.asarray(a) for a in jfb._poly_exp(jnp.asarray(f), g, x, invG, n)])  # c bx by axx ayy axy
    got = flow_windows.poly_expansion_reference(_t(f), 2 * n + 1, sigma)  # axx ayy axy bx by c
    _close(got, want[[3, 4, 5, 1, 2, 0]], 1e-12 * np.abs(want).max())


@pytest.mark.parametrize("gaussian", [True, False])
def test_blur(gaussian):
    f = np.random.default_rng(3).normal(size=(5, 30, 23))
    want = np.asarray(jfb._blur(jnp.asarray(f), 25, 7.5, gaussian))
    _close(flow_windows.window_blur(_t(f), 25, 7.5, gaussian), want, 1e-12 * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    base = smooth_field(n=64, sigma=5, seed=7)
    return base, ndshift(base, (1.3, -0.8), mode="reflect")


def test_farneback_flow_float64(pair):
    """The default parameters (5 levels, winsize 25, refine 2) on float64 frames."""
    a, b = pair
    jx, jy = jfb.farneback_flow(jnp.asarray(a), jnp.asarray(b))
    tx, ty = tfb.farneback_flow(_t(a), _t(b))
    _close(tx, jx, FLOW_TOL)
    _close(ty, jy, FLOW_TOL)
    m = slice(16, -16)  # and it recovers the shift, as pdx's own test asks
    assert 0.9 < float(np.median(tx.numpy()[m, m])) / 1.3 < 1.1
    assert 0.9 < float(np.median(ty.numpy()[m, m])) / -0.8 < 1.1


def test_batched_flow_matches_single(pair):
    """Leading axes are independent pairs: the batch gives each pair's flow."""
    a, b = pair
    kw = dict(levels=2, winsize=11, iterations=3, poly_n=5, poly_sigma=1.2)
    A, B = _t(np.stack([a, b, a])), _t(np.stack([b, a, a]))
    bx, by = tfb.farneback_flow(A, B, **kw)
    for i in range(3):
        sx, sy = tfb.farneback_flow(A[i], B[i], **kw)
        np.testing.assert_allclose(bx[i].numpy(), sx.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(by[i].numpy(), sy.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("flow_ds", [1, 2])
def test_chain_matches_pdx(jitter, flow_ds):
    """pdx's per-step chain with the flow at full (1) and half (2)
    resolution, called with the same flow_ds on both sides."""
    want = np.asarray(jfb.farneback_register_sequence(jnp.asarray(jitter), flow_ds=flow_ds))
    got = tfb.farneback_register_sequence(_t(jitter), flow_ds=flow_ds)
    assert got.dtype == torch.float64
    _close(got, want, FRAME_TOL)
    resid = lambda out: np.sqrt(np.mean((np.asarray(out[1:]) - jitter[0]) ** 2))  # noqa: E731
    assert resid(got) < 0.4 * resid(jitter)


def test_reference_compat_sign(jitter):
    """warp_sign=-1 (the reference's x - flow map) matches pdx and leaves
    more residual motion than the fixed sign."""
    want = np.asarray(jfb.farneback_register_sequence(jnp.asarray(jitter), flow_ds=1, warp_sign=-1.0))
    got = tfb.farneback_register_sequence(_t(jitter), flow_ds=1, warp_sign=-1.0)
    _close(got, want, FRAME_TOL)
    fixed = tfb.farneback_register_sequence(_t(jitter), flow_ds=1)
    resid = lambda out: float(torch.sqrt(torch.mean((out[1:] - out[:1]) ** 2)))  # noqa: E731
    assert resid(fixed) < resid(got)


GRAPH_COUNTS = ("farneback.graph_captures", "farneback.graph_replays", "farneback.flows", "farneback.iterations")


def _totals():
    return np.array([total(n) for n in GRAPH_COUNTS])


def _eager_chain(U, **step):
    """The chain as a loop of eager steps."""
    out = torch.empty_like(U)
    out[0] = U[0]
    for i in range(1, U.shape[0]):
        out[i] = tfb._chain_step(out[i - 1], U[i], **step)
    return out


def test_chain_stays_eager_on_the_cpu(jitter):
    """On the CPU no step is captured or replayed: the chain is the loop of
    eager steps, bit for bit, and counts its flows."""
    U = _t(jitter[:4, :64, :64])
    t0 = _totals()
    got = tfb.farneback_register_sequence(U, flow_ds=1)
    t1 = _totals()
    assert list(t1[:3] - t0[:3]) == [0, 0, 3]
    want = _eager_chain(U, flow_ds=1, warp_sign=1.0, ksize=11, sigma=2.0, kw={"refine": 1})
    assert list(_totals()[2:] - t1[2:]) == list(t1[2:] - t0[2:])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _jittered_stack(T, H, W, seed):
    rng = np.random.default_rng(seed)
    f = gaussian_filter(rng.normal(size=(H, W)), 6, mode="wrap")
    f = (f - f.min()) / (f.max() - f.min())
    return np.stack([f] + [ndshift(f, rng.uniform(-1.5, 1.5, 2), mode="reflect") for _ in range(T - 1)])


@pytest.mark.gpu
def test_chain_graph_replays_the_eager_step_bitwise_on_the_card():
    """On the card the first step of a new frame shape or warp sign runs
    eagerly and is captured, the others replay the graph: bitwise the loop
    of eager steps, with the same flow and iteration counts; a second stack
    of the same shape replays with no new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tfb._STEP_GRAPHS.clear()

    def run(seed, sign, H=128, W=160):
        U = torch.from_numpy(_jittered_stack(6, H, W, seed)).cuda()
        t0 = _totals()
        got = tfb.farneback_register_sequence(U, flow_ds=2, warp_sign=sign)
        t1 = _totals()
        want = _eager_chain(U, flow_ds=2, warp_sign=sign, ksize=11, sigma=2.0, kw={"refine": 1})
        t2 = _totals()
        gap = float((got - want).abs().max())
        assert torch.equal(got, want), (seed, sign, H, W, gap)
        assert list(t1[2:] - t0[2:]) == list(t2[2:] - t1[2:]) and t1[2] - t0[2] == 5
        return list(t1[:2] - t0[:2])  # (captures, replays)

    for sign in (1.0, -1.0):
        assert run(11, sign) == [1, 4]  # a new key: the first step eager, then captured
        assert run(12, sign) == [0, 5]  # a second stack of that shape replays every step
    assert run(13, 1.0, W=192) == [1, 4]  # another shape captures once more
    assert len(tfb._STEP_GRAPHS) == 3


@pytest.mark.parametrize("to_first", [False, True])
def test_compose_matches_pdx(jitter, to_first):
    want = np.asarray(jfb.farneback_register_sequence_compose(jnp.asarray(jitter), to_first=to_first))
    got = tfb.farneback_register_sequence_compose(_t(jitter), to_first=to_first)
    _close(got, want, FRAME_TOL)


@pytest.mark.parametrize("mode,compat", [("auto", False), ("chain", False), ("compose", False), ("to_first", False),
                                         ("chain", True)])
def test_dispatch_routes(jitter, mode, compat):
    """register_sequence_dispatch resolves modes as pdx does; auto is the chain."""
    U = _t(jitter[:3, :64, :64])
    got = tfb.register_sequence_dispatch(U, mode=mode, refine=1, reference_compat_warp=compat)
    if compat:
        want = tfb.farneback_register_sequence(U, warp_sign=-1.0, refine=1)
    elif mode in ("auto", "chain"):
        want = tfb.farneback_register_sequence(U, refine=1)
    else:
        want = tfb.farneback_register_sequence_compose(U, to_first=(mode == "to_first"), refine=1)
    assert tfb.auto_register_mode() == jfb.auto_register_mode() == "chain"
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_compose_flow_chain(jitter):
    """pdx's own pair flows, carried across, composed by both packages."""
    kw = dict(levels=2, winsize=11, iterations=3, poly_n=5, poly_sigma=1.2)
    jx, jy = jfb.farneback_flow_pairs(jnp.asarray(jitter[:, :40, :36]), **kw)
    fx, fy = flows_from_numpy(jx, jy)
    for batched in (False, True):
        a, b = (torch.stack([fx, 0.5 * fx]), torch.stack([fy, -fy])) if batched else (fx, fy)
        wx, wy = jfb.compose_flow_chain(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), batched=batched)
        gx, gy = tfb.compose_flow_chain(a, b, batched=batched)
        _close(gx, wx, 1e-12)
        _close(gy, wy, 1e-12)


def test_batched_pair_flows_chunks():
    """pdx's batched pair flows, and the port's chunks equal one batch."""
    base = smooth_field(n=48, sigma=4, seed=21)
    rng = np.random.default_rng(22)
    A = np.stack([ndshift(base, rng.uniform(-1, 1, 2), mode="reflect") for _ in range(5)])
    B = np.stack([ndshift(base, rng.uniform(-1, 1, 2), mode="reflect") for _ in range(5)])
    fs = (("gaussian_win", False), ("iterations", 3), ("levels", 2), ("poly_n", 5), ("poly_sigma", 1.2), ("winsize", 11))
    jx, jy = jfb.batched_pair_flows(jnp.asarray(A), jnp.asarray(B), flow_static=fs)
    one = tfb.batched_pair_flows(_t(A), _t(B), flow_static=fs)
    _close(one[0], jx, FLOW_TOL)
    _close(one[1], jy, FLOW_TOL)
    chunked = tfb.batched_pair_flows(_t(A), _t(B), flow_static=dict(fs), chunk_elems=2 * 48 * 48)  # chunks 2, 2, 1
    for c, o in zip(chunked, one):
        np.testing.assert_allclose(c.numpy(), o.numpy(), rtol=0, atol=1e-12)
    pairs = tfb.farneback_flow_pairs(_t(A), **dict(fs))
    wx, _wy = jfb.farneback_flow_pairs(jnp.asarray(A), **dict(fs))
    _close(pairs[0], wx, FLOW_TOL)


def test_empty_pair_list_returns_empty_flows():
    Z = torch.zeros((0, 32, 32))
    fx, fy = tfb.batched_pair_flows(Z, Z, flow_static=(("levels", 2),))
    assert fx.shape == (0, 32, 32) and fy.shape == (0, 32, 32)
    fx, _ = tfb.farneback_flow_pairs(torch.zeros((1, 32, 32)), levels=2)
    assert fx.shape == (0, 32, 32)


def test_chain_flow_ds_policy():
    """2 on the card, 1 on the CPU, an explicit value wins; halved until the
    flow grid is >= 64 px (pdx's clamp)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tfb._chain_flow_ds(None, 512, 640, cpu) == jfb._chain_flow_ds(None, 512, 640) == 1
    assert tfb._chain_flow_ds(None, 512, 640, cuda) == 2
    assert tfb._chain_flow_ds(None, 96, 96, cuda) == 1
    for ds, H, W in ((2, 512, 640), (2, 96, 96), (4, 512, 640), (4, 256, 320), (4, 200, 320)):
        assert tfb._chain_flow_ds(ds, H, W, cpu) == tfb._chain_flow_ds(ds, H, W, cuda) == jfb._chain_flow_ds(ds, H, W)
