"""The Farnebäck flow's windowed passes (``ops/kernels/flow_windows``,
``csrc/farneback.cu``) against their plain versions.

On the CPU each wrapper is its plain version (the ``*_reference``
functions), bit for bit, and launches no kernel; so ``farneback_flow`` and
``batched_pair_flows`` are the plain passes. On the card (``gpu``; this
file imports no JAX, so ``--noconftest -m gpu`` runs it there) each kernel
is held to its plain version at the cells' shapes, and so is the whole
flow. Tolerances, against the largest magnitude of the plain result:
float64 1e-12, float32 1e-5. The expansions sum in the plain passes' order
(on the H100 they come out bitwise the plain ones); the blur and the
update sum along the rows first, ~K ulp from the plain products a pass,
and the update divides by a 2x2 determinant that cancels where the
window's structure is weak; a flow carries that through its levels'
iterations, which a contraction damps. float64 keeps four digits of room
over the rounding of ~1e-16 a sum; float32, whose rounding is ~1e-7, keeps
two. On frames of uniform noise a float32 flow's windows are so weak that
the plain flow itself moves by ~1e-5 to 1e-4 between the card and the CPU
(PERF.md), so the float32 flows are held on textured frames and on the
cells' own frames (the registration chains, :data:`CELL_CHAIN_TOL`).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pdx_torch.ops.filters import symmetric_windows
from pdx_torch.ops.kernels import flow_windows
from pdx_torch.register import farneback as tfb
from torch_card import FLOW_KERNELS, assert_flow_kernels, cuda, launches

SWEEP = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2, gaussian_win=False)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _frames(B, H, W, seed, dtype=torch.float64, device="cpu"):
    """B pairs of smooth textured frames, the second moved by a sub-pixel
    drift and a sine warp, values in [0, 1]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    a, b = [], []
    for _ in range(B):
        k = rng.uniform(0.03, 0.12, size=(4, 2))
        p = rng.uniform(0, 2 * np.pi, size=4)
        dy, dx = rng.uniform(-1.5, 1.5, size=2)

        def img(yy, xx):
            return sum(np.sin(k[i, 0] * yy + k[i, 1] * xx + p[i]) for i in range(4)) / 8 + 0.5

        a.append(img(y, x))
        b.append(img(y - dy - 0.5 * np.sin(x / 37), x - dx))
    t = lambda v: torch.tensor(np.stack(v), dtype=dtype, device=device)  # noqa: E731
    return t(a), t(b)


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


ITERATIONS = "farneback.iterations"  # the flows' iterations, counted on every device


def _plain(monkeypatch):
    """Route farneback's passes to the plain references on every device."""
    ref = flow_windows
    monkeypatch.setattr(ref, "poly_expansion", lambda f, n, s: ref.poly_expansion_reference(f, n, s)[:5])
    monkeypatch.setattr(ref, "warped_poly_expansion",
                        lambda f, flow, n, s: ref.warped_poly_expansion_reference(f, flow, n, s)[:5])
    monkeypatch.setattr(ref, "flow_update", ref.flow_update_reference)
    monkeypatch.setattr(ref, "window_blur", ref.window_blur_reference)


# --- the CPU: the plain path --------------------------------------------------


@pytest.mark.parametrize("kw", [SWEEP, dict(levels=2, iterations=2, refine=1)], ids=["sweep", "defaults"])
def test_cpu_flows_are_the_plain_path_bitwise_and_count_no_fused_iterations(monkeypatch, kw):
    a, b = _frames(3, 24, 40, seed=1)
    with launches(("flow_update",), (ITERATIONS,)) as moved:
        fx, fy = tfb.batched_pair_flows(a, b, flow_static=kw, chunk_elems=2 * 24 * 40)
        one = tfb.farneback_flow(a[0], b[0], **kw)
    assert moved["flow_update"] == 0 and moved[ITERATIONS] > 0
    with monkeypatch.context() as m:
        _plain(m)
        px, py = tfb.batched_pair_flows(a, b, flow_static=kw, chunk_elems=2 * 24 * 40)
        pone = tfb.farneback_flow(a[0], b[0], **kw)
    assert torch.equal(fx, px) and torch.equal(fy, py)
    assert torch.equal(one[0], pone[0]) and torch.equal(one[1], pone[1])


def test_the_expansion_taps_are_the_plain_operators_in_the_plain_order():
    """The expansion kernel's taps, applied as the kernel applies them (the
    three kernels down H, then the operator along W), give the plain
    expansion's first five planes."""
    f = _frames(2, 9, 11, seed=3)[0]
    for n, sigma in ((2, 1.2), (3, 1.5), (12, 4.0)):
        K = 2 * n + 1
        taps = flow_windows._poly_exp_taps(n, sigma, torch.float64, torch.device("cpu"))
        cols, M = taps[: 3 * K].view(3, K), taps[3 * K :].view(3, K, 5)
        wins_h = symmetric_windows(f, K, 1)  # (B, W, H, K)
        Hc = torch.einsum("bwht,ct->cbhw", wins_h, cols)
        wins_w = symmetric_windows(Hc, K, 3)  # (3, B, H, W, K)
        got = torch.einsum("cbhws,csk->kbhw", wins_w, M)
        assert _gap(got, flow_windows.poly_expansion_reference(f, K, sigma)[:5]) < 1e-13, (n, sigma)


def _passes(a, b, flow, poly_n, sigma, winsize, gaussian):
    """{wrapper: (its call, its plain version's call)} on frames (a, b) and
    a flow: the expansions' plain versions sliced to the five planes the
    wrappers return, the update fed the plain expansions."""
    ref = flow_windows
    p1, p2 = ref.poly_expansion_reference(a, poly_n, sigma), ref.poly_expansion_reference(b, poly_n, sigma)
    return {
        "poly_expansion": (lambda: ref.poly_expansion(a, poly_n, sigma), lambda: p1[:5]),
        "warped_poly_expansion": (lambda: ref.warped_poly_expansion(b, flow, poly_n, sigma),
                                  lambda: ref.warped_poly_expansion_reference(b, flow, poly_n, sigma)[:5]),
        "flow_update": (lambda: ref.flow_update(p1, p2, flow, winsize, gaussian),
                        lambda: ref.flow_update_reference(p1, p2, flow, winsize, gaussian)),
        "window_blur": (lambda: ref.window_blur(flow, winsize, 0.3 * winsize, gaussian),
                        lambda: ref.window_blur_reference(flow, winsize, 0.3 * winsize, gaussian)),
    }


@pytest.mark.parametrize("name", ["poly_expansion", "warped_poly_expansion", "flow_update", "window_blur"])
def test_cpu_tensor_takes_plain_version(name):
    """On a CPU tensor each wrapper returns its plain version's bits and
    launches no kernel."""
    a, b = _frames(2, 20, 28, seed=4)
    flow = 1.5 * torch.randn((2,) + a.shape, dtype=a.dtype, generator=torch.Generator().manual_seed(4))
    call, plain = _passes(a, b, flow, 5, 1.2, 15, False)[name]
    with launches((name,)) as moved:
        got = call()
    assert moved[name] == 0
    assert torch.equal(got, plain())


# --- the card -----------------------------------------------------------------


def _kernels_vs_plain(a, b, poly_n, sigma, winsize, gaussian):
    """Each kernel against its plain version on the card, on (a, b) and a
    flow of a few pixels; returns the largest gap of the four."""
    g = torch.Generator(device=a.device).manual_seed(5)
    flow = 2.0 * torch.randn((2,) + a.shape, dtype=a.dtype, device=a.device, generator=g)
    gaps = [_gap(call(), plain()) for call, plain in _passes(a, b, flow, poly_n, sigma, winsize, gaussian).values()]
    want = flow_windows.poly_expansion_reference(b, poly_n, sigma)[:5]
    return max(gaps + [_gap(flow_windows.poly_expansion(b, poly_n, sigma), want)])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sweep_6x1024x1280", "transport_50x256x320"])
def test_float64_pair_flows_match_the_plain_path_on_the_card(cuda, monkeypatch, cell):
    """The quality sweep's chunk and ``transport``'s batch: each kernel, then
    the whole batched flow, against the plain passes on the card."""
    B, H, W = (6, 1024, 1280) if cell.startswith("sweep") else (50, 256, 320)
    a, b = _frames(B, H, W, seed=B, device=cuda)
    assert _kernels_vs_plain(a, b, 5, 1.2, 15, False) < 1e-12
    with launches(("flow_update",), (ITERATIONS,)) as moved:
        fx, fy = tfb.batched_pair_flows(a, b, flow_static=SWEEP)
    with monkeypatch.context() as m:
        _plain(m)
        px, py = tfb.batched_pair_flows(a, b, flow_static=SWEEP)
    gap = max(_gap(fx, px), _gap(fy, py))
    assert gap < TOL[torch.float64], gap
    assert moved["flow_update"] == moved[ITERATIONS] > 0  # every iteration launched the kernel


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["patch_512x640", "study_1024x1280"])
def test_float32_chain_step_matches_the_plain_step_eager_and_replayed(cuda, monkeypatch, cell):
    """One chain step of the patch cell (512x640 frames, flow at 256x320)
    or of the study (1024x1280 frames, flow at 512x640), the defaults, on
    the kernels, eager and replayed as a graph, against the plain step;
    replays count their update launches."""
    H, W = (512, 640) if cell.startswith("patch") else (1024, 1280)
    a, b = _frames(1, H, W, seed=7, dtype=torch.float32, device=cuda)
    a, b = a[0], b[0]
    kw = dict(flow_ds=2, warp_sign=1.0, ksize=11, sigma=2.0, kw={"refine": 1})
    assert _kernels_vs_plain(a[::2, ::2].contiguous(), b[::2, ::2].contiguous(), 7, 1.5, 25, True) < 1e-5
    eager = tfb._chain_step(a, b, **kw)
    step = lambda r, c: tfb._chain_step(r, c, **kw)  # noqa: E731
    graph = tfb.StepGraph(step, a, b)
    with launches(("flow_update",), (ITERATIONS,)) as moved:
        replayed = graph.replay(a, b).clone()
    assert torch.equal(replayed, eager)
    assert moved["flow_update"] == moved[ITERATIONS] == 5 * 5 + 2
    with monkeypatch.context() as m:
        _plain(m)
        plain = tfb._chain_step(a, b, **kw)
    assert _gap(eager, plain) < TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((2, 1024, 1280), torch.float64), ((2, 512, 640), torch.float32),
                                         ((2, 1024, 1280), torch.float32)],
                         ids=["dis_chain_f64", "patch_chain_f32", "study_chain_f32"])
def test_the_flow_smoothing_matches_the_plain_blur_on_the_card(cuda, shape, dtype):
    """The chains' 11-tap, sigma-2 smoothing of a stacked flow: the DIS
    chain's float64 flow at full size and the Farnebäck chains' float32
    flows at the frames' size."""
    f = torch.randn(shape, dtype=dtype, device=cuda, generator=torch.Generator(device=cuda).manual_seed(6))
    got, want = flow_windows.window_blur(f, 11, 2.0, True), flow_windows.window_blur_reference(f, 11, 2.0, True)
    assert _gap(got, want) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_border_folds_again_where_the_window_outnumbers_the_rows(cuda, dtype):
    """An 8-pixel pyramid level with K = 25 (window and expansion): the
    symmetric border folds twice."""
    a, b = _frames(3, 8, 10, seed=9, dtype=dtype, device=cuda)
    assert _kernels_vs_plain(a, b, 25, 4.0, 25, True) < TOL[dtype]
    assert _kernels_vs_plain(a[:, :, :8].contiguous(), b[:, :, :8].contiguous(), 7, 1.5, 25, False) < TOL[dtype]


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    f = torch.zeros((2, 16, 16), dtype=torch.float64, device=cuda)
    flow = torch.zeros((2,) + f.shape, dtype=f.dtype, device=cuda)
    with pytest.raises(TypeError):
        flow_windows.window_blur(f.half(), 5, 1.5, True)
    with pytest.raises(TypeError):
        flow_windows.warped_poly_expansion(f, flow.float(), 5, 1.2)  # tensors of two types
    with pytest.raises(ValueError, match="tensors on"):
        flow_windows.warped_poly_expansion(f, flow.cpu(), 5, 1.2)
    with pytest.raises(ValueError, match="H, W"):
        flow_windows.poly_expansion(f[0, 0], 5, 1.2)
    exp = torch.zeros((5, 2, 16, 16), dtype=f.dtype, device=cuda)
    with pytest.raises(ValueError, match="flow"):
        flow_windows.flow_update(exp, exp, torch.zeros((2, 2, 16, 8), dtype=f.dtype, device=cuda), 5, True)


@pytest.mark.gpu
def test_every_flow_on_the_card_counts_its_iterations_fused(cuda):
    """A sweep-sized flow, a default flow and a chain: one update launch an
    iteration, and each wrapper counts its launches."""
    a, b = _frames(2, 64, 80, seed=11, device=cuda)
    with launches(FLOW_KERNELS, (ITERATIONS,)) as moved:
        tfb.farneback_flow(a, b, **SWEEP)
        tfb.farneback_flow(a[0], b[0])
        tfb.farneback_register_sequence(torch.cat([a, b]), flow_ds=1)
    assert moved["flow_update"] == moved[ITERATIONS] > 0  # one launch an iteration
    assert_flow_kernels(moved)


# registered frames (values in [0, 1]) of the chain on the kernels against the plain chain on the card, on the
# cells' own frames: at most 1.0e-7 (patch) and 6.2e-8 (study) over 8 seeds each on the H100 (PERF.md), with
# ten times room; the float32 rounding of a frame is ~6e-8
CELL_CHAIN_TOL = 1e-6


def _cell_chain_gap(cell: str, seed: int, card, monkeypatch) -> float:
    """The registration chain of a cell's preprocessed frames (6 frames of
    the cells' generator, ``benchmark/data/stack``, at 1024x1280 uint16):
    the patch cell's (512x640 float64 frames, flow at 256x320 in float32)
    or the study's (1024x1280 float64, flow at 512x640), on the kernels
    and on the plain passes; the largest difference of the registered
    frames."""
    from benchmark.data.stack import make_stack
    from pdx_torch.pipelines import improved_registration as ir
    from pdx_torch.pipelines import patch_discovery as pd

    U_raw = make_stack(6, 1024, 1280, seed=seed, device=card)
    if cell == "patch":
        cfg = pd.PatchDiscoveryConfig(data_dir="unused", write_artifacts=False)
        U, register = pd.preprocess_head(cfg, U_raw, card), lambda V: pd.register(cfg, V)  # noqa: E731
    else:
        cfg = ir.ImprovedRegistrationConfig(data_dir="unused", write_artifacts=False)
        U, register = ir.preprocess(cfg, U_raw, card), lambda V: ir.register_farneback(cfg, V)  # noqa: E731
    tfb._STEP_GRAPHS.clear()  # a graph captured on one path must not replay on the other
    got = register(U)
    with monkeypatch.context() as m:
        _plain(m)
        tfb._STEP_GRAPHS.clear()
        want = register(U)
    tfb._STEP_GRAPHS.clear()
    return float((got - want).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["patch", "study"])
def test_float32_chains_on_the_cells_frames_stay_near_the_plain_chain(cuda, monkeypatch, cell):
    """The patch and study cells' chains (float32 flows) on their own kind
    of frames, a large seed as the benchmark draws."""
    assert _cell_chain_gap(cell, 2**31 + 17, cuda, monkeypatch) < CELL_CHAIN_TOL
