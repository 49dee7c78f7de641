"""The Farnebäck flow's windowed passes (``ops/kernels/flow_windows``,
``csrc/farneback.cu``) against their plain versions.

On the CPU ``farneback_flow`` and ``batched_pair_flows`` are the plain
passes, bit for bit, and launch no kernel. On the card (``gpu``;
this file imports no JAX, so ``--noconftest -m gpu`` runs it there) each
kernel is held to its plain version at the cells' shapes, and so is the
whole flow. Tolerances, against the largest magnitude of the plain result:
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

from pdx_torch.ops.kernels import flow_windows
from pdx_torch.register import farneback as tfb
from pdx_torch.utils.profiling import total

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


def _counts():
    """(flow iterations, update kernel launches) counted so far."""
    return total("farneback.iterations"), total("flow_update.launches")


def _warped_plain(img, flow, n, sigma):
    return tfb._poly_exp_plain(tfb.warp_flow(img, flow[0], flow[1]), n, sigma)


def _plain(monkeypatch):
    """Route farneback's passes to their plain versions on every device."""
    monkeypatch.setattr(tfb, "_poly_exp", tfb._poly_exp_plain)
    monkeypatch.setattr(tfb, "_warped_poly_exp", _warped_plain)
    monkeypatch.setattr(tfb, "_flow_iteration", tfb._flow_iteration_plain)
    monkeypatch.setattr(tfb, "_blur", tfb._blur_plain)


# --- the CPU: the plain path --------------------------------------------------


@pytest.mark.parametrize("kw", [SWEEP, dict(levels=2, iterations=2, refine=1)], ids=["sweep", "defaults"])
def test_cpu_flows_are_the_plain_path_bitwise_and_count_no_fused_iterations(monkeypatch, kw):
    a, b = _frames(3, 24, 40, seed=1)
    c0 = _counts()
    fx, fy = tfb.batched_pair_flows(a, b, flow_static=kw, chunk_elems=2 * 24 * 40)
    one = tfb.farneback_flow(a[0], b[0], **kw)
    c1 = _counts()
    assert c1[1] == c0[1] and c1[0] > c0[0]
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
        taps = tfb._poly_exp_taps(n, sigma, torch.float64, torch.device("cpu"))
        cols, M = taps[: 3 * K].view(3, K), taps[3 * K :].view(3, K, 5)
        wins_h = tfb.symmetric_windows(f, K, 1)  # (B, W, H, K)
        Hc = torch.einsum("bwht,ct->cbhw", wins_h, cols)
        wins_w = tfb.symmetric_windows(Hc, K, 3)  # (3, B, H, W, K)
        got = torch.einsum("cbhws,csk->kbhw", wins_w, M)
        assert _gap(got, tfb._poly_exp_plain(f, n, sigma)[:5]) < 1e-13, (n, sigma)


def test_wrappers_refuse_cpu_tensors():
    f = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        flow_windows.window_blur(f, tfb._blur_taps(3, 1.0, True, f.dtype, f.device))


# --- the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _kernels_vs_plain(a, b, n, sigma, winsize, gaussian):
    """Each kernel against its plain version on the card, on (a, b) and a
    flow of a few pixels; returns the largest gap of the four."""
    e1, e2 = tfb._poly_exp(a, n, sigma), tfb._poly_exp(b, n, sigma)
    p1, p2 = tfb._poly_exp_plain(a, n, sigma), tfb._poly_exp_plain(b, n, sigma)
    gaps = [_gap(e1, p1[:5]), _gap(e2, p2[:5])]
    g = torch.Generator(device=a.device).manual_seed(5)
    flow = 2.0 * torch.randn((2,) + a.shape, dtype=a.dtype, device=a.device, generator=g)
    gaps.append(_gap(tfb._warped_poly_exp(b, flow, n, sigma), _warped_plain(b, flow, n, sigma)[:5]))
    gaps.append(_gap(tfb._flow_iteration(p1, p2, flow, winsize, gaussian),
                     tfb._flow_iteration_plain(p1, p2, flow, winsize, gaussian)))
    gaps.append(_gap(tfb._blur(flow, winsize, 0.3 * winsize, gaussian),
                     tfb._blur_plain(flow, winsize, 0.3 * winsize, gaussian)))
    return max(gaps)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sweep_6x1024x1280", "transport_50x256x320"])
def test_float64_pair_flows_match_the_plain_path_on_the_card(card, monkeypatch, cell):
    """The quality sweep's chunk and ``transport``'s batch: each kernel, then
    the whole batched flow, against the plain passes on the card."""
    B, H, W = (6, 1024, 1280) if cell.startswith("sweep") else (50, 256, 320)
    a, b = _frames(B, H, W, seed=B, device=card)
    assert _kernels_vs_plain(a, b, 2, 1.2, 15, False) < 1e-12
    c0 = _counts()
    fx, fy = tfb.batched_pair_flows(a, b, flow_static=SWEEP)
    c1 = _counts()
    with monkeypatch.context() as m:
        _plain(m)
        px, py = tfb.batched_pair_flows(a, b, flow_static=SWEEP)
    gap = max(_gap(fx, px), _gap(fy, py))
    assert gap < TOL[torch.float64], gap
    assert c1[1] - c0[1] == c1[0] - c0[0] > 0  # every iteration launched the kernel


@pytest.mark.gpu
def test_float32_chain_step_matches_the_plain_step_eager_and_replayed(card, monkeypatch):
    """One chain step at the patch cell's flow grid (512x640 frames, flow at
    256x320, the defaults) on the kernels, eager and replayed as a graph,
    against the plain step; replays count their update launches."""
    a, b = _frames(1, 512, 640, seed=7, dtype=torch.float32, device=card)
    a, b = a[0], b[0]
    kw = dict(flow_ds=2, warp_sign=1.0, ksize=11, sigma=2.0, kw={"refine": 1})
    assert _kernels_vs_plain(a[::2, ::2].contiguous(), b[::2, ::2].contiguous(), 3, 1.5, 25, True) < 1e-5
    eager = tfb._chain_step(a, b, **kw)
    step = lambda r, c: tfb._chain_step(r, c, **kw)  # noqa: E731
    graph = tfb.StepGraph(step, a, b)
    c0 = _counts()
    replayed = graph.replay(a, b).clone()
    c1 = _counts()
    assert torch.equal(replayed, eager)
    assert c1[1] - c0[1] == c1[0] - c0[0] == 5 * 5 + 2
    with monkeypatch.context() as m:
        _plain(m)
        plain = tfb._chain_step(a, b, **kw)
    assert _gap(eager, plain) < TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_border_folds_again_where_the_window_outnumbers_the_rows(card, dtype):
    """An 8-pixel pyramid level with K = 25 (window and expansion): the
    symmetric border folds twice."""
    a, b = _frames(3, 8, 10, seed=9, dtype=dtype, device=card)
    assert _kernels_vs_plain(a, b, 12, 4.0, 25, True) < TOL[dtype]
    assert _kernels_vs_plain(a[:, :, :8].contiguous(), b[:, :, :8].contiguous(), 3, 1.5, 25, False) < TOL[dtype]


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    f = torch.zeros((2, 16, 16), dtype=torch.float64, device=card)
    taps = tfb._blur_taps(5, 1.5, True, f.dtype, f.device)
    with pytest.raises(TypeError):
        flow_windows.window_blur(f.half(), taps.half())
    with pytest.raises(TypeError):
        flow_windows.window_blur(f.float(), taps)  # taps of another type
    with pytest.raises(ValueError, match="contiguous"):
        flow_windows.window_blur(f.transpose(1, 2), taps)
    with pytest.raises(ValueError, match="taps"):
        flow_windows.window_blur(f, taps[:4])
    exp = torch.zeros((5, 2, 16, 16), dtype=f.dtype, device=card)
    with pytest.raises(ValueError, match="flow"):
        flow_windows.flow_update(exp, exp, torch.zeros((2, 2, 16, 8), dtype=f.dtype, device=card), taps)
    with pytest.raises(ValueError, match="CUDA"):
        flow_windows.poly_expansion(f.cpu(), tfb._poly_exp_taps(2, 1.2, f.dtype, f.device))


@pytest.mark.gpu
def test_every_flow_on_the_card_counts_its_iterations_fused(card):
    """A sweep-sized flow, a default flow and a chain: one update launch an
    iteration, and each wrapper counts its launches."""
    a, b = _frames(2, 64, 80, seed=11, device=card)
    names = ("poly_expansion", "warped_poly_expansion", "flow_update", "window_blur")
    l0, c0 = [total(f"{n}.launches") for n in names], _counts()
    tfb.farneback_flow(a, b, **SWEEP)
    tfb.farneback_flow(a[0], b[0])
    tfb.farneback_register_sequence(torch.cat([a, b]), flow_ds=1)
    l1, c1 = [total(f"{n}.launches") for n in names], _counts()
    assert c1[1] - c0[1] == c1[0] - c0[0] > 0  # one launch an iteration
    assert all(y > x for x, y in zip(l0, l1))


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
def test_float32_chains_on_the_cells_frames_stay_near_the_plain_chain(card, monkeypatch, cell):
    """The patch and study cells' chains (float32 flows) on their own kind
    of frames, a large seed as the benchmark draws."""
    assert _cell_chain_gap(cell, 2**31 + 17, card, monkeypatch) < CELL_CHAIN_TOL
