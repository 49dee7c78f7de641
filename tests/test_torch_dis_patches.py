"""The DIS flow's per-level passes (``ops/kernels/dis_patches``,
``csrc/dis.cu``) against their plain versions.

On the CPU each wrapper is its plain version (the ``*_reference``
functions), bit for bit, and launches no kernel. On the card (``gpu``; this
file imports no JAX, so ``--noconftest -m gpu`` runs it there) the inverse
search and the densification are held to the plain passes at the study's
pyramid levels (1024x1280 down to 128x160) and at sizes that leave margins
no patch covers, for three patch grids; a flow repeats bit for bit, launches
each kernel once a level, and a whole chain step is captured as a CUDA graph
(no host read). Tolerances, against the largest magnitude of the plain
flow: float64 1e-10, as ``test_torch_dis``'s card-vs-CPU flow, float32
1e-4. The kernels sum the patches' products warp-wise and the damping's mean
in blocks, where the plain passes reduce along the patches' axes, and each
of the 8 Lucas-Kanade iterations divides by a damped 2x2 determinant, so a
patch's translation moves by a few hundred ulp of the input's type (an
emulation of the kernels' sums on the CPU reads ~1e-13 in float64 and up to
7e-6 in float32 at 509x641). The residual weights 1 / (mean |r| + 1e-3)
divide by a mean of cancelling differences: in float32 they are held to
2e-3 of the largest weight (the emulation: up to 5e-4).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

from pdx_torch.ops.kernels import dis_patches as dp
from pdx_torch.pipelines import improved_registration as ir
from pdx_torch.register import dis as tdis
from pdx_torch.utils.graphs import StepGraph
from torch_card import DIS_KERNELS, card, cuda, launches

GRIDS = [(8, 4), (8, 3), (4, 2)]
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
WEIGHT_TOL = {torch.float64: 1e-10, torch.float32: 2e-3}
# the study's pyramid levels, and sizes whose grids leave margins at every stride
LEVELS = [(1024, 1280), (512, 640), (256, 320), (128, 160), (1021, 1277), (70, 64)]


@functools.cache
def _level(H: int, W: int) -> tuple[np.ndarray, ...]:
    """A smooth textured frame in [0, 1], the frame moved by (1.5, -1.0)
    pixels, and a smooth initial flow of up to ~1 pixel."""
    rng = np.random.default_rng(H + W)
    ref = gaussian_filter(rng.normal(size=(H, W)), 3.0)
    ref = (ref - ref.min()) / (ref.max() - ref.min())
    mov = ndshift(ref, (1.5, -1.0), mode="reflect")
    flow = gaussian_filter(rng.normal(size=(2, H, W)), (0, 8.0, 8.0))
    return ref, mov, flow / np.abs(flow).max()


def _tensors(H, W, dtype, device):
    ref, mov, flow = (torch.tensor(a, dtype=dtype, device=device) for a in _level(H, W))
    return ref, mov, flow[0], flow[1]


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _uncovered(H, W, ps, st):
    """Rows and columns beyond the grid's last patch."""
    return ((H - ps) // st) * st + ps, ((W - ps) // st) * st + ps


# --- the CPU: the plain passes ------------------------------------------------


@pytest.mark.parametrize("ps,st", GRIDS)
def test_cpu_tensors_take_the_plain_passes_bitwise(ps, st):
    """On CPU tensors each wrapper returns its plain version's bits and
    launches no kernel; the level's flow is the two in turn."""
    ref, mov, fx, fy = _tensors(70, 64, torch.float64, "cpu")
    with launches(DIS_KERNELS) as moved:
        vals = dp.dis_inverse_search(ref, mov, fx, fy, ps, st, 8)
        flow = dp.dis_densify(vals, fx, fy, ps, st)
        level = tdis._level_flow(ref, mov, fx, fy, ps, st, 8)
    assert not any(moved.values()), moved
    assert torch.equal(vals, dp.inverse_search_reference(ref, mov, fx, fy, ps, st, 8))
    for got, want, lv in zip(flow, dp.densify_reference(vals, fx, fy, ps, st), level):
        assert torch.equal(got, want) and torch.equal(lv, want)


def _refusals(device):
    f = torch.zeros((16, 16), dtype=torch.float64, device=device)
    vals = dp.dis_inverse_search(f, f, f, f, 8, 4, 1) if device != "meta" else f.new_empty((3, 9))
    return [
        (TypeError, lambda: dp.dis_inverse_search(f.half(), f.half(), f.half(), f.half(), 8, 4, 8)),
        (TypeError, lambda: dp.dis_inverse_search(f, f.float(), f, f, 8, 4, 8)),
        (ValueError, lambda: dp.dis_inverse_search(f, f, f, f, dp.MAX_PATCH + 1, 4, 8)),
        (ValueError, lambda: dp.dis_inverse_search(f[:4], f[:4], f[:4], f[:4], 8, 4, 8)),  # patches over the rows
        (ValueError, lambda: dp.dis_inverse_search(f, f, f, f, 8, 0, 8)),
        (ValueError, lambda: dp.dis_inverse_search(f, f[:, :8], f, f, 4, 2, 8)),
        (ValueError, lambda: dp.dis_inverse_search(f, f, f, f, 8, 4, -1)),
        (TypeError, lambda: dp.dis_densify(vals.float(), f, f, 8, 4)),
        (ValueError, lambda: dp.dis_densify(vals[:, :8], f, f, 8, 4)),
        (ValueError, lambda: dp.dis_densify(vals, f, f, dp.MAX_PATCH + 1, 4)),
    ]


@pytest.mark.parametrize("device", ["meta", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_the_kernel_path_refuses_what_the_kernels_do_not_take(device):
    """A tensor off the CPU of an unsupported type, patch grid or shape is
    refused before a launch (on ``meta`` tensors the same checks run
    without a card)."""
    if device == "cuda":
        device = card()
    for exc, call in _refusals(device):
        with pytest.raises(exc):
            call()


# --- the card -----------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ps,st", GRIDS)
@pytest.mark.parametrize("H,W", LEVELS)
def test_the_kernels_match_the_plain_passes_on_the_card(cuda, H, W, ps, st, dtype):
    """One level's inverse search and densification against the plain
    passes on the card; pixels no patch covers keep the initial flow bit
    for bit."""
    ref, mov, fx, fy = _tensors(H, W, dtype, cuda)
    vals = dp.dis_inverse_search(ref, mov, fx, fy, ps, st, 8)
    want = dp.inverse_search_reference(ref, mov, fx, fy, ps, st, 8)
    assert vals.shape == want.shape
    # the weights alone: (w u, w v) / w are the translations
    assert _gap(vals[2], want[2]) < WEIGHT_TOL[dtype]
    got = dp.dis_densify(vals, fx, fy, ps, st)
    plain = dp.densify_reference(want, fx, fy, ps, st)
    assert max(_gap(g, p) for g, p in zip(got, plain)) < TOL[dtype]
    # the densification alone, on the same values
    assert max(_gap(g, p) for g, p in zip(dp.dis_densify(want, fx, fy, ps, st), plain)) < TOL[dtype]
    r, c = _uncovered(H, W, ps, st)
    for g, init in zip(got, (fx, fy)):
        assert torch.equal(g[r:], init[r:]) and torch.equal(g[:, c:], init[:, c:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_a_flow_repeats_bitwise_and_launches_each_kernel_once_a_level(cuda, dtype):
    """The study's full-size flow (four levels): twice the same bits; one
    search and one densification a level."""
    ref, mov, _, _ = _tensors(1024, 1280, dtype, cuda)
    with launches(DIS_KERNELS, ("dis.levels",)) as moved:
        first = tdis.dis_flow(ref, mov)
    again = tdis.dis_flow(ref, mov)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert moved["dis_inverse_search"] == moved["dis_densify"] == moved["dis.levels"] == 4, moved


@pytest.mark.gpu
def test_a_dis_step_is_captured_as_a_cuda_graph(cuda):
    """One chain step (flow, smoothing, warp) at the study's size, captured
    after one eager step: the capture reads nothing from the card on the
    host, and its replay is the eager step's bits."""
    ref, mov, _, _ = _tensors(1024, 1280, torch.float64, cuda)
    eager = ir._dis_step(ref, mov, 1.0)
    graph = StepGraph(lambda r, m: ir._dis_step(r, m, 1.0), ref, mov)
    with launches(DIS_KERNELS) as moved:
        replayed = graph.replay(ref, mov).clone()
    assert torch.equal(replayed, eager)
    assert moved["dis_inverse_search"] == moved["dis_densify"] == 4, moved
