"""Dense optical flow by polynomial expansion (Farnebäck 2003) and frame-stack
registration (port of ``pdx/register/farneback.py``).

The counterpart of cv2.calcOpticalFlowFarneback as the reference's
registration uses it:

  1. each image is approximated locally by a quadratic polynomial
     f(x + d) ~ c + b^T d + d^T A d by Gaussian-weighted least squares over a
     (2n+1)^2 window; the normal matrix is the same at every pixel, so the
     expansion is two separable correlations with its inverse folded in;
  2. given the expansions (A1, b1) of frame 1 at x and (A2, b2) of frame 2
     at x + d(x), the displacement solves A d = db with A = (A1 + A2) / 2,
     db = -0.5 (b2 - b1) + A d; the 2x2 systems are blurred over a window
     and solved per pixel;
  3. a coarse-to-fine pyramid (factor ``pyr_scale``) with the flow upscaled
     between levels, then ``refine`` re-warp passes at full resolution.

Every field may carry leading batch axes (independent frame pairs):
``pdx`` has a separate batched lowering for the TPU, the port one code path.
Registration chains the frames on the host, one flow a frame, as ``pdx``'s
CPU schedule does; ``compose`` and ``to_first`` run all pair flows as one
batch. On the CPU the separable passes are one product of sliding windows
each (``ops/filters.symmetric_windows``), where ``pdx`` adds shifted copies
tap by tap: the same sums in another order. The windowed passes live in
``ops/kernels/flow_windows``: the expansion (of a re-warp pass's warped
frame too), each flow update (fetch, normal equations, window, solve) and
the blur, each one kernel launch on a CUDA tensor and its plain version on
the CPU.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict

import torch
from torch import Tensor

from pdx_torch.ops.interp import pixel_grid, resize_bilinear, sample_reflect_xy, warp_flow, warp_flow_batch
from pdx_torch.ops.kernels import flow_windows
from pdx_torch.utils.graphs import StepGraph
from pdx_torch.utils.profiling import count, span

# Pixel-pairs per batched pyramid in batched_pair_flows. On the card it
# bounds a batch's planes (two five-plane expansions, the flows, the warped
# and resized frames: ~20 planes, ~1.3 GB of float64 at 2^23); the CPU's
# plain passes also hold the blur's sliding windows (5 fields x 25 taps a
# pixel-pair at winsize 25). Chunks change no result.
_FLOW_CHUNK_ELEMS = 1 << 23

def farneback_flow(
    img1: Tensor,
    img2: Tensor,
    *,
    pyr_scale: float = 0.5,
    levels: int = 5,
    winsize: int = 25,
    iterations: int = 5,
    poly_n: int = 7,
    poly_sigma: float = 1.5,
    gaussian_win: bool = True,
    refine: int = 2,
) -> tuple[Tensor, Tensor]:
    """Dense flow (flow_r, flow_c) with img2(x + flow(x)) ~ img1(x), the
    convention of cv2.calcOpticalFlowFarneback(prev=img1, next=img2).
    Images are (..., H, W); leading axes are independent pairs.

    Defaults are the reference's "improved" parameters. ``refine``: re-warp
    passes after the pyramid, each re-expanding the warped second image
    around the small residual displacement, where the quadratic model holds
    (the plain update stops at ~0.8x of a translation; ``refine=0`` is the
    strict cv2-equivalent scheme).

    Adds the pairs to the tracer's count ``farneback.flows``; each pyramid
    level is a span ``farneback.level`` and each re-warp pass a span
    ``farneback.refine``, each counting its ``farneback.iterations``.
    """
    H, W = img1.shape[-2], img1.shape[-1]

    shapes = [(H, W)]  # pyramid, coarsest last
    for _ in range(1, levels):
        h2, w2 = shapes[-1]
        h2, w2 = max(int(round(h2 * pyr_scale)), 8), max(int(round(w2 * pyr_scale)), 8)
        if (h2, w2) == shapes[-1]:
            break
        shapes.append((h2, w2))

    def to_shape(img: Tensor, shp: tuple[int, int]) -> Tensor:
        if (img.shape[-2], img.shape[-1]) == shp:
            return img
        return resize_bilinear(img, shp[0], shp[1])

    count("farneback.flows", math.prod(img1.shape[:-2]))
    flow = None  # stacked (d_row, d_col)
    for shp in reversed(shapes):
        with span("farneback.level"):
            exp1 = flow_windows.poly_expansion(to_shape(img1, shp), poly_n, poly_sigma)
            exp2 = flow_windows.poly_expansion(to_shape(img2, shp), poly_n, poly_sigma)
            if flow is None:
                flow = torch.zeros((2,) + img1.shape[:-2] + shp, dtype=img1.dtype, device=img1.device)
            else:
                up = resize_bilinear(flow, shp[0], shp[1])
                flow = torch.stack([up[0] * (shp[0] / flow.shape[-2]), up[1] * (shp[1] / flow.shape[-1])])
            for _ in range(iterations):
                flow = flow_windows.flow_update(exp1, exp2, flow, winsize, gaussian_win)
            count("farneback.iterations", iterations)

    # re-warp refinement at full resolution; exp1 is the finest level's
    for _ in range(int(refine)):
        with span("farneback.refine"):
            expw = flow_windows.warped_poly_expansion(img2, flow, poly_n, poly_sigma)
            d = torch.zeros_like(flow)
            for _ in range(2):
                d = flow_windows.flow_update(exp1, expw, d, winsize, gaussian_win)
            flow = flow + d
            count("farneback.iterations", 2)
    return flow[0], flow[1]


def _chain_flow_ds(flow_ds: int | None, H: int, W: int, device: torch.device) -> int:
    """Resolution of each chain step's flow: None -> 2 on the card (the flow
    of 2x-downsampled frames, upsampled before the smooth and warp), 1 on
    the CPU; an explicit value wins. Halved until the flow grid is >= 64 px."""
    ds = int(flow_ds) if flow_ds is not None else (1 if torch.device(device).type == "cpu" else 2)
    while ds > 1 and min(H, W) // ds < 64:
        ds //= 2
    return max(1, ds)


def _chain_step(ref: Tensor, cur: Tensor, *, flow_ds: int, warp_sign: float, ksize: int, sigma: float,
                kw: dict) -> Tensor:
    """One chain step, the eager one and what a chain graph captures: the
    flow from ``ref`` to ``cur`` at 1/flow_ds resolution, in float32 when
    the frames are float64, returned to full resolution and scale, smoothed
    (``ksize`` taps, ``sigma``) and cast to the frames' dtype; ``cur`` warped
    by ``warp_sign`` times it."""
    H, W = ref.shape[-2], ref.shape[-1]
    f32 = torch.float32 if cur.dtype == torch.float64 else cur.dtype
    a, b = ref.to(f32), cur.to(f32)
    if flow_ds > 1:
        a = resize_bilinear(a, H // flow_ds, W // flow_ds)
        b = resize_bilinear(b, H // flow_ds, W // flow_ds)
    fx, fy = farneback_flow(a, b, **kw)
    if flow_ds > 1:
        fx = resize_bilinear(fx, H, W) * (H / fx.shape[-2])
        fy = resize_bilinear(fy, H, W) * (W / fy.shape[-1])
    with span("farneback.smooth_warp"):
        fs = flow_windows.window_blur(torch.stack([fx, fy]), ksize, sigma, True).to(cur.dtype)
        return warp_flow(cur, warp_sign * fs[0], warp_sign * fs[1])


# The chain's step graphs by (frame shape, dtype, device, the step's
# settings), least recently used first; an evicted one frees its graph and
# its memory pool.
_STEP_GRAPHS: OrderedDict[tuple, StepGraph] = OrderedDict()
_STEP_GRAPH_CAP = 4


def _step_graph(key: tuple, step, ref: Tensor, cur: Tensor) -> StepGraph:
    """The graph of ``step`` on frames like ``ref`` and ``cur``: captured
    now, the least recently used one beyond the cap dropped once the
    capture's synchronize has finished its replays."""
    with torch.cuda.device(cur.device):
        graph = _STEP_GRAPHS[key] = StepGraph(step, ref, cur)
    while len(_STEP_GRAPHS) > _STEP_GRAPH_CAP:
        _STEP_GRAPHS.popitem(last=False)
    count("farneback.graph_captures")
    return graph


def farneback_register_sequence(
    U: Tensor,
    *,
    flow_smooth_ksize: int = 11,
    flow_smooth_sigma: float = 2.0,
    warp_sign: float = 1.0,
    **flow_kwargs,
) -> Tensor:
    """Sequential warp-to-previous registration of a (T, H, W) stack: the
    flow from the previous registered frame to the current one, smoothed by
    an 11x11 Gaussian (sigma 2), warps the current frame (reflect border).

    The flow is computed in float32 when the stack is float64 (cv2 computes
    it in float32) and the warp applied in the stack's dtype. ``refine``
    defaults to 1 here; ``flow_ds`` (see :func:`_chain_flow_ds`) and any
    other :func:`farneback_flow` argument pass through.

    ``warp_sign=+1`` warps by mov(x + flow(x)), which aligns under the cv2
    convention; the reference builds its map as ``x - flow``, which doubles
    the residual misalignment: ``warp_sign=-1`` reproduces it.

    On a CUDA stack, unless the current stream is being captured, each step
    is one CUDA graph (:class:`~pdx_torch.utils.graphs.StepGraph`) replayed
    from the host: the first step of a frame shape, dtype, device and
    settings not seen lately runs eagerly and is then captured (count
    ``farneback.graph_captures``), and every later step is a replay (count
    ``farneback.graph_replays``), bitwise the eager step. On the CPU every
    step runs eagerly.

    Each step is a span ``farneback.chain_flow``. An eager step holds its
    flow's spans and counts and a span ``farneback.smooth_warp``; a replay
    runs no host code between its kernels, so it opens none of them, and
    counts the ``farneback.flows`` and ``farneback.iterations`` of its
    capture.
    """
    flow_kwargs.setdefault("refine", 1)
    flow_ds = _chain_flow_ds(flow_kwargs.pop("flow_ds", None), U.shape[-2], U.shape[-1], U.device)
    step = functools.partial(_chain_step, flow_ds=flow_ds, warp_sign=warp_sign, ksize=flow_smooth_ksize,
                             sigma=flow_smooth_sigma, kw=flow_kwargs)
    graphed = U.is_cuda and not torch.cuda.is_current_stream_capturing()
    key = (tuple(U.shape[-2:]), U.dtype, U.device, flow_ds, float(warp_sign), int(flow_smooth_ksize),
           float(flow_smooth_sigma), tuple(sorted(flow_kwargs.items())))
    graph = _STEP_GRAPHS.get(key) if graphed else None
    if graph is not None:
        _STEP_GRAPHS.move_to_end(key)
    out = torch.empty_like(U)
    out[0] = U[0]
    for i in range(1, U.shape[0]):
        with span("farneback.chain_flow"):
            if graph is not None:
                out[i].copy_(graph.replay(out[i - 1], U[i]))
                count("farneback.graph_replays")
            else:
                out[i] = step(out[i - 1], U[i])
                if graphed:
                    graph = _step_graph(key, step, out[i - 1], U[i])
    return out


def auto_register_mode() -> str:
    """``register_mode="auto"``: the warp-to-previous chain. The composed
    to-first flows of ``compose`` accumulate interpolation blur along the
    chain, a different registration, so ``auto`` does not pick them."""
    return "chain"


def register_sequence_dispatch(U: Tensor, *, mode: str, refine: int, reference_compat_warp: bool = False) -> Tensor:
    """The register-mode policy of the real-image pipelines:
    ``reference_compat_warp`` forces the chain with the reference's inverted
    warp sign; ``auto`` resolves by :func:`auto_register_mode`; ``chain``
    chains; anything else runs the batched pair flows (``to_first``
    against frame 0, otherwise composed)."""
    if reference_compat_warp:
        return farneback_register_sequence(U, warp_sign=-1.0, refine=refine)
    if mode == "auto":
        mode = auto_register_mode()
    if mode == "chain":
        return farneback_register_sequence(U, refine=refine)
    return farneback_register_sequence_compose(U, to_first=(mode == "to_first"), refine=refine)


def batched_pair_flows(a_all: Tensor, b_all: Tensor, *, flow_static=(), chunk_elems: int | None = None):
    """Flows of B independent pairs (a_all[i] -> b_all[i]), (B, H, W) each,
    as batched pyramids of at most ``chunk_elems`` pixel-pairs.
    ``flow_static``: :func:`farneback_flow`'s keyword arguments, as a dict
    or as ``pdx``'s tuple of (name, value) pairs."""
    B, H, W = a_all.shape[-3], a_all.shape[-2], a_all.shape[-1]
    if B == 0:  # e.g. a single-frame stack: no pairs, no flows
        dtype = a_all.dtype if a_all.is_floating_point() else torch.float32
        z = torch.zeros((0, H, W), dtype=dtype, device=a_all.device)
        return z, z
    kw = dict(flow_static)
    chunk = max(1, min(B, (chunk_elems or _FLOW_CHUNK_ELEMS) // (H * W)))
    outs = [farneback_flow(a_all[s : s + chunk], b_all[s : s + chunk], **kw) for s in range(0, B, chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def farneback_flow_pairs(U: Tensor, **flow_kwargs) -> tuple[Tensor, Tensor]:
    """Flow of every consecutive frame pair, as one batch of pairs."""
    return batched_pair_flows(U[:-1], U[1:], flow_static=flow_kwargs)


def compose_flow_chain(fx: Tensor, fy: Tensor, *, batched: bool = False) -> tuple[Tensor, Tensor]:
    """Compose consecutive backward flows into to-first flows.

    ``fx``/``fy``: (T-1, H, W) pair flows (``batched=True``: (P, T-1, H, W),
    P independent chains), flow t mapping frame-t points to frame t+1. The
    result has U[0](x) ~ U[t+1](x + F_t(x)), by
    F_t = F_{t-1} + f_t(id + F_{t-1}), F_0 = f_0: one reflect-101 fetch of
    the 2-channel pair flow a step.
    """
    ta = 1 if batched else 0
    fxs, fys = fx.movedim(ta, 0), fy.movedim(ta, 0)
    H, W = fx.shape[-2], fx.shape[-1]
    grid = pixel_grid(H, W, fx.dtype, fx.device).view((2,) + (1,) * (fxs.ndim - 3) + (H, W))
    F = torch.zeros((2,) + fxs.shape[1:], dtype=fx.dtype, device=fx.device)  # stacked (F_x, F_y)
    out = []
    for f in torch.stack([fxs, fys], dim=1):  # (2, [P,] H, W) a step
        F = F + sample_reflect_xy(f, grid + F)
        out.append(F)
    out = torch.stack(out)  # (T-1, 2, [P,] H, W)
    return out[:, 0].movedim(0, ta), out[:, 1].movedim(0, ta)


def farneback_register_sequence_compose(
    U: Tensor,
    *,
    flow_smooth_ksize: int = 11,
    flow_smooth_sigma: float = 2.0,
    to_first: bool = False,
    **flow_kwargs,
) -> Tensor:
    """Registration to the first frame from batched pair flows:

      1. all T-1 consecutive-pair flows as batched pyramids,
      2. the 11x11, sigma-2 smoothing of every pair flow in one batch,
      3. composition into to-first flows (:func:`compose_flow_chain`),
      4. one batched warp of frames 1..T-1.

    ``to_first=True`` estimates each frame's flow against frame 0 directly
    and skips the composition. Only the fixed warp direction (+1) exists
    here: composing backward maps under the reference's ``x - flow`` map is
    meaningless.
    """
    flow_kwargs.setdefault("refine", 1)
    return _register_compose_impl(
        U, ksize=flow_smooth_ksize, sigma=flow_smooth_sigma, flow_static=flow_kwargs, to_first=to_first
    )


def _register_compose_impl(U: Tensor, *, ksize: int, sigma: float, flow_static, to_first: bool) -> Tensor:
    f32 = torch.float32 if U.dtype == torch.float64 else U.dtype
    Uf = U.to(f32)
    a = Uf[:1].expand_as(Uf[1:]) if to_first else Uf[:-1]
    fx, fy = batched_pair_flows(a, Uf[1:], flow_static=flow_static)
    sm = flow_windows.window_blur(torch.stack([fx, fy], dim=1), ksize, sigma, True)  # (T-1, 2, H, W)
    fx, fy = sm[:, 0], sm[:, 1]
    if not to_first:
        fx, fy = compose_flow_chain(fx, fy)
    warped = warp_flow_batch(U[1:], fx.to(U.dtype), fy.to(U.dtype))
    return torch.cat([U[:1], warped], dim=0)
