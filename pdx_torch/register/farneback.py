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
tap by tap: the same sums in another order. On a CUDA tensor the expansion
(of a re-warp pass's warped frame too), each flow update (fetch, normal
equations, window, solve) and the blur are one kernel launch each
(``ops/kernels/flow_windows``); the plain versions ``_poly_exp_plain``,
``_flow_iteration_plain`` and ``_blur_plain`` stay the CPU's path.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.filters import correlate1d_symmetric, symmetric_windows
from pdx_torch.ops.interp import resize_bilinear, sample_reflect_xy, warp_flow, warp_flow_batch
from pdx_torch.ops.kernels import flow_windows
from pdx_torch.utils.graphs import StepGraph, constant_cache
from pdx_torch.utils.profiling import count, span

# Pixel-pairs per batched pyramid in batched_pair_flows. On the card it
# bounds a batch's planes (two five-plane expansions, the flows, the warped
# and resized frames: ~20 planes, ~1.3 GB of float64 at 2^23); the CPU's
# plain passes also hold the blur's sliding windows (5 fields x 25 taps a
# pixel-pair at winsize 25). Chunks change no result.
_FLOW_CHUNK_ELEMS = 1 << 23

# moments in basis order [1, dr, dc, dr^2, dc^2, dr*dc]:
# (row kernel, col kernel) = (g,g) (gx,g) (g,gx) (gxx,g) (g,gxx) (gx,gx)
_ROW_OF_MOMENT = (0, 1, 0, 2, 0, 1)  # index into the row kernels [g, gx, gxx]
_COL_OF_MOMENT = (0, 0, 1, 0, 2, 1)  # index into the col kernels [g, gx, gxx]
# expansion output order (axx, ayy, axy, bx, by, c) as basis indices
_EXP_ORDER = [3, 4, 5, 1, 2, 0]


def _make_invG(n: int, sigma: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host float64 (g, x, invG): the normalised 1-D Gaussian and offsets of
    the (2n+1)-tap window, and the inverse of the 6x6 normal matrix of the
    weighted quadratic fit."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g1 = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g1 /= g1.sum()
    OX, OY = np.meshgrid(x, x, indexing="ij")
    W = np.outer(g1, g1)
    B = np.stack([np.ones_like(OX), OX, OY, OX**2, OY**2, OX * OY], axis=-1).reshape(-1, 6)
    G = (B * W.reshape(-1)[:, None]).T @ B
    return g1, x, np.linalg.inv(G)


@constant_cache(maxsize=32)
def _poly_exp_operators(n: int, sigma: float, dtype: torch.dtype, device: torch.device) -> tuple[Tensor, Tensor]:
    """(Kr (K, 3), M (3K, 6)): the row kernels [g, g x, g x^2], and the
    column kernels of the six moments with invG folded in, so that
    coef[k] = sum over (c, t) of M[c K + t, k] * R_c(w + t - n) for the
    row-pass outputs R_c, k in :data:`_EXP_ORDER`."""
    g, x, invG = _make_invG(n, sigma)
    rows = np.stack([g, g * x, g * x * x])  # (3, K)
    K = rows.shape[1]
    M = np.zeros((3, K, 6))
    for j in range(6):
        M[_ROW_OF_MOMENT[j]] += rows[_COL_OF_MOMENT[j]][:, None] * invG[:, j][None, :]
    M = M[:, :, _EXP_ORDER]
    return (
        torch.as_tensor(rows.T.copy(), dtype=dtype, device=device),
        torch.as_tensor(M.reshape(3 * K, 6), dtype=dtype, device=device),
    )


@constant_cache(maxsize=32)
def _poly_exp_taps(n: int, sigma: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    """The expansion kernel's (18K,) taps: :func:`_poly_exp_operators`'
    kernels [g, g x, g x^2] down H (3K), then the first five columns of its
    (3K, 6) operator along W, row-major: the plain passes' own values, in
    their order."""
    Kr, M = _poly_exp_operators(n, sigma, dtype, device)
    return torch.cat([Kr.T.reshape(-1), M[:, :5].reshape(-1)])


def _poly_exp(f: Tensor, n: int, sigma: float) -> Tensor:
    """Polynomial expansion of f (..., H, W): the (5, ..., H, W)
    coefficients (axx, ayy, axy, bx, by) that the flow update reads, from
    the kernel on a CUDA tensor, or :func:`_poly_exp_plain`'s six."""
    if f.is_cuda:
        return flow_windows.poly_expansion(f.contiguous(), _poly_exp_taps(n, float(sigma), f.dtype, f.device))
    return _poly_exp_plain(f, n, sigma)


def _warped_poly_exp(img: Tensor, flow: Tensor, n: int, sigma: float) -> Tensor:
    """The expansion of ``img`` warped by the stacked ``flow``, as a re-warp
    pass takes it: one kernel on a CUDA tensor (the warp is the expansion's
    front), else the warp, then :func:`_poly_exp`."""
    if img.is_cuda:
        return flow_windows.warped_poly_expansion(img.contiguous(), flow.contiguous(),
                                                  _poly_exp_taps(n, float(sigma), img.dtype, img.device))
    return _poly_exp(warp_flow(img, flow[0], flow[1]), n, sigma)


def _poly_exp_plain(f: Tensor, n: int, sigma: float) -> Tensor:
    """Polynomial expansion of f (..., H, W) -> (6, ..., H, W) coefficients
    in the order (axx, ayy, axy, bx, by, c): b is the gradient, A the
    quadratic form, f ~ c + b.d + d^T A d with d = (d_row, d_col). The five
    fields the flow update fetches come first, so they are one slice."""
    Kr, M = _poly_exp_operators(n, float(sigma), f.dtype, f.device)
    K = Kr.shape[0]
    H, W = f.shape[-2], f.shape[-1]
    R = (symmetric_windows(f, K, f.ndim - 2) @ Kr).transpose(-3, -2)  # (..., H, W, 3)
    win = symmetric_windows(R, K, R.ndim - 2)  # (..., H, 3, W, K)
    coef = win.transpose(-3, -2).reshape(f.shape[:-2] + (H, W, 3 * K)) @ M  # (..., H, W, 6)
    return coef.movedim(-1, 0).contiguous()


@constant_cache(maxsize=32)
def _blur_taps(ksize: int, sigma: float, gaussian: bool, dtype: torch.dtype, device: torch.device) -> Tensor:
    n = ksize // 2
    if gaussian:
        x = np.arange(-n, n + 1, dtype=np.float64)
        k = np.exp(-(x**2) / (2.0 * sigma * sigma))
        k /= k.sum()
    else:
        k = np.full(2 * n + 1, 1.0 / (2 * n + 1))
    return torch.as_tensor(k, dtype=dtype, device=device)


def _blur(f: Tensor, ksize: int, sigma: float, gaussian: bool) -> Tensor:
    """Window aggregation blur on the trailing two axes, symmetric border:
    Gaussian (OPTFLOW_FARNEBACK_GAUSSIAN) or box; the kernel on a CUDA
    tensor, else :func:`_blur_plain`."""
    if f.is_cuda:
        return flow_windows.window_blur(f.contiguous(), _blur_taps(int(ksize), float(sigma), bool(gaussian), f.dtype,
                                                                   f.device))
    return _blur_plain(f, ksize, sigma, gaussian)


def _blur_plain(f: Tensor, ksize: int, sigma: float, gaussian: bool) -> Tensor:
    """The blur as two products of sliding windows."""
    k = _blur_taps(int(ksize), float(sigma), bool(gaussian), f.dtype, f.device)
    return correlate1d_symmetric(correlate1d_symmetric(f, k, f.ndim - 2), k, f.ndim - 1)


@constant_cache(maxsize=64)
def _pixel_grid(H: int, W: int, dtype: torch.dtype, device: torch.device) -> Tensor:
    """(2, H, W): each pixel's (row, col)."""
    r = torch.arange(H, dtype=dtype, device=device)
    c = torch.arange(W, dtype=dtype, device=device)
    return torch.stack(torch.meshgrid(r, c, indexing="ij"))


def _flow_iteration(exp1: Tensor, exp2: Tensor, flow: Tensor, winsize: int, gaussian_win: bool) -> Tensor:
    """One displacement update at a fixed level: the kernel on a CUDA
    tensor, else :func:`_flow_iteration_plain`."""
    if flow.is_cuda:
        taps = _blur_taps(int(winsize), float(winsize * 0.3), bool(gaussian_win), flow.dtype, flow.device)
        return flow_windows.flow_update(exp1[:5].contiguous(), exp2[:5].contiguous(), flow.contiguous(), taps)
    return _flow_iteration_plain(exp1, exp2, flow, winsize, gaussian_win)


def _flow_iteration_plain(exp1: Tensor, exp2: Tensor, flow: Tensor, winsize: int, gaussian_win: bool) -> Tensor:
    """One displacement update at a fixed level. ``exp1``/``exp2`` are
    (5 or 6, ..., H, W) expansions, ``flow`` the stacked (2, ..., H, W) field
    (d_row, d_col); returns the new one.

    Pairs of fields travel stacked, so each line below is one launch for
    both: with M = [[A_xx, A_xy/2], [A_xy/2, A_yy]] (symmetric) the update
    solves (M^T M) d = M db, db = -0.5 (b2 - b1) + M d, every product in
    ``pdx``'s order."""
    H, W = exp1.shape[-2], exp1.shape[-1]
    grid = _pixel_grid(H, W, flow.dtype, flow.device).view((2,) + (1,) * (flow.ndim - 3) + (H, W))
    # one fetch of the five fields (axx, ayy, axy, bx, by) of frame 2 at x + d
    fetched = sample_reflect_xy(exp2[:5], grid + flow)
    A = 0.5 * (exp1[:3] + fetched[:3])  # A_xx, A_yy, A_xy
    diag, half = A[:2], 0.5 * A[2]  # (A_xx, A_yy), A_xy / 2
    db = (diag * flow + half * flow.flip(0)) - 0.5 * (fetched[3:] - exp1[3:5])  # (db_x, db_y)

    # the normal equations, aggregated over the window
    a_diag = diag * diag + half * half  # (a11, a22)
    a12 = half * (A[0] + A[1])
    h = diag * db + half * db.flip(0)  # (h1, h2)
    agg = _blur_plain(torch.cat([a_diag, a12[None], h]), winsize, winsize * 0.3, gaussian_win)
    a_diag, a12, h = agg[:2], agg[2], agg[3:]

    det = a_diag[0] * a_diag[1] - a12 * a12 + 1e-12
    return (a_diag.flip(0) * h - a12 * h.flip(0)) / det


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
    n = poly_n // 2

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
            exp1 = _poly_exp(to_shape(img1, shp), n, poly_sigma)
            exp2 = _poly_exp(to_shape(img2, shp), n, poly_sigma)
            if flow is None:
                flow = torch.zeros((2,) + img1.shape[:-2] + shp, dtype=img1.dtype, device=img1.device)
            else:
                up = resize_bilinear(flow, shp[0], shp[1])
                flow = torch.stack([up[0] * (shp[0] / flow.shape[-2]), up[1] * (shp[1] / flow.shape[-1])])
            for _ in range(iterations):
                flow = _flow_iteration(exp1, exp2, flow, winsize, gaussian_win)
            count("farneback.iterations", iterations)

    # re-warp refinement at full resolution; exp1 is the finest level's
    for _ in range(int(refine)):
        with span("farneback.refine"):
            expw = _warped_poly_exp(img2, flow, n, poly_sigma)
            d = torch.zeros_like(flow)
            for _ in range(2):
                d = _flow_iteration(exp1, expw, d, winsize, gaussian_win)
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
        fs = _blur(torch.stack([fx, fy]), ksize, sigma, True).to(cur.dtype)
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
    grid = _pixel_grid(H, W, fx.dtype, fx.device).view((2,) + (1,) * (fxs.ndim - 3) + (H, W))
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
    sm = _blur(torch.stack([fx, fy], dim=1), ksize, sigma, True)  # (T-1, 2, H, W)
    fx, fy = sm[:, 0], sm[:, 1]
    if not to_first:
        fx, fy = compose_flow_chain(fx, fy)
    warped = warp_flow_batch(U[1:], fx.to(U.dtype), fy.to(U.dtype))
    return torch.cat([U[:1], warped], dim=0)
