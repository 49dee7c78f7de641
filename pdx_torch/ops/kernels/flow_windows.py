"""The Farnebäck flow's windowed passes (``register/farneback.py``): the
polynomial expansion (of a frame, or of a frame warped by the flow), the
flow update and the window blur, as hand-written CUDA kernels
(``pdx_torch/csrc/farneback.cu``) and as their plain PyTorch versions.

They replace no TPU kernel (``pdx`` leaves these passes to XLA). The plain
versions are the ``*_reference`` functions: on the CPU the separable passes
are one product of sliding windows each (``ops/filters.symmetric_windows``),
where ``pdx`` adds shifted copies tap by tap, the same sums in another
order. Each wrapper takes the pass's own parameters, runs the plain version
on a CPU tensor, and on a CUDA tensor launches its kernel or raises. Each
kernel walks column strips of a plane down the rows with a ring of rows in
shared memory (the source's header says how); the wrappers choose the
segments from the shape and the card's occupancy. Each launch adds 1 to
the tracer's count ``<wrapper>.launches`` and runs on PyTorch's current
stream, so a CUDA graph's capture takes the kernels in.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.filters import correlate1d_symmetric, symmetric_windows
from pdx_torch.ops.interp import pixel_grid, sample_reflect_xy, warp_flow
from pdx_torch.ops.kernels._build import check_smem, launch_device, library
from pdx_torch.utils.graphs import constant_cache
from pdx_torch.utils.profiling import count

KIND_BLUR, KIND_POLY, KIND_UPDATE, KIND_WARPED_POLY = 0, 1, 2, 3
_NAMES = ("window_blur", "poly_expansion", "flow_update", "warped_poly_expansion")
_ROWS = 8  # kRows: virtual rows a CTA takes in a step
_STRIP = 32  # kStrip: output columns of a CTA's strip
_MIN_SEGMENT = 2 * _ROWS  # fewest rows a segment takes (its halo rows are recomputed)
_WAVES = 2  # resident CTAs' worth of CTAs the segments aim at

# moments in basis order [1, dr, dc, dr^2, dc^2, dr*dc]:
# (row kernel, col kernel) = (g,g) (gx,g) (g,gx) (gxx,g) (g,gxx) (gx,gx)
_ROW_OF_MOMENT = (0, 1, 0, 2, 0, 1)  # index into the row kernels [g, gx, gxx]
_COL_OF_MOMENT = (0, 0, 1, 0, 2, 1)  # index into the col kernels [g, gx, gxx]
# expansion output order (axx, ayy, axy, bx, by, c) as basis indices
_EXP_ORDER = [3, 4, 5, 1, 2, 0]


# --- the operators and taps ------------------------------------------------------


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


@constant_cache(maxsize=32)
def _blur_taps(ksize: int, sigma: float, gaussian: bool, dtype: torch.dtype, device: torch.device) -> Tensor:
    """The window's ``ksize`` taps: a normalised Gaussian of ``sigma``
    (OPTFLOW_FARNEBACK_GAUSSIAN) or a box."""
    n = ksize // 2
    if gaussian:
        x = np.arange(-n, n + 1, dtype=np.float64)
        k = np.exp(-(x**2) / (2.0 * sigma * sigma))
        k /= k.sum()
    else:
        k = np.full(2 * n + 1, 1.0 / (2 * n + 1))
    return torch.as_tensor(k, dtype=dtype, device=device)


# --- the plain versions ---------------------------------------------------------


def poly_expansion_reference(f: Tensor, poly_n: int, poly_sigma: float) -> Tensor:
    """Polynomial expansion of f (..., H, W) over a ``poly_n``-pixel window
    -> (6, ..., H, W) coefficients in the order (axx, ayy, axy, bx, by, c):
    b is the gradient, A the quadratic form, f ~ c + b.d + d^T A d with
    d = (d_row, d_col). The five fields the flow update fetches come first,
    so they are one slice."""
    Kr, M = _poly_exp_operators(poly_n // 2, float(poly_sigma), f.dtype, f.device)
    K = Kr.shape[0]
    H, W = f.shape[-2], f.shape[-1]
    R = (symmetric_windows(f, K, f.ndim - 2) @ Kr).transpose(-3, -2)  # (..., H, W, 3)
    win = symmetric_windows(R, K, R.ndim - 2)  # (..., H, 3, W, K)
    coef = win.transpose(-3, -2).reshape(f.shape[:-2] + (H, W, 3 * K)) @ M  # (..., H, W, 6)
    return coef.movedim(-1, 0).contiguous()


def warped_poly_expansion_reference(f: Tensor, flow: Tensor, poly_n: int, poly_sigma: float) -> Tensor:
    """:func:`poly_expansion_reference` of ``f`` warped by the stacked flow
    (2, ..., H, W): f(x + flow(x)), ``warp_flow``'s bilinear reflect-101
    fetch."""
    return poly_expansion_reference(warp_flow(f, flow[0], flow[1]), poly_n, poly_sigma)


def window_blur_reference(f: Tensor, ksize: int, sigma: float, gaussian: bool) -> Tensor:
    """Window aggregation blur on the trailing two axes, symmetric border:
    Gaussian (OPTFLOW_FARNEBACK_GAUSSIAN) or box, as two products of
    sliding windows."""
    k = _blur_taps(int(ksize), float(sigma), bool(gaussian), f.dtype, f.device)
    return correlate1d_symmetric(correlate1d_symmetric(f, k, f.ndim - 2), k, f.ndim - 1)


def flow_update_reference(exp1: Tensor, exp2: Tensor, flow: Tensor, winsize: int, gaussian_win: bool) -> Tensor:
    """One displacement update at a fixed level. ``exp1``/``exp2`` are
    (5 or 6, ..., H, W) expansions, ``flow`` the stacked (2, ..., H, W) field
    (d_row, d_col); returns the new one.

    Pairs of fields travel stacked, so each line below is one launch for
    both: with M = [[A_xx, A_xy/2], [A_xy/2, A_yy]] (symmetric) the update
    solves (M^T M) d = M db, db = -0.5 (b2 - b1) + M d, every product in
    ``pdx``'s order; the normal equations are aggregated over a
    ``winsize`` window (Gaussian of sigma 0.3 winsize, or a box)."""
    H, W = exp1.shape[-2], exp1.shape[-1]
    grid = pixel_grid(H, W, flow.dtype, flow.device).view((2,) + (1,) * (flow.ndim - 3) + (H, W))
    # one fetch of the five fields (axx, ayy, axy, bx, by) of frame 2 at x + d
    fetched = sample_reflect_xy(exp2[:5], grid + flow)
    A = 0.5 * (exp1[:3] + fetched[:3])  # A_xx, A_yy, A_xy
    diag, half = A[:2], 0.5 * A[2]  # (A_xx, A_yy), A_xy / 2
    db = (diag * flow + half * flow.flip(0)) - 0.5 * (fetched[3:] - exp1[3:5])  # (db_x, db_y)

    # the normal equations, aggregated over the window
    a_diag = diag * diag + half * half  # (a11, a22)
    a12 = half * (A[0] + A[1])
    h = diag * db + half * db.flip(0)  # (h1, h2)
    agg = window_blur_reference(torch.cat([a_diag, a12[None], h]), winsize, winsize * 0.3, gaussian_win)
    a_diag, a12, h = agg[:2], agg[2], agg[3:]

    det = a_diag[0] * a_diag[1] - a12 * a12 + 1e-12
    return (a_diag.flip(0) * h - a12 * h.flip(0)) / det


# --- the kernels ------------------------------------------------------------------


@functools.cache
def _plan(kind: int, f64: int, B: int, H: int, W: int, K: int, device: torch.device) -> tuple[int, int, int]:
    """(S, n_strips, n_segs): strips of ``_STRIP`` columns, segments of S rows,
    about ``_WAVES`` times the CTAs the card holds at once, no segment under
    ``_MIN_SEGMENT`` rows; checked against the card's shared memory. Cached,
    so a call spends no host time on it once the shape has been seen."""
    lib = library()
    check_smem(lib.pdx_flow_windows_smem_bytes(kind, f64, K), device, _NAMES[kind])
    regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
    with launch_device(device):
        rc = lib.pdx_flow_windows_occupancy(kind, f64, K, ctypes.byref(regs), ctypes.byref(ctas))
    if rc != 0 or ctas.value < 1:
        raise RuntimeError(f"{_NAMES[kind]}: no CTA of this launch shape fits an SM (CUDA error {rc})")
    slots = torch.cuda.get_device_properties(device).multi_processor_count * ctas.value
    n_strips = -(-W // _STRIP)
    want = max(1, -(-_WAVES * slots // (B * n_strips)))
    S = max(_MIN_SEGMENT, -(-H // want))
    S = -(-S // _ROWS) * _ROWS
    return S, n_strips, -(-H // S)


def _check(name: str, *tensors: Tensor) -> None:
    """Every tensor on one device, of one type (float32 or float64), the
    first (..., H, W)."""
    t0 = tensors[0]
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t0.device} and {t.device}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != t0.dtype:
            raise TypeError(f"{name}: float32 or float64 tensors of one type; got {t0.dtype} and {t.dtype}")
    if t0.ndim < 2:
        raise ValueError(f"{name}: needs (..., H, W); got {tuple(t0.shape)}")


def _launch(kind: int, K: int, src: Tensor, exp2: Tensor | None, flow: Tensor | None, taps: Tensor,
            out: Tensor) -> Tensor:
    """Launch ``kind`` over src's planes (the trailing two axes of
    ``src[0]`` for the update, whose leading axis is the expansion's
    fields) on the current stream; count it."""
    plane_shape = src.shape[1:] if kind == KIND_UPDATE else src.shape
    H, W = plane_shape[-2], plane_shape[-1]
    B = math.prod(plane_shape[:-2])
    if out.numel() == 0:
        return out
    f64 = int(src.dtype == torch.float64)
    S, n_strips, n_segs = _plan(kind, f64, B, H, W, K, src.device)
    with launch_device(src.device):
        rc = library().pdx_flow_windows(
            kind, f64, src.data_ptr(), exp2.data_ptr() if exp2 is not None else None,
            flow.data_ptr() if flow is not None else None, taps.data_ptr(), out.data_ptr(),
            B, H, W, K, S, n_strips, n_segs, torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{_NAMES[kind]}: CUDA launch failed with error {rc}")
    count(f"{_NAMES[kind]}.launches")
    return out


# --- the wrappers -----------------------------------------------------------------


def window_blur(f: Tensor, ksize: int, sigma: float, gaussian: bool) -> Tensor:
    """:func:`window_blur_reference`'s function: ``f`` (..., H, W)
    correlated with the ``ksize`` window's taps along H, then W."""
    if f.device.type == "cpu":
        return window_blur_reference(f, ksize, sigma, gaussian)
    f = f.contiguous()
    _check("window_blur", f)
    taps = _blur_taps(int(ksize), float(sigma), bool(gaussian), f.dtype, f.device)
    return _launch(KIND_BLUR, taps.shape[0], f, None, None, taps, torch.empty_like(f))


def poly_expansion(f: Tensor, poly_n: int, poly_sigma: float) -> Tensor:
    """(5, ..., H, W): the expansion coefficients (axx, ayy, axy, bx, by) of
    ``f`` (..., H, W) that the flow update reads, the first five planes of
    :func:`poly_expansion_reference`."""
    if f.device.type == "cpu":
        return poly_expansion_reference(f, poly_n, poly_sigma)[:5]
    f = f.contiguous()
    _check("poly_expansion", f)
    taps = _poly_exp_taps(poly_n // 2, float(poly_sigma), f.dtype, f.device)
    return _launch(KIND_POLY, taps.shape[0] // 18, f, None, None, taps, f.new_empty((5,) + f.shape))


def warped_poly_expansion(f: Tensor, flow: Tensor, poly_n: int, poly_sigma: float) -> Tensor:
    """(5, ..., H, W): :func:`poly_expansion` of ``f`` (..., H, W) warped by
    the stacked flow (2, ..., H, W), as a re-warp pass takes it; on the card
    without the warped frame in memory (the warp is the kernel's front)."""
    if f.device.type == "cpu":
        return warped_poly_expansion_reference(f, flow, poly_n, poly_sigma)[:5]
    f, flow = f.contiguous(), flow.contiguous()
    _check("warped_poly_expansion", f, flow)
    if flow.shape != (2,) + f.shape:
        raise ValueError(f"warped_poly_expansion: a frame (..., H, W) and a flow (2, ..., H, W) of its shape; "
                         f"got {tuple(f.shape)}, {tuple(flow.shape)}")
    taps = _poly_exp_taps(poly_n // 2, float(poly_sigma), f.dtype, f.device)
    return _launch(KIND_WARPED_POLY, taps.shape[0] // 18, f, None, flow, taps, f.new_empty((5,) + f.shape))


def flow_update(exp1: Tensor, exp2: Tensor, flow: Tensor, winsize: int, gaussian_win: bool) -> Tensor:
    """One displacement update, :func:`flow_update_reference`'s function:
    the expansions ``exp1``, ``exp2`` (5 or 6, ..., H, W) of the two frames
    and the stacked flow (2, ..., H, W); returns the new flow."""
    if flow.device.type == "cpu":
        return flow_update_reference(exp1, exp2, flow, winsize, gaussian_win)
    exp1, exp2, flow = exp1[:5].contiguous(), exp2[:5].contiguous(), flow.contiguous()
    _check("flow_update", exp1, exp2, flow)
    if exp1.shape[0] != 5 or exp2.shape != exp1.shape or flow.shape != (2,) + exp1.shape[1:]:
        raise ValueError(f"flow_update: expansions (5, ..., H, W) and a flow (2, ..., H, W) of one plane shape; "
                         f"got {tuple(exp1.shape)}, {tuple(exp2.shape)}, {tuple(flow.shape)}")
    taps = _blur_taps(int(winsize), float(winsize * 0.3), bool(gaussian_win), flow.dtype, flow.device)
    return _launch(KIND_UPDATE, taps.shape[0], exp1, exp2, flow, taps, torch.empty_like(flow))
