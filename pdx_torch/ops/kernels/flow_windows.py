"""The Farnebäck flow's windowed passes as hand-written CUDA kernels
(``pdx_torch/csrc/farneback.cu``): the polynomial expansion (of a frame, or
of a frame warped by the flow), the flow update and the window blur of
``register/farneback.py``.

They replace no TPU kernel (``pdx`` leaves these passes to XLA). Their
plain versions are ``register/farneback``'s ``_poly_exp_plain``,
``_flow_iteration_plain`` and ``_blur_plain`` (and the expansion of
``warp_flow``'s warp for a re-warp pass), which the CPU takes; these
wrappers take CUDA tensors alone and launch or raise. Each kernel walks
column strips of a plane down the rows with a ring of rows in shared
memory (the source's header says how); the wrappers choose the segments
from the shape and the card's occupancy. Each launch adds 1 to the
tracer's count ``<wrapper>.launches`` and runs on PyTorch's current
stream, so a CUDA graph's capture takes the kernels in.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch import Tensor

from pdx_torch.ops.kernels.fused_gram import _check_smem, _launch_device
from pdx_torch.utils.profiling import count

KIND_BLUR, KIND_POLY, KIND_UPDATE, KIND_WARPED_POLY = 0, 1, 2, 3
_NAMES = ("window_blur", "poly_expansion", "flow_update", "warped_poly_expansion")
_ROWS = 8  # kRows: virtual rows a CTA takes in a step
_STRIP = 32  # kStrip: output columns of a CTA's strip
_MIN_SEGMENT = 2 * _ROWS  # fewest rows a segment takes (its halo rows are recomputed)
_WAVES = 2  # resident CTAs' worth of CTAs the segments aim at


@functools.cache
def _plan(kind: int, f64: int, B: int, H: int, W: int, K: int, device: torch.device) -> tuple[int, int, int]:
    """(S, n_strips, n_segs): strips of ``_STRIP`` columns, segments of S rows,
    about ``_WAVES`` times the CTAs the card holds at once, no segment under
    ``_MIN_SEGMENT`` rows; checked against the card's shared memory. Cached,
    so a call spends no host time on it once the shape has been seen."""
    from pdx_torch.ops.kernels._build import library

    lib = library()
    _check_smem(lib.pdx_flow_windows_smem_bytes(kind, f64, K), device, _NAMES[kind])
    regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
    with _launch_device(device):
        rc = lib.pdx_flow_windows_occupancy(kind, f64, K, ctypes.byref(regs), ctypes.byref(ctas))
    if rc != 0 or ctas.value < 1:
        raise RuntimeError(f"{_NAMES[kind]}: no CTA of this launch shape fits an SM (CUDA error {rc})")
    slots = torch.cuda.get_device_properties(device).multi_processor_count * ctas.value
    n_strips = -(-W // _STRIP)
    want = max(1, -(-_WAVES * slots // (B * n_strips)))
    S = max(_MIN_SEGMENT, -(-H // want))
    S = -(-S // _ROWS) * _ROWS
    return S, n_strips, -(-H // S)


def _check(name: str, taps: Tensor, per_tap: int, *tensors: Tensor) -> int:
    """Every tensor on one CUDA device, of one type (float32 or float64),
    contiguous; ``taps`` 1-D, ``per_tap`` values for each of an odd number
    K of taps. Returns K."""
    t0 = tensors[0]
    for t in (*tensors, taps):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: takes CUDA tensors only (the plain version takes the CPU's); got {t.device}")
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t0.device} and {t.device}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != t0.dtype:
            raise TypeError(f"{name}: float32 or float64 tensors of one type; got {t0.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if t0.ndim < 2:
        raise ValueError(f"{name}: needs (..., H, W); got {tuple(t0.shape)}")
    K = taps.shape[0] // per_tap if taps.ndim == 1 and taps.shape[0] % per_tap == 0 else 0
    if K < 1 or K % 2 == 0:
        raise ValueError(f"{name}: taps of shape {tuple(taps.shape)} give no odd tap count")
    return K


def _launch(kind: int, K: int, src: Tensor, exp2: Tensor | None, flow: Tensor | None, taps: Tensor,
            out: Tensor) -> Tensor:
    """Launch ``kind`` over src's planes (the trailing two axes of
    ``src[0]`` for the update, whose leading axis is the expansion's
    fields) on the current stream; count it."""
    from pdx_torch.ops.kernels._build import library

    plane_shape = src.shape[1:] if kind == KIND_UPDATE else src.shape
    H, W = plane_shape[-2], plane_shape[-1]
    B = math.prod(plane_shape[:-2])
    if out.numel() == 0:
        return out
    f64 = int(src.dtype == torch.float64)
    S, n_strips, n_segs = _plan(kind, f64, B, H, W, K, src.device)
    with _launch_device(src.device):
        rc = library().pdx_flow_windows(
            kind, f64, src.data_ptr(), exp2.data_ptr() if exp2 is not None else None,
            flow.data_ptr() if flow is not None else None, taps.data_ptr(), out.data_ptr(),
            B, H, W, K, S, n_strips, n_segs, torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{_NAMES[kind]}: CUDA launch failed with error {rc}")
    count(f"{_NAMES[kind]}.launches")
    return out


def window_blur(f: Tensor, taps: Tensor) -> Tensor:
    """``f`` (..., H, W) correlated with the odd-length ``taps`` along H,
    then W, symmetric border: ``_blur_plain``'s function."""
    K = _check("window_blur", taps, 1, f)
    return _launch(KIND_BLUR, K, f, None, None, taps, torch.empty_like(f))


def poly_expansion(f: Tensor, taps: Tensor) -> Tensor:
    """(5, ..., H, W): the expansion coefficients (axx, ayy, axy, bx, by) of
    ``f`` (..., H, W), ``_poly_exp_plain``'s first five planes. ``taps``:
    ``register/farneback._poly_exp_taps``, 18K values for K = 2n + 1."""
    K = _check("poly_expansion", taps, 18, f)
    return _launch(KIND_POLY, K, f, None, None, taps, f.new_empty((5,) + f.shape))


def warped_poly_expansion(f: Tensor, flow: Tensor, taps: Tensor) -> Tensor:
    """(5, ..., H, W): :func:`poly_expansion` of ``f`` (..., H, W) warped by
    the stacked flow (2, ..., H, W), f(x + flow(x)) with ``warp_flow``'s
    bilinear reflect-101 fetch, without the warped frame in memory."""
    K = _check("warped_poly_expansion", taps, 18, f, flow)
    if flow.shape != (2,) + f.shape:
        raise ValueError(f"warped_poly_expansion: a frame (..., H, W) and a flow (2, ..., H, W) of its shape; "
                         f"got {tuple(f.shape)}, {tuple(flow.shape)}")
    return _launch(KIND_WARPED_POLY, K, f, None, flow, taps, f.new_empty((5,) + f.shape))


def flow_update(exp1: Tensor, exp2: Tensor, flow: Tensor, taps: Tensor) -> Tensor:
    """One displacement update, ``_flow_iteration_plain``'s function: the
    expansions ``exp1``, ``exp2`` (5, ..., H, W) of the two frames, the
    stacked flow (2, ..., H, W) and the window's ``taps``; returns the new
    flow (2, ..., H, W)."""
    K = _check("flow_update", taps, 1, exp1, exp2, flow)
    if exp1.shape[0] != 5 or exp2.shape != exp1.shape or flow.shape != (2,) + exp1.shape[1:]:
        raise ValueError(f"flow_update: expansions (5, ..., H, W) and a flow (2, ..., H, W) of one plane shape; "
                         f"got {tuple(exp1.shape)}, {tuple(exp2.shape)}, {tuple(flow.shape)}")
    return _launch(KIND_UPDATE, K, exp1, exp2, flow, taps, torch.empty_like(flow))
