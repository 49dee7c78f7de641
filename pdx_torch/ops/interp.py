"""Bilinear sampling, shifts, warps and resizes on the trailing two axes.

Port of ``pdx/ops/interp.py``: ``bilinear_sample_periodic`` (:96-120),
``shift_periodic`` (:436-458), the reflect-101 sampler and its warps
(:123-158, :461-499, :425), ``resize_area`` (:502-542) and
``resize_bilinear`` (:545-567). Coordinates are in array-axis convention:
``x`` indexes axis -2 (rows), ``y`` axis -1 (cols).

``pdx`` lowers the reflect sampler several ways for the TPU (row-folded,
channel-batched and packed gathers, banded matrices); all compute the same
function, and the port has one implementation of each. Its reflect sampler
gathers with ``torch.gather``: coordinates carry their own leading axes,
which broadcast against the field's, so one function serves a shared grid
(``f[..., ix, iy]`` in ``pdx``) and a grid per frame (``pdx``'s batched
samplers). The samplers fold **reflect-101** (the edge sample is not
repeated), as OpenCV's remap border does; the Gaussian filters of
``ops/filters.py`` pad symmetric, as scipy does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from pdx_torch.utils.graphs import constant_cache


def bilinear_sample_periodic(f: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Sample f at fractional coordinates with periodic wrapping.

    ``x`` and ``y`` are float tensors of one shape; the result has shape
    ``f.shape[:-2] + x.shape``.
    """
    H, W = f.shape[-2], f.shape[-1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = (x - x0).to(f.dtype)
    ty = (y - y0).to(f.dtype)
    x0i = torch.remainder(x0.long(), H)
    y0i = torch.remainder(y0.long(), W)
    x1i = torch.remainder(x0i + 1, H)
    y1i = torch.remainder(y0i + 1, W)
    f00 = f[..., x0i, y0i]
    f01 = f[..., x0i, y1i]
    f10 = f[..., x1i, y0i]
    f11 = f[..., x1i, y1i]
    return (
        f00 * (1 - tx) * (1 - ty)
        + f01 * (1 - tx) * ty
        + f10 * tx * (1 - ty)
        + f11 * tx * ty
    )


def shift_periodic(f: Tensor, shift_x: Tensor | float, shift_y: Tensor | float) -> Tensor:
    """Subpixel translation with periodic wrap: out[..., r, c] = f(r - sx, c - sy).

    The shifts are scalars or one per frame: tensors of shape ``f.shape[:-2]``
    (``pdx`` applies one shift per frame with ``vmap``). The result blends
    four periodic rolls, each written as one index gather over the batch
    (``torch.roll`` takes one shift per call), summed in ``pdx``'s order
    f00, f10, f01, f11.
    """
    H, W = f.shape[-2], f.shape[-1]
    lead = f.shape[:-2]
    fb = f.reshape((-1, H, W))
    B = fb.shape[0]
    sx = torch.as_tensor(shift_x, dtype=f.dtype, device=f.device).expand(lead).reshape(B)
    sy = torch.as_tensor(shift_y, dtype=f.dtype, device=f.device).expand(lead).reshape(B)
    i0 = torch.floor(sx).long()
    j0 = torch.floor(sy).long()
    tx = (sx - i0).reshape(B, 1, 1)
    ty = (sy - j0).reshape(B, 1, 1)
    b = torch.arange(B, device=f.device).reshape(B, 1, 1)
    r = torch.arange(H, device=f.device)
    c = torch.arange(W, device=f.device)

    def rolled(di: int, dj: int) -> Tensor:
        # jnp.roll(f, (i, j)): out[r, c] = f[(r - i) mod H, (c - j) mod W]
        rows = torch.remainder(r[None, :] - (i0 + di)[:, None], H)
        cols = torch.remainder(c[None, :] - (j0 + dj)[:, None], W)
        return fb[b, rows[:, :, None], cols[:, None, :]]

    out = (
        rolled(0, 0) * (1 - tx) * (1 - ty)
        + rolled(1, 0) * tx * (1 - ty)
        + rolled(0, 1) * (1 - tx) * ty
        + rolled(1, 1) * tx * ty
    )
    return out.reshape(f.shape)


def _fold101(i: Tensor, n, period):
    """Reflect-101 folding of integer indices for a size n (int or tensor
    broadcasting against i) of the given period."""
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def _reflect101_index(i: Tensor, n: int) -> Tensor:
    """BORDER_REFLECT_101 index folding: ... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...

    Period 2(n-1), any integer input; n == 1 folds everything to 0.
    """
    return _fold101(i, n, max(2 * (n - 1), 1))


@constant_cache(maxsize=64)
def _fold_sizes(H: int, W: int, device: torch.device) -> tuple[Tensor, Tensor]:
    """(n, period) per coordinate row (rows: H, cols: W) for reflect-101
    folding of stacked (x, y) indices; a size of 1 folds everything to 0."""
    n = torch.tensor([H, W], device=device)
    return n, torch.clamp(2 * (n - 1), min=1)


def sample_reflect_xy(f: Tensor, xy: Tensor) -> Tensor:
    """:func:`bilinear_sample_reflect` at stacked coordinates ``xy`` =
    (x, y), shape (2, ..., h, w): every index operation runs once for both
    axes."""
    H, W = f.shape[-2], f.shape[-1]
    p0 = torch.floor(xy)
    t = (xy - p0).to(f.dtype)  # (tx, ty)
    i0 = p0.long()
    shape = (1, 2) + (1,) * (xy.ndim - 1)
    n, period = (v.view(shape) for v in _fold_sizes(H, W, f.device))
    j = _fold101(torch.stack([i0, i0 + 1]), n, period)  # (a|b corner, x|y, ...)
    lead = torch.broadcast_shapes(f.shape[:-2], xy.shape[1:-2])
    hw = xy.shape[-2:]
    idx = (j[:, None, 0] * W + j[None, :, 1]).reshape((2, 2) + (1,) * (len(lead) + 3 - xy.ndim) + xy.shape[1:])
    idx = idx.expand((2, 2) + lead + hw).reshape((2, 2) + lead + (-1,))
    flat = f.reshape(f.shape[:-2] + (H * W,)).expand((2, 2) + lead + (H * W,))
    g = torch.gather(flat, -1, idx).reshape((2, 2) + lead + hw)  # corners (a|b row, a|b col)
    tx, ty = t
    return torch.lerp(torch.lerp(g[0, 0], g[0, 1], ty), torch.lerp(g[1, 0], g[1, 1], ty), tx)


def bilinear_sample_reflect(f: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Sample f (..., H, W) at fractional coordinates with reflect-101
    folding (OpenCV's default remap border in the reference registration).

    ``x`` and ``y`` broadcast against each other to (..., h, w); their
    leading axes broadcast against f's, so the result is
    ``broadcast(f.shape[:-2], x.shape[:-2]) + (h, w)``: coordinates without
    leading axes are shared by every frame of f, coordinates with them
    sample each frame at its own grid. The four corners are one gather; the
    blend is bilinear by ``torch.lerp`` (cols, then rows), which rounds
    differently from ``pdx``'s four weighted products by ~1 ulp.
    """
    return sample_reflect_xy(f, torch.stack(torch.broadcast_tensors(x, y)))


def shift_reflect(f: Tensor, shift_x: Tensor | float, shift_y: Tensor | float) -> Tensor:
    """Subpixel translation with reflect-101 border: out(r, c) = f(r - sx,
    c - sy) (real-image variant, ``analyze_results.py:120-127``). Shifts are
    scalars or one per frame (tensors of shape ``f.shape[:-2]``)."""
    H, W = f.shape[-2], f.shape[-1]
    dtype = torch.promote_types(f.dtype, torch.float32)
    sx = torch.as_tensor(shift_x, dtype=dtype, device=f.device)[..., None, None]
    sy = torch.as_tensor(shift_y, dtype=dtype, device=f.device)[..., None, None]
    r = torch.arange(H, dtype=dtype, device=f.device)[:, None]
    c = torch.arange(W, dtype=dtype, device=f.device)[None, :]
    return bilinear_sample_reflect(f, r - sx, c - sy)


def remap_bilinear(f: Tensor, map_x: Tensor, map_y: Tensor, *, border: str = "reflect") -> Tensor:
    """Backward-map warp: out[r, c] = f(map_x[r, c], map_y[r, c])
    (``cv2.remap`` with INTER_LINEAR; ``border`` "reflect" or "wrap")."""
    if border == "reflect":
        return bilinear_sample_reflect(f, map_x, map_y)
    if border == "wrap":
        return bilinear_sample_periodic(f, map_x, map_y)
    raise ValueError(f"unknown border mode: {border}")


def warp_flow(f: Tensor, flow_x: Tensor, flow_y: Tensor, *, border: str = "reflect") -> Tensor:
    """Warp by a dense backward flow: out(p) = f(p + flow(p)). The flows are
    (H, W), shared by f's leading axes, or carry leading axes of their own
    (reflect border)."""
    H, W = f.shape[-2], f.shape[-1]
    r = torch.arange(H, dtype=flow_x.dtype, device=f.device)[:, None]
    c = torch.arange(W, dtype=flow_x.dtype, device=f.device)[None, :]
    return remap_bilinear(f, r + flow_x, c + flow_y, border=border)


def warp_flow_batch(f: Tensor, flow_x: Tensor, flow_y: Tensor) -> Tensor:
    """Batched backward-flow warp, reflect border: f and flows (B, H, W),
    frame b warped by flow b."""
    return warp_flow(f, flow_x, flow_y, border="reflect")


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) pixel-coverage weights of an INTER_AREA shrink."""
    scale = n_in / n_out
    Wm = np.zeros((n_out, n_in))
    for o in range(n_out):
        a, b = o * scale, (o + 1) * scale
        for i in range(int(np.floor(a)), min(int(np.ceil(b)), n_in)):
            cov = min(b, i + 1) - max(a, i)
            if cov > 0:
                Wm[o, i] = cov / scale
    return Wm


def resize_area(f: Tensor, out_h: int, out_w: int) -> Tensor:
    """cv2.INTER_AREA-style shrink: a block mean for integer factors,
    pixel-coverage weights per axis otherwise.

    Integer frames (uint8 / uint16 camera data) are promoted to float32
    first: the block sums of at most a few 16-bit values are exact there.
    """
    H, W = f.shape[-2], f.shape[-1]
    wdtype = f.dtype if f.is_floating_point() else torch.float32
    f = f.to(wdtype)
    if H % out_h == 0 and W % out_w == 0:
        bh, bw = H // out_h, W // out_w
        return f.reshape(f.shape[:-2] + (out_h, bh, out_w, bw)).mean(dim=(-3, -1))
    Wh = torch.as_tensor(_area_weights(H, out_h), dtype=wdtype, device=f.device)
    Ww = torch.as_tensor(_area_weights(W, out_w), dtype=wdtype, device=f.device)
    return (Wh @ f) @ Ww.T


def resize_matrix(L: int, out: int) -> np.ndarray:
    """(out, L) bilinear-resize matrix (cv2 INTER_LINEAR half-pixel centres,
    edge clamp): the separable factor of :func:`resize_bilinear`."""
    s = L / out
    x = np.clip((np.arange(out) + 0.5) * s - 0.5, 0.0, L - 1.0)
    x0 = np.floor(x).astype(int)
    t = x - x0
    x1 = np.minimum(x0 + 1, L - 1)
    M = np.zeros((out, L))
    np.add.at(M, (np.arange(out), x0), 1.0 - t)
    np.add.at(M, (np.arange(out), x1), t)
    return M


@constant_cache(maxsize=256)
def _resize_matrix_t(L: int, out: int, dtype: torch.dtype, device: torch.device) -> Tensor:
    return torch.as_tensor(resize_matrix(L, out), dtype=dtype, device=device)


def resize_bilinear(f: Tensor, out_h: int, out_w: int) -> Tensor:
    """cv2.INTER_LINEAR resize (half-pixel centres, edge clamp) of the
    trailing two axes. The sampling grid is separable, so the bilinear
    weights factor into two 1-D interpolation matrices: two products, the
    same function as ``pdx``'s gather on the clamped grid."""
    H, W = f.shape[-2], f.shape[-1]
    dtype = torch.promote_types(f.dtype, torch.float32)
    Mh = _resize_matrix_t(H, int(out_h), dtype, f.device)
    Mw = _resize_matrix_t(W, int(out_w), dtype, f.device)
    return (Mh @ f.to(dtype)) @ Mw.T
