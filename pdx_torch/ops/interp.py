"""Bilinear sampling and subpixel periodic shifts on the trailing two axes.

Port of ``pdx/ops/interp.py:96-120`` (``bilinear_sample_periodic``) and
``:436-458`` (``shift_periodic``). Coordinates are in array-axis convention:
``x`` indexes axis -2 (rows), ``y`` axis -1 (cols). The reflect-border
samplers, warps and resizes of that module come with slice 3 of the port.
"""

from __future__ import annotations

import torch
from torch import Tensor


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
