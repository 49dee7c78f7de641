"""Plain image operations for the laser-matter references: separable
correlation under scipy's "reflect" (symmetric) border, OpenCV-style area
and bilinear resizes, and bilinear sampling under the reflect-101 border
that OpenCV's remap uses. Written from the definitions; shares no code
with the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def symmetric_index(L: int, n: int) -> np.ndarray:
    """Indices of a line of length L padded by n a side, the edge sample
    repeated (numpy's "symmetric" padding), folded as often as needed."""
    i = np.arange(-n, L + n)
    while ((i < 0) | (i >= L)).any():
        i = np.where(i < 0, -1 - i, i)
        i = np.where(i >= L, 2 * L - 1 - i, i)
    return i


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero): the operands a TF32 product multiplies."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def correlate(x: torch.Tensor, taps, dim: int, tf32: bool = False) -> torch.Tensor:
    """x correlated along ``dim`` with odd-length ``taps`` (a float64 numpy
    array), symmetric border: out[i] = sum_t taps[t] x[i + t - n]. With
    ``tf32`` (float32 only) the samples and taps are rounded to TF32 first
    and the sums kept in float32, as a TF32 product computes them."""
    taps = np.asarray(taps, dtype=np.float64)
    n = len(taps) // 2
    L = x.shape[dim]
    xp = x.index_select(dim, torch.as_tensor(symmetric_index(L, n), device=x.device))
    if tf32:
        xp = round_tf32(xp)
        taps = round_tf32(torch.as_tensor(taps, dtype=torch.float32)).double().numpy()
    out = float(taps[0]) * xp.narrow(dim, 0, L)
    for t in range(1, len(taps)):
        out.add_(xp.narrow(dim, t, L), alpha=float(taps[t]))
    return out


def gaussian_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return g / g.sum()


def gaussian_filter(x: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter on the last two axes (its defaults)."""
    taps = gaussian_taps(sigma, int(truncate * sigma + 0.5))
    return correlate(correlate(x, taps, x.ndim - 2), taps, x.ndim - 1)


def resize_area(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_AREA shrink by whole factors: the block mean."""
    H, W = x.shape[-2:]
    if H % out_h or W % out_w:
        raise ValueError("the reference's area resize takes whole factors only")
    bh, bw = H // out_h, W // out_w
    return x.reshape(x.shape[:-2] + (out_h, bh, out_w, bw)).mean(dim=(-3, -1))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_LINEAR: half-pixel centres, the edge sample clamped."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + x.shape[-2:]), size=(int(out_h), int(out_w)), mode="bilinear",
                      align_corners=False)
    return y.reshape(lead + (int(out_h), int(out_w)))


def _fold101(i: torch.Tensor, n: int) -> torch.Tensor:
    """... 2 1 | 0 1 ... n-1 | n-2 ... (the edge sample not repeated)."""
    period = max(2 * (n - 1), 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def sample_reflect(f: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """f (..., H, W) at fractional (rows, cols) (..., H, W), bilinear,
    reflect-101 border: each frame at its own coordinates."""
    H, W = f.shape[-2:]
    r0f, c0f = torch.floor(rows), torch.floor(cols)
    tr, tc = (rows - r0f).to(f.dtype), (cols - c0f).to(f.dtype)
    r0, c0 = r0f.long(), c0f.long()
    lead = torch.broadcast_shapes(f.shape[:-2], rows.shape[:-2])
    flat = f.expand(lead + (H, W)).reshape(lead + (H * W,))

    def at(r, c):
        idx = (_fold101(r, H) * W + _fold101(c, W)).expand(lead + (H, W)).reshape(lead + (H * W,))
        return torch.gather(flat, -1, idx).reshape(lead + (H, W))

    return ((1 - tr) * (1 - tc) * at(r0, c0) + (1 - tr) * tc * at(r0, c0 + 1)
            + tr * (1 - tc) * at(r0 + 1, c0) + tr * tc * at(r0 + 1, c0 + 1))


def warp(f: torch.Tensor, flow_r: torch.Tensor, flow_c: torch.Tensor) -> torch.Tensor:
    """out(p) = f(p + flow(p)), reflect-101 border."""
    H, W = f.shape[-2:]
    r = torch.arange(H, dtype=flow_r.dtype, device=f.device)[:, None]
    c = torch.arange(W, dtype=flow_c.dtype, device=f.device)[None, :]
    return sample_reflect(f, r + flow_r, c + flow_c)


def gradient(f: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """numpy.gradient(f, h, axis=dim, edge_order=2)."""
    n = f.shape[dim]
    s = lambda a, k: f.narrow(dim, a, k)  # noqa: E731
    inner = (s(2, n - 2) - s(0, n - 2)) / (2.0 * h)
    first = (-3.0 * s(0, 1) + 4.0 * s(1, 1) - s(2, 1)) / (2.0 * h)
    last = (3.0 * s(n - 1, 1) - 4.0 * s(n - 2, 1) + s(n - 3, 1)) / (2.0 * h)
    return torch.cat([first, inner, last], dim=dim)
