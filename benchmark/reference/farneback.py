"""Plain Farnebäck optical flow (polynomial expansion, Farnebäck 2003) and
the warp-to-previous registration chain, as OpenCV's
calcOpticalFlowFarneback defines them and the laser-matter pipelines call
them.

1. Each image is fitted locally by f(x + d) ~ c + b.d + d^T A d, by
   Gaussian-weighted least squares over a (2n + 1)^2 window: six moment
   images, each two separable correlations, and the inverse normal matrix.
2. At a displacement estimate d(x), with (A1, b1) of the first image at x
   and (A2, b2) of the second at x + d: A = (A1 + A2) / 2, and
   db = A d - (b2 - b1) / 2; the normal equations A^T A d = A^T db are
   summed over a window (Gaussian or box) and solved at each pixel.
3. A pyramid (factor 1/2, at least 8 pixels a side), coarse to fine, the
   flow rescaled between levels, then ``refine`` passes that re-expand the
   warped second image about the residual displacement.

Shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.imaging import correlate, resize_bilinear, sample_reflect, warp

# (row power, column power) of the basis 1, dr, dc, dr^2, dc^2, dr dc
_POWERS = ((0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1))


def poly_expansion(f: torch.Tensor, n: int, sigma: float, tf32: bool = False) -> torch.Tensor:
    """(axx, ayy, axy, bx, by) of f (..., H, W), stacked on a new leading
    axis: f ~ c + bx dr + by dc + axx dr^2 + ayy dc^2 + axy dr dc, x the
    row axis."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g /= g.sum()
    OR, OC = np.meshgrid(x, x, indexing="ij")
    B = np.stack([OR**pr * OC**pc for pr, pc in _POWERS], axis=-1).reshape(-1, 6)
    invG = np.linalg.inv((B * np.outer(g, g).reshape(-1, 1)).T @ B)
    rows = [correlate(f, g * x**k, f.ndim - 2, tf32) for k in range(3)]
    moments = [correlate(rows[pr], g * x**pc, f.ndim - 1, tf32) for pr, pc in _POWERS]
    coef = [sum(float(invG[k, j]) * moments[j] for j in range(6)) for k in range(6)]
    return torch.stack([coef[3], coef[4], coef[5], coef[1], coef[2]])


def _window(x: torch.Tensor, winsize: int, gaussian: bool, tf32: bool = False) -> torch.Tensor:
    n = winsize // 2
    if gaussian:
        s = 0.3 * winsize
        k = np.exp(-(np.arange(-n, n + 1, dtype=np.float64) ** 2) / (2.0 * s * s))
        k /= k.sum()
    else:
        k = np.full(2 * n + 1, 1.0 / (2 * n + 1))
    return correlate(correlate(x, k, x.ndim - 2, tf32), k, x.ndim - 1, tf32)


def flow_update(e1, e2, dr, dc, winsize: int, gaussian: bool, tf32: bool = False):
    """One displacement update at a fixed level: the new (dr, dc). ``e1``
    and ``e2`` are stacked expansions (axx, ayy, axy, bx, by)."""
    H, W = dr.shape[-2:]
    r = torch.arange(H, dtype=dr.dtype, device=dr.device)[:, None]
    c = torch.arange(W, dtype=dc.dtype, device=dc.device)[None, :]
    at = sample_reflect(e2, r + dr, c + dc)  # the five fields of the second image at x + d
    axx = 0.5 * (e1[0] + at[0])
    ayy = 0.5 * (e1[1] + at[1])
    h = 0.25 * (e1[2] + at[2])  # the off-diagonal entry of the symmetric A
    dbx = axx * dr + h * dc - 0.5 * (at[3] - e1[3])
    dby = h * dr + ayy * dc - 0.5 * (at[4] - e1[4])
    # A^T A and A^T db, summed over the window
    a11, a22, a12, h1, h2 = _window(torch.stack([
        axx * axx + h * h, ayy * ayy + h * h, h * (axx + ayy), axx * dbx + h * dby, h * dbx + ayy * dby,
    ]), winsize, gaussian, tf32)
    det = a11 * a22 - a12 * a12 + 1e-12
    return (a22 * h1 - a12 * h2) / det, (a11 * h2 - a12 * h1) / det


def flow(img1, img2, *, levels: int, winsize: int, iterations: int, poly_n: int, poly_sigma: float,
         gaussian: bool, refine: int, pyr_scale: float = 0.5, tf32: bool = False):
    """(flow_r, flow_c) with img2(x + flow(x)) ~ img1(x); leading axes are
    independent pairs. ``tf32``: the correlations' products in TF32."""
    H, W = img1.shape[-2:]
    n = poly_n // 2
    shapes = [(H, W)]
    for _ in range(1, levels):
        h2 = max(int(round(shapes[-1][0] * pyr_scale)), 8)
        w2 = max(int(round(shapes[-1][1] * pyr_scale)), 8)
        if (h2, w2) == shapes[-1]:
            break
        shapes.append((h2, w2))
    dr = dc = None
    for h, w in reversed(shapes):
        a = img1 if (h, w) == (H, W) else resize_bilinear(img1, h, w)
        b = img2 if (h, w) == (H, W) else resize_bilinear(img2, h, w)
        e1, e2 = poly_expansion(a, n, poly_sigma, tf32), poly_expansion(b, n, poly_sigma, tf32)
        if dr is None:
            dr = torch.zeros(img1.shape[:-2] + (h, w), dtype=img1.dtype, device=img1.device)
            dc = torch.zeros_like(dr)
        else:
            ph, pw = dr.shape[-2:]
            dr = resize_bilinear(dr, h, w) * (h / ph)
            dc = resize_bilinear(dc, h, w) * (w / pw)
        for _ in range(iterations):
            dr, dc = flow_update(e1, e2, dr, dc, winsize, gaussian, tf32)
    for _ in range(refine):
        ew = poly_expansion(warp(img2, dr, dc), n, poly_sigma, tf32)
        rr = torch.zeros_like(dr)
        rc = torch.zeros_like(dc)
        for _ in range(2):
            rr, rc = flow_update(e1, ew, rr, rc, winsize, gaussian, tf32)
        dr, dc = dr + rr, dc + rc
    return dr, dc


def register_chain(U: torch.Tensor, *, flow_ds: int, refine: int = 1, tf32: bool = False) -> torch.Tensor:
    """Warp each frame onto the registered frame before it: the float32
    flow (OpenCV's "improved" parameters: 5 levels, window 25 Gaussian, 5
    iterations, poly_n 7, sigma 1.5) of frames shrunk by ``flow_ds``,
    brought back to full size, smoothed by an 11-tap Gaussian (sigma 2),
    and applied to the frame in its own dtype. ``tf32``: the flow's
    products in TF32."""
    H, W = U.shape[-2:]
    f32 = torch.float32 if U.dtype == torch.float64 else U.dtype
    out = torch.empty_like(U)
    out[0] = U[0]
    taps = np.exp(-(np.arange(-5, 6, dtype=np.float64) ** 2) / 8.0)
    taps /= taps.sum()
    for i in range(1, U.shape[0]):
        a, b = out[i - 1].to(f32), U[i].to(f32)
        if flow_ds > 1:
            a, b = resize_bilinear(a, H // flow_ds, W // flow_ds), resize_bilinear(b, H // flow_ds, W // flow_ds)
        fr, fc = flow(a, b, levels=5, winsize=25, iterations=5, poly_n=7, poly_sigma=1.5, gaussian=True,
                      refine=refine, tf32=tf32)
        if flow_ds > 1:
            fr = resize_bilinear(fr, H, W) * (H / fr.shape[-2])
            fc = resize_bilinear(fc, H, W) * (W / fc.shape[-1])
        sm = correlate(correlate(torch.stack([fr, fc]), taps, 1), taps, 2).to(U.dtype)
        out[i] = warp(U[i], sm[0], sm[1])
    return out
