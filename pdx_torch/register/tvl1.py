"""TV-L1 optical flow (Zach, Pock & Bischof 2007; port of
``pdx/register/tvl1.py``).

The counterpart of cv2.optflow.DualTVL1OpticalFlow, the reference's
notebook-only third flow backend (notebook 02 cell 10,
``compute_optical_flow(method='tvl1')``). A primal-dual scheme per pyramid
level: repeated warps linearise the data term
rho(u) = I1(x + u0) + (u - u0) . grad I1 - I0; a pointwise thresholding step
solves the L1 data term and a Chambolle dual ascent the TV regularisation.
Every update is elementwise on (H, W) fields, under loops of fixed trip
count (``warps`` x ``inner_iters``), which run here as Python loops.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.ops.interp import bilinear_sample_reflect, resize_bilinear


def _grad(f: Tensor) -> tuple[Tensor, Tensor]:
    """Forward differences with zero at the far edge (the standard TV grid)."""
    gx = torch.cat([f[..., 1:, :] - f[..., :-1, :], torch.zeros_like(f[..., :1, :])], dim=-2)
    gy = torch.cat([f[..., :, 1:] - f[..., :, :-1], torch.zeros_like(f[..., :, :1])], dim=-1)
    return gx, gy


def _div(px: Tensor, py: Tensor) -> Tensor:
    """Adjoint of :func:`_grad` (backward differences)."""
    dx = torch.cat([px[..., :1, :], px[..., 1:-1, :] - px[..., :-2, :], -px[..., -2:-1, :]], dim=-2)
    dy = torch.cat([py[..., :, :1], py[..., :, 1:-1] - py[..., :, :-2], -py[..., :, -2:-1]], dim=-1)
    return dx + dy


def _tv_step(u_data: Tensor, p1: Tensor, p2: Tensor, theta: float, tau: float) -> tuple[Tensor, Tensor]:
    """One Chambolle dual ascent on TV of u_data + theta div(p)."""
    gx, gy = _grad(u_data + theta * _div(p1, p2))
    denom = 1.0 + (tau / theta) * torch.sqrt(gx * gx + gy * gy)
    return (p1 + (tau / theta) * gx) / denom, (p2 + (tau / theta) * gy) / denom


def _tvl1_level(
    I0: Tensor,
    I1: Tensor,
    u: Tensor,
    v: Tensor,
    *,
    lam: float,
    theta: float,
    tau: float,
    warps: int,
    inner_iters: int,
) -> tuple[Tensor, Tensor]:
    H, W = I0.shape[-2], I0.shape[-1]
    dtype = I0.dtype
    r = torch.arange(H, dtype=dtype, device=I0.device)[:, None].expand(H, W)
    c = torch.arange(W, dtype=dtype, device=I0.device)[None, :].expand(H, W)
    I1r, I1c = torch.gradient(I1, dim=(-2, -1), edge_order=1)
    lt_scale = lam * theta
    p11 = p12 = p21 = p22 = torch.zeros_like(I0)
    for _ in range(warps):
        u0, v0 = u, v
        xr = r + u0
        xc = c + v0
        I1w = bilinear_sample_reflect(I1, xr, xc)
        Ix = bilinear_sample_reflect(I1r, xr, xc)  # d/d(row)
        Iy = bilinear_sample_reflect(I1c, xr, xc)  # d/d(col)
        grad2 = Ix * Ix + Iy * Iy + 1e-8
        rho_c = I1w - Ix * u0 - Iy * v0 - I0
        lt = lt_scale * grad2
        for _ in range(inner_iters):
            rho = rho_c + Ix * u + Iy * v
            du = torch.where(rho < -lt, lt_scale * Ix, torch.where(rho > lt, -lt_scale * Ix, -rho * Ix / grad2))
            dv = torch.where(rho < -lt, lt_scale * Iy, torch.where(rho > lt, -lt_scale * Iy, -rho * Iy / grad2))
            u_data = u + du
            v_data = v + dv
            p11, p12 = _tv_step(u_data, p11, p12, theta, tau)
            p21, p22 = _tv_step(v_data, p21, p22, theta, tau)
            u = u_data + theta * _div(p11, p12)
            v = v_data + theta * _div(p21, p22)
    return u, v


def tvl1_flow(
    img1: Tensor,
    img2: Tensor,
    *,
    levels: int = 5,
    lam: float = 0.15,
    theta: float = 0.3,
    tau: float = 0.25,
    warps: int = 5,
    inner_iters: int = 30,
    min_size: int = 16,
) -> tuple[Tensor, Tensor]:
    """Dense flow (flow_r, flow_c): img1(x) ~ img2(x + flow(x)).

    The defaults are cv2.DualTVL1OpticalFlow_create's.
    """
    H, W = img1.shape[-2], img1.shape[-1]
    shapes = [(H, W)]
    for _ in range(1, levels):
        h2, w2 = shapes[-1][0] // 2, shapes[-1][1] // 2
        if min(h2, w2) < min_size:
            break
        shapes.append((h2, w2))

    u = torch.zeros(shapes[-1], dtype=img1.dtype, device=img1.device)
    v = torch.zeros(shapes[-1], dtype=img1.dtype, device=img1.device)
    for shp in reversed(shapes):
        i1 = resize_bilinear(img1, shp[0], shp[1]) if shp != (H, W) else img1
        i2 = resize_bilinear(img2, shp[0], shp[1]) if shp != (H, W) else img2
        if (u.shape[-2], u.shape[-1]) != shp:
            u = resize_bilinear(u, shp[0], shp[1]) * (shp[0] / u.shape[-2])
            v = resize_bilinear(v, shp[0], shp[1]) * (shp[1] / v.shape[-1])
        u, v = _tvl1_level(i1, i2, u, v, lam=lam, theta=theta, tau=tau, warps=warps, inner_iters=inner_iters)
    return u, v
