"""Dense Inverse Search (DIS) optical flow (port of ``pdx/register/dis.py``).

The counterpart of cv2.DISOpticalFlow (PRESET_MEDIUM) as
``register_dis_improved`` uses it (pde_discovery_improved_registration.py:
107-145), after Kroeger et al., ECCV 2016, simplified:

  1. a coarse-to-fine pyramid (factor 2);
  2. at each level a regular grid of patches; each patch estimates a
     translation by inverse-compositional Lucas-Kanade: the reference
     patch's gradient Hessian is fixed, so an iteration is one gather and
     one 2x2 solve for every patch at once;
  3. densification: each pixel averages the displacements of the patches
     covering it, weighted by the inverse patch residual.

The patches lie on a regular grid (size ``ps``, stride ``st``, from 0), so
the patches are cut by ``unfold`` and the sum over the patches covering a
pixel is ``torch.nn.functional.fold``, a gather per output pixel. ``pdx``
scatter-adds (``.at[].add``); a scatter-add on the card (``index_put_`` with
``accumulate``, ``scatter_add_``) adds in float atomics, whose order, and so
the flow, changes from run to run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.interp import bilinear_sample_reflect, resize_bilinear


def _patch_grid_coords(H: int, W: int, psize: int, stride: int) -> np.ndarray:
    """(P, 2) top-left corners of the patch grid, rows first."""
    ys = np.arange(0, max(H - psize, 0) + 1, stride)
    xs = np.arange(0, max(W - psize, 0) + 1, stride)
    YY, XX = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([YY.ravel(), XX.ravel()], axis=1)


def _patches(img: Tensor, psize: int, stride: int) -> Tensor:
    """(P, psize, psize) patches of an (H, W) image on the grid of
    :func:`_patch_grid_coords`."""
    return img.unfold(0, psize, stride).unfold(1, psize, stride).reshape(-1, psize, psize)


def _densify(vals: Tensor, H: int, W: int, psize: int, stride: int) -> Tensor:
    """(C, P) per-patch values -> (C, H, W): at each pixel, the sum of the
    values of the patches covering it (0 where none does), gathered by
    ``fold`` in a fixed order."""
    C, P = vals.shape
    cols = vals[:, None, :].expand(C, psize * psize, P).reshape(1, C * psize * psize, P)
    return torch.nn.functional.fold(cols, (H, W), psize, stride=stride)[0]


def _level_flow(ref: Tensor, mov: Tensor, init_fx: Tensor, init_fy: Tensor, psize: int, stride: int, iters: int):
    H, W = ref.shape
    dtype = ref.dtype
    coords = torch.as_tensor(_patch_grid_coords(H, W, psize, stride), device=ref.device)  # (P, 2)

    dy, dx_ = torch.gradient(ref, dim=(-2, -1), edge_order=1)  # row grad, col grad
    T = _patches(ref, psize, stride)
    Gr = _patches(dy, psize, stride)
    Gc = _patches(dx_, psize, stride)
    # inverse-compositional Hessian per patch (fixed), Tikhonov-damped: flat
    # patches would otherwise amplify noise into spurious flow
    h11 = torch.sum(Gr * Gr, dim=(1, 2))
    h12 = torch.sum(Gr * Gc, dim=(1, 2))
    h22 = torch.sum(Gc * Gc, dim=(1, 2))
    damp = 0.05 * torch.mean(h11 + h22) + 1e-8
    h11 = h11 + damp
    h22 = h22 + damp
    det = h11 * h22 - h12 * h12 + 1e-8

    # each patch starts from the upscaled flow at its centre
    cy = coords[:, 0] + psize // 2
    cx = coords[:, 1] + psize // 2
    u = init_fx[cy, cx]
    v = init_fy[cy, cx]

    offs = torch.arange(psize, dtype=dtype, device=ref.device)
    base_r = (coords[:, 0, None].to(dtype) + offs)[:, :, None].expand(-1, psize, psize)
    base_c = (coords[:, 1, None].to(dtype) + offs)[:, None, :].expand(-1, psize, psize)

    for _ in range(iters):
        Iw = bilinear_sample_reflect(mov, base_r + u[:, None, None], base_c + v[:, None, None])
        r = Iw - T
        g1 = torch.sum(Gr * r, dim=(1, 2))
        g2 = torch.sum(Gc * r, dim=(1, 2))
        du = (h22 * g1 - h12 * g2) / det
        dv = (h11 * g2 - h12 * g1) / det
        u, v = u - du, v - dv

    # residual-based weights for densification
    Iw = bilinear_sample_reflect(mov, base_r + u[:, None, None], base_c + v[:, None, None])
    resid = torch.mean(torch.abs(Iw - T), dim=(1, 2))
    wgt = 1.0 / (resid + 1e-3)

    # densify: each pixel sums the weighted displacements of the patches covering it
    acc_u, acc_v, acc_w = _densify(torch.stack([wgt * u, wgt * v, wgt]), H, W, psize, stride)
    fx = acc_u / (acc_w + 1e-12)
    fy = acc_v / (acc_w + 1e-12)
    # pixels no patch covers (right / bottom margin) keep the initial flow
    covered = acc_w > 0
    fx = torch.where(covered, fx, init_fx)
    fy = torch.where(covered, fy, init_fy)
    return fx, fy


def dis_flow(
    img1: Tensor,
    img2: Tensor,
    *,
    levels: int = 4,
    patch_size: int = 8,
    stride: int = 4,
    iterations: int = 8,
    min_size: int = 16,
) -> tuple[Tensor, Tensor]:
    """Dense flow (flow_r, flow_c) of two (H, W) images:
    img1(x) ~ img2(x + flow(x)).

    The defaults approximate cv2.DISOpticalFlow PRESET_MEDIUM (8x8 patches,
    stride 4 at the finest scale).
    """
    H, W = img1.shape[-2], img1.shape[-1]
    shapes = [(H, W)]
    for _ in range(1, levels):
        h2, w2 = shapes[-1][0] // 2, shapes[-1][1] // 2
        if min(h2, w2) < min_size:
            break
        shapes.append((h2, w2))

    fx = torch.zeros(shapes[-1], dtype=img1.dtype, device=img1.device)
    fy = torch.zeros(shapes[-1], dtype=img1.dtype, device=img1.device)
    for shp in reversed(shapes):
        i1 = resize_bilinear(img1, shp[0], shp[1]) if shp != (H, W) else img1
        i2 = resize_bilinear(img2, shp[0], shp[1]) if shp != (H, W) else img2
        if (fx.shape[-2], fx.shape[-1]) != shp:
            sr = shp[0] / fx.shape[-2]
            sc = shp[1] / fx.shape[-1]
            fx = resize_bilinear(fx, shp[0], shp[1]) * sr
            fy = resize_bilinear(fy, shp[0], shp[1]) * sc
        ps = min(patch_size, min(shp) // 2)
        st = max(1, min(stride, ps // 2))
        fx, fy = _level_flow(i1, i2, fx, fy, ps, st, iterations)
    return fx, fy
