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

Each level's search and densification are ``ops/kernels/dis_patches``'
passes: plain PyTorch on the CPU, hand-written CUDA kernels on the card,
which sum in a fixed order (no float atomics), so that a flow repeats bit
for bit.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.ops.interp import resize_bilinear
from pdx_torch.ops.kernels.dis_patches import dis_densify, dis_inverse_search
from pdx_torch.utils.profiling import count, span


def _level_flow(ref: Tensor, mov: Tensor, init_fx: Tensor, init_fy: Tensor, psize: int, stride: int, iters: int):
    """The flow (fx, fy) of one pyramid level from the initial flow: each
    patch's Lucas-Kanade translation, densified."""
    vals = dis_inverse_search(ref, mov, init_fx, init_fy, psize, stride, iters)
    return dis_densify(vals, init_fx, init_fy, psize, stride)


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

    The call is a span ``dis.flow`` that counts ``dis.flows``; each pyramid
    level a span ``dis.level`` inside it that counts ``dis.levels`` and its
    Lucas-Kanade ``dis.iterations``.
    """
    with span("dis.flow"):
        count("dis.flows")
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
            with span("dis.level"):
                count("dis.levels")
                count("dis.iterations", iterations)
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
