"""The DIS flow's per-level passes (``register/dis.py``): the
inverse-compositional Lucas-Kanade search of every patch of the grid, and
the densification of the patches' weighted displacements into a dense
flow, as hand-written CUDA kernels (``pdx_torch/csrc/dis.cu``) and as their
plain PyTorch versions.

They replace no TPU kernel (``pdx`` leaves DIS to XLA). The plain versions
are the ``*_reference`` functions. The patches lie on a regular grid (side
``psize``, stride ``stride``, from 0), so the plain passes cut them by
``unfold``, and the sum over the patches covering a pixel is
``torch.nn.functional.fold``, a gather per output pixel. ``pdx``
scatter-adds (``.at[].add``); a scatter-add on the card (``index_put_`` with
``accumulate``, ``scatter_add_``) adds in float atomics, whose order, and so
the flow, changes from run to run. The kernels gather in a fixed order too.

Each wrapper runs the plain version on a CPU tensor, and on a CUDA tensor
launches its kernel or raises. A launch runs on PyTorch's current stream
and reads nothing back to the host (the search's damping stays on the
card), so a CUDA graph's capture takes the kernels in. Each call adds 1 to
the tracer's count ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.interp import bilinear_sample_reflect
from pdx_torch.ops.kernels._build import launch_device, library
from pdx_torch.utils.profiling import count

KIND_SEARCH, KIND_DENSIFY = 0, 1
_NAMES = ("dis_inverse_search", "dis_densify")
MAX_PATCH = 8  # kMaxPatch in csrc/dis.cu: the kernels hold at most 2 pixels of a patch a lane
SCRATCH = 1024 + 1  # kPartials + 1 in csrc/dis.cu: the Hessian pass's partial sums, then the damping


# --- the patch grid ---------------------------------------------------------------


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


# --- the plain versions ---------------------------------------------------------


def inverse_search_reference(ref: Tensor, mov: Tensor, init_fx: Tensor, init_fy: Tensor, psize: int, stride: int,
                             iters: int) -> Tensor:
    """(3, P) = (w u, w v, w) of the patches of the (H, W) level: each
    patch's translation (u, v) by ``iters`` inverse-compositional
    Lucas-Kanade iterations from the initial flow at its centre, and its
    residual weight w."""
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
    return torch.stack([wgt * u, wgt * v, wgt])


def densify_reference(vals: Tensor, init_fx: Tensor, init_fy: Tensor, psize: int, stride: int) -> tuple[Tensor, Tensor]:
    """The dense flow (fx, fy) of the patches' (w u, w v, w) (3, P): each
    pixel sums the weighted displacements of the patches covering it and
    divides by their weights; pixels no patch covers (right / bottom margin)
    keep the initial flow."""
    H, W = init_fx.shape
    acc_u, acc_v, acc_w = _densify(vals, H, W, psize, stride)
    fx = acc_u / (acc_w + 1e-12)
    fy = acc_v / (acc_w + 1e-12)
    covered = acc_w > 0
    fx = torch.where(covered, fx, init_fx)
    fy = torch.where(covered, fy, init_fy)
    return fx, fy


# --- the kernels ------------------------------------------------------------------


def _check(name: str, psize: int, stride: int, *planes: Tensor) -> tuple[int, int]:
    """Every plane (H, W) of one shape, device and type (float32 or
    float64), and a patch grid the kernels take: (H, W)."""
    t0 = planes[0]
    for t in planes:
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != t0.dtype:
            raise TypeError(f"{name}: float32 or float64 planes of one type; got {t0.dtype} and {t.dtype}")
        if t.device != t0.device or t.shape != t0.shape or t.ndim != 2:
            raise ValueError(f"{name}: (H, W) planes of one shape on one device; got {tuple(t0.shape)} on "
                             f"{t0.device} and {tuple(t.shape)} on {t.device}")
    H, W = t0.shape
    if not (1 <= psize <= min(MAX_PATCH, H, W) and stride >= 1 and min(H, W) >= 2):
        raise ValueError(f"{name}: patches of side 1 to {MAX_PATCH} within a plane of at least 2 x 2, stride >= 1; "
                         f"got side {psize}, stride {stride} on {H} x {W}")
    return H, W


def _n_patches(H: int, W: int, psize: int, stride: int) -> int:
    return ((H - psize) // stride + 1) * ((W - psize) // stride + 1)


def _launch(kind: int, src: Tensor, mov: Tensor | None, init_fx: Tensor, init_fy: Tensor, scratch: Tensor | None,
            out: Tensor, psize: int, stride: int, iters: int) -> Tensor:
    """Launch ``kind`` on the current stream; count it."""
    H, W = init_fx.shape
    with launch_device(src.device):
        rc = library().pdx_dis(
            kind, int(src.dtype == torch.float64), src.data_ptr(), mov.data_ptr() if mov is not None else None,
            init_fx.data_ptr(), init_fy.data_ptr(), scratch.data_ptr() if scratch is not None else None,
            out.data_ptr(), H, W, psize, stride, iters, torch.cuda.current_stream(src.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{_NAMES[kind]}: CUDA launch failed with error {rc}")
    count(f"{_NAMES[kind]}.launches")
    return out


# --- the wrappers -----------------------------------------------------------------


def dis_inverse_search(ref: Tensor, mov: Tensor, init_fx: Tensor, init_fy: Tensor, psize: int, stride: int,
                       iters: int) -> Tensor:
    """:func:`inverse_search_reference`'s (3, P) = (w u, w v, w) of the
    patches of the level ``ref``, ``mov`` (H, W) from the initial flow
    ``init_fx``, ``init_fy`` (H, W)."""
    if ref.device.type == "cpu":
        return inverse_search_reference(ref, mov, init_fx, init_fy, psize, stride, iters)
    ref, mov, init_fx, init_fy = (t.contiguous() for t in (ref, mov, init_fx, init_fy))
    H, W = _check("dis_inverse_search", psize, stride, ref, mov, init_fx, init_fy)
    if iters < 0:
        raise ValueError(f"dis_inverse_search: iterations >= 0; got {iters}")
    out = ref.new_empty((3, _n_patches(H, W, psize, stride)))
    return _launch(KIND_SEARCH, ref, mov, init_fx, init_fy, ref.new_empty(SCRATCH), out, psize, stride, iters)


def dis_densify(vals: Tensor, init_fx: Tensor, init_fy: Tensor, psize: int, stride: int) -> tuple[Tensor, Tensor]:
    """:func:`densify_reference`'s dense flow (fx, fy) (H, W) of the
    patches' (w u, w v, w) (3, P) over the initial flow."""
    if vals.device.type == "cpu":
        return densify_reference(vals, init_fx, init_fy, psize, stride)
    vals, init_fx, init_fy = (t.contiguous() for t in (vals, init_fx, init_fy))
    H, W = _check("dis_densify", psize, stride, init_fx, init_fy)
    P = _n_patches(H, W, psize, stride)
    if vals.dtype != init_fx.dtype:
        raise TypeError(f"dis_densify: values of the flow's type {init_fx.dtype}; got {vals.dtype}")
    if vals.device != init_fx.device or vals.shape != (3, P):
        raise ValueError(f"dis_densify: values (3, {P}) on {init_fx.device}; got {tuple(vals.shape)} on {vals.device}")
    out = init_fx.new_empty((2, H, W))
    _launch(KIND_DENSIFY, vals, None, init_fx, init_fy, None, out, psize, stride, 0)
    return out[0], out[1]
