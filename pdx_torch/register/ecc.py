"""ECC (enhanced correlation coefficient) parametric registration (port of
``pdx/register/ecc.py``).

The counterpart of cv2.findTransformECC with MOTION_EUCLIDEAN /
MOTION_TRANSLATION, as the reference's per-patch registration uses it
(``patch_based_sindy.py:171-196``). Each iteration samples the warped image
and its gradient, builds the steepest-descent images G = grad(Iw) dW/dp and
applies the ECC update (Evangelidis & Psarakis, TPAMI 2008)

  lambda = (||iw||^2 - iw^T PG iw) / (ir^T iw - ir^T PG iw)
  e      = lambda * ir - iw
  dp     = (G^T G)^{-1} G^T e

with ir / iw the zero-mean template / warped image and PG the projector onto
the span of G. A member stops when max|dp| < eps or after ``max_iter``
iterations; its correlation coefficient is the one of its last iteration,
computed before that iteration's update.

``pdx`` runs one ``while_loop`` a frame pair and loops the patches on the
host. Here every field may carry leading batch axes (one patch a member):
each iteration updates the whole batch, and a member's result is frozen at
the iteration where its own loop would have stopped, as
``solve/lasso.fista_gram`` freezes each alpha. The host learns whether any
member still runs after iterations 1, 2, 4, ... up to ``CHECK_EVERY`` and
then every ``CHECK_EVERY`` iterations.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.ops.filters import gaussian_filter_reflect
from pdx_torch.ops.interp import bilinear_sample_reflect, sample_reflect_xy

CHECK_EVERY = 50


def _euclidean_warp_coords(params: Tensor, H: int, W: int):
    """params (..., 3) = (theta, t_row, t_col): x' = R x + t (row / col
    convention). Returns r, c (H, W), xr, xc (..., H, W), cos, sin
    (..., 1, 1)."""
    th, tr, tc = (params[..., i, None, None] for i in range(3))
    r = torch.arange(H, dtype=params.dtype, device=params.device)[:, None].expand(H, W)
    c = torch.arange(W, dtype=params.dtype, device=params.device)[None, :].expand(H, W)
    cos, sin = torch.cos(th), torch.sin(th)
    xr = cos * r - sin * c + tr
    xc = sin * r + cos * c + tc
    return r, c, xr, xc, cos, sin


def _as_euclidean(params: Tensor, motion: str) -> Tensor:
    """Translation params (..., 2) as euclidean (..., 3) with theta = 0."""
    if motion == "euclidean":
        return params
    return torch.cat([torch.zeros_like(params[..., :1]), params], dim=-1)


def _ecc_iterate(
    template: Tensor, image: Tensor, *, motion: str, max_iter: int, eps: float
) -> tuple[Tensor, Tensor, Tensor, int]:
    """The ECC loop of every member of a batch: template and image
    (..., H, W), already smoothed. Returns (params (..., n), cc (...),
    iterations (...), host syncs)."""
    H, W = template.shape[-2], template.shape[-1]
    lead = template.shape[:-2]
    dtype = template.dtype
    n_params = 3 if motion == "euclidean" else 2

    ir = template - torch.mean(template, dim=(-2, -1), keepdim=True)
    ir_norm2 = torch.sum(ir * ir, dim=(-2, -1))
    ir_col = ir.reshape(lead + (H * W, 1))
    gy, gx = torch.gradient(image, dim=(-2, -1), edge_order=1)  # row grad, col grad
    fields = torch.stack([image, gy, gx])  # one gather samples all three
    eye = torch.eye(n_params, dtype=dtype, device=template.device)

    def body(params: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        r, c, xr, xc, cos, sin = _euclidean_warp_coords(_as_euclidean(params, motion), H, W)
        Iw, Gr, Gc = sample_reflect_xy(fields, torch.stack([xr, xc]))
        if motion == "euclidean":
            # d(xr)/dth = -sin*r - cos*c ; d(xc)/dth = cos*r - sin*c
            g_th = Gr * (-sin * r - cos * c) + Gc * (cos * r - sin * c)
            Gs = torch.stack([g_th, Gr, Gc], dim=-3)
        else:
            Gs = torch.stack([Gr, Gc], dim=-3)
        iw = Iw - torch.mean(Iw, dim=(-2, -1), keepdim=True)
        Gf = Gs.reshape(lead + (n_params, H * W))
        GtG = Gf @ Gf.mT
        Gt_iw = Gf @ iw.reshape(lead + (H * W, 1))  # (..., n, 1)
        Gt_ir = Gf @ ir_col
        GtG_inv = torch.linalg.inv_ex(GtG + 1e-10 * eye)[0]  # no error check: no host sync

        iw_norm2 = torch.sum(iw * iw, dim=(-2, -1))
        ir_iw = torch.sum(ir * iw, dim=(-2, -1))
        proj_iw = GtG_inv @ Gt_iw
        num = iw_norm2 - (Gt_iw.mT @ proj_iw)[..., 0, 0]
        den = ir_iw - (Gt_ir.mT @ proj_iw)[..., 0, 0]
        lam = num / torch.where(torch.abs(den) > 1e-12, den, torch.full_like(den, 1e-12))
        e = lam[..., None, None] * ir - iw
        dp = (GtG_inv @ (Gf @ e.reshape(lead + (H * W, 1))))[..., 0]
        cc = ir_iw / (torch.sqrt(ir_norm2 * iw_norm2) + 1e-12)
        done = torch.amax(torch.abs(dp), dim=-1) < eps
        return params + dp, cc, done

    params = torch.zeros(lead + (n_params,), dtype=dtype, device=template.device)
    cc = torch.zeros(lead, dtype=dtype, device=template.device)
    n_iter = torch.zeros(lead, dtype=torch.int64, device=template.device)
    running = torch.ones(lead, dtype=torch.bool, device=template.device)
    next_check, syncs = 1, 0
    for i in range(int(max_iter)):
        new_params, new_cc, done = body(params)
        params = torch.where(running[..., None], new_params, params)
        cc = torch.where(running, new_cc, cc)
        n_iter = n_iter + running
        running = running & ~done
        if i + 1 == next_check:
            syncs += 1
            if not bool(running.any()):
                break
            next_check = min(2 * next_check, next_check // CHECK_EVERY * CHECK_EVERY + CHECK_EVERY)
    return params, cc, n_iter, syncs


def ecc_align_batch(
    template: Tensor,
    image: Tensor,
    *,
    motion: str = "euclidean",
    max_iter: int = 200,
    eps: float = 1e-6,
    gauss_sigma: float = 0.0,
) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`ecc_align` that also returns each member's iterations."""
    if gauss_sigma > 0:
        template = gaussian_filter_reflect(template, gauss_sigma)
        image = gaussian_filter_reflect(image, gauss_sigma)
    params, cc, n_iter, _ = _ecc_iterate(template, image, motion=motion, max_iter=max_iter, eps=eps)
    return params, cc, n_iter


def ecc_align(
    template: Tensor,
    image: Tensor,
    *,
    motion: str = "euclidean",  # euclidean | translation
    max_iter: int = 200,
    eps: float = 1e-6,
    gauss_sigma: float = 0.0,
) -> tuple[Tensor, Tensor]:
    """Estimate warp params aligning ``image`` to ``template`` (..., H, W).

    Returns (params, cc): for euclidean, params = (theta, t_row, t_col) such
    that template(x) ~ image(R x + t); cc is the final correlation
    coefficient. Apply the warp with :func:`ecc_warp`. Leading axes are
    independent members.
    """
    params, cc, _ = ecc_align_batch(
        template, image, motion=motion, max_iter=max_iter, eps=eps, gauss_sigma=gauss_sigma
    )
    return params, cc


def ecc_warp(image: Tensor, params: Tensor, motion: str = "euclidean") -> Tensor:
    """Warp ``image`` by the estimated params so that it aligns to the
    template: out(x) = image(R x + t)."""
    H, W = image.shape[-2], image.shape[-1]
    _r, _c, xr, xc, _cos, _sin = _euclidean_warp_coords(_as_euclidean(params, motion), H, W)
    return bilinear_sample_reflect(image, xr, xc)


def register_sequence_info(
    U: Tensor,
    *,
    motion: str = "euclidean",
    max_iter: int = 200,
    eps: float = 1e-6,
    gauss_sigma: float = 0.0,
    cc_threshold: float = 0.1,
) -> tuple[Tensor, Tensor, Tensor, int]:
    """:func:`ecc_register_sequence` that also returns each step's ECC
    iterations (..., T-1) and the host syncs of all steps."""
    out = torch.empty_like(U)
    out[..., 0, :, :] = U[..., 0, :, :]
    ccs, iters, syncs = [], [], 0
    for t in range(1, U.shape[-3]):
        ref, mov = out[..., t - 1, :, :], U[..., t, :, :]
        if gauss_sigma > 0:
            ref_s, mov_s = gaussian_filter_reflect(torch.stack([ref, mov]), gauss_sigma)
        else:
            ref_s, mov_s = ref, mov
        params, cc, n_iter, s = _ecc_iterate(ref_s, mov_s, motion=motion, max_iter=max_iter, eps=eps)
        ok = (cc >= cc_threshold) & torch.all(torch.isfinite(params), dim=-1)
        out[..., t, :, :] = torch.where(ok[..., None, None], ecc_warp(mov, params, motion=motion), mov)
        ccs.append(cc)
        iters.append(n_iter)
        syncs += s
    T1 = U.shape[-3] - 1
    if T1 == 0:
        empty = U.new_zeros(U.shape[:-3] + (0,))
        return out, empty, empty.to(torch.int64), 0
    return out, torch.stack(ccs, dim=-1), torch.stack(iters, dim=-1), syncs


def ecc_register_sequence(
    U: Tensor,
    *,
    motion: str = "euclidean",
    max_iter: int = 200,
    eps: float = 1e-6,
    gauss_sigma: float = 0.0,
    cc_threshold: float = 0.1,
) -> tuple[Tensor, Tensor]:
    """Sequential warp-to-previous ECC registration of a (..., T, H, W)
    sequence; leading axes are independent sequences (patches), registered
    as one batch.

    Parity: patch_based_sindy.py:171-196 (warp to the previous registered
    frame, quality = mean correlation coefficient). Returns (registered,
    ccs (..., T-1)).

    Divergence guard: the reference keeps the unregistered patch when
    ``cv2.findTransformECC`` raises (patch_based_sindy.py:193-196). The
    iteration here cannot raise, so the fallback is explicit: when the final
    correlation coefficient is below ``cc_threshold`` or the estimated
    params are not finite, the frame passes through unwarped and its cc is
    reported as it is.
    """
    out, ccs, _, _ = register_sequence_info(
        U, motion=motion, max_iter=max_iter, eps=eps, gauss_sigma=gauss_sigma, cc_threshold=cc_threshold
    )
    return out, ccs
