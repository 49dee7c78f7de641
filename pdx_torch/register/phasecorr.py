"""FFT phase correlation with subpixel (weighted-centroid) peak refinement.

Port of ``pdx/register/phasecorr.py:26-144``, the counterpart of
cv2.phaseCorrelate without a Hanning window: cross-power spectrum
R = F1 conj(F2) / |F1 conj(F2)|, inverse FFT, integer argmax, a 5x5
weighted centroid around the peak with wrap-around indexing, and
centre-origin unwrapping. Leading axes are batched (one FFT for every frame
pair), where ``pdx`` uses ``vmap``.

Stabilisation takes ``pdx``'s two borders: ``border="wrap"`` with
``smooth="periodic"`` (the KS-2D benchmark), and the reflect-101 shift with
scipy's Gaussian for the estimate (``border="reflect"``,
``smooth="reflect"``; the real-image variant).
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.ops.filters import gaussian_filter_reflect
from pdx_torch.ops.interp import shift_periodic, shift_reflect
from pdx_torch.ops.spectral import gaussian_smooth_periodic


def phase_correlate(ref: Tensor, mov: Tensor) -> tuple[Tensor, Tensor]:
    """(dr, dc): the translation of ``mov`` relative to ``ref`` in (row, col)
    array coordinates, i.e. mov ~= ref shifted by (dr, dc). ``ref`` and
    ``mov`` broadcast over their leading axes."""
    H, W = mov.shape[-2], mov.shape[-1]
    R = torch.fft.fft2(ref) * torch.conj(torch.fft.fft2(mov))
    mag = torch.abs(R)
    R = torch.where(mag > 0, R / (mag + 1e-30), torch.zeros_like(R))
    cc = torch.fft.ifft2(R).real

    flat = torch.argmax(cc.reshape(cc.shape[:-2] + (-1,)), dim=-1)
    pr = flat // W
    pc = flat % W

    # 5x5 weighted centroid around the peak with wrap indexing
    offs = torch.arange(-2, 3, device=cc.device)
    rr = torch.remainder(pr[..., None] + offs, H)  # (..., 5)
    ccol = torch.remainder(pc[..., None] + offs, W)
    cb = cc.reshape((-1, H, W))
    b = torch.arange(cb.shape[0], device=cc.device)[:, None, None]
    patch = cb[b, rr.reshape(-1, 5)[:, :, None], ccol.reshape(-1, 5)[:, None, :]]
    patch = torch.clamp(patch.reshape(cc.shape[:-2] + (5, 5)), min=0.0)
    wsum = torch.sum(patch, dim=(-2, -1)) + 1e-30
    dr_off = torch.sum(patch * offs[:, None], dim=(-2, -1)) / wsum
    dc_off = torch.sum(patch * offs[None, :], dim=(-2, -1)) / wsum

    peak_r = pr.to(cc.dtype) + dr_off
    peak_c = pc.to(cc.dtype) + dc_off
    # a correlation peak at +s means mov is ref shifted by -s: unwrap, negate
    peak_r = torch.where(peak_r > H / 2, peak_r - H, peak_r)
    peak_c = torch.where(peak_c > W / 2, peak_c - W, peak_c)
    return -peak_r, -peak_c


def estimate_shift_phasecorr(ref: Tensor, mov: Tensor) -> tuple[Tensor, Tensor]:
    """(sx, sy): the shift to apply to ``mov`` (with ``shift_periodic``) so
    that it aligns with ``ref``."""
    dr, dc = phase_correlate(ref, mov)
    return -dr, -dc


def estimate_interframe_shifts(U: Tensor, *, estimate_sigma_px: float = 0.0) -> tuple[Tensor, Tensor]:
    """Frame-to-frame shifts (t -> t+1), all T-1 pairs in one batched FFT."""
    Us = gaussian_smooth_periodic(U, estimate_sigma_px) if estimate_sigma_px > 0 else U
    dr, dc = phase_correlate(Us[:-1], Us[1:])
    return -dr, -dc


def stabilize_translation_sequence(
    U: Tensor,
    *,
    mode: str = "to_first",
    estimate_sigma_px: float = 0.0,
    border: str = "wrap",
    smooth: str = "periodic",
) -> Tensor:
    """Undo global translations of a (T, H, W) stack by phase correlation.

    ``to_first`` aligns every frame to frame 0 (one batched correlation and
    one batched shift); ``to_prev`` aligns each frame to the previous
    aligned one, a loop over frames where ``pdx`` has ``lax.scan``.
    ``border="wrap"`` shifts periodically, any other border by reflect-101;
    ``smooth="periodic"`` blurs the estimate spectrally, any other value by
    scipy's reflect Gaussian.
    """
    if mode not in {"to_first", "to_prev"}:
        raise ValueError("unknown stabilization mode: use 'to_first' or 'to_prev'")
    sigma = float(estimate_sigma_px)

    def smooth_fn(x: Tensor) -> Tensor:
        if sigma <= 0:
            return x
        if smooth == "periodic":
            return gaussian_smooth_periodic(x, sigma)
        return gaussian_filter_reflect(x, sigma)

    shift_fn = shift_periodic if border == "wrap" else shift_reflect

    if mode == "to_first":
        dr, dc = phase_correlate(smooth_fn(U[0]), smooth_fn(U[1:]))
        aligned = shift_fn(U[1:], -dr, -dc)
        return torch.cat([U[:1], aligned], dim=0)

    ref_est = smooth_fn(U[0])
    out = [U[0]]
    for mov in U[1:]:
        dr, dc = phase_correlate(ref_est, smooth_fn(mov))
        shifted = shift_fn(mov, -dr, -dc)
        ref_est = smooth_fn(shifted)
        out.append(shifted)
    return torch.stack(out, dim=0)
