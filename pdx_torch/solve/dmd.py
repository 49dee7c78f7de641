"""Dynamic Mode Decomposition as a denoiser before SINDy (port of
``pdx/solve/dmd.py``; comprehensive_benchmark.py:245-321): standard,
multiscale (frequency-split) and sparse (mode-energy selection) DMD of a
(T, H, W) stack, each returning the reconstructed stack.

The split between device and host is ``pdx``'s, where it decides the
result: the (pixels x frames) SVD and every large product run on the
device in real arithmetic; the r x r eigendecomposition is ``np.linalg.eig``
on the host (LAPACK's eigenvector normalisation sets ``sparse_dmd``'s mode
energies), and so are the r x T Vandermonde rollup and the sparse mode
selection. A complex product ``M @ W`` is the real pair ``(M @ Re W, M @ Im
W)``; the complex least squares for the amplitudes is the real 2N x 2r
stacking ``[[Pr, -Pi], [Pi, Pr]] [br; bi] = [x0; 0]``, solved for its
minimum-norm solution through the SVD with ``jnp.linalg.lstsq``'s cutoff
(``torch.linalg.lstsq`` on CUDA has only a QR driver, which assumes full
rank). Each call copies to the host twice (the operator, then the
amplitudes); ``HOST_SYNCS`` counts the copies.

Singular-vector signs differ between LAPACK and cuSOLVER: flipping column k
of U and row k of Vh flips row and column k of the projected operator, so
its eigenvectors change by the same signs and Phi = M W does not change.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


class SyncCounter:
    """Device-to-host copies made by the DMD calls (each waits for the
    device)."""

    def __init__(self) -> None:
        self.count = 0


HOST_SYNCS = SyncCounter()


def _to_host(t: Tensor) -> np.ndarray:
    HOST_SYNCS.count += 1
    return t.cpu().numpy()


def _project(X1: Tensor, X2: Tensor, r: int) -> tuple[Tensor, Tensor]:
    """SVD-projected operator: M = X2 Vh^T diag(1 / s) (N, r) and Atilde =
    U^T M (r, r). Singular values under the floor are raised to it: 1e-10 in
    float64 (the reference's), s[0] * 100 eps in float32."""
    U, s, Vh = torch.linalg.svd(X1, full_matrices=False)
    U, s, Vh = U[:, :r], s[:r], Vh[:r]
    if X1.dtype.itemsize >= 8:
        floor = torch.tensor(1e-10, dtype=s.dtype, device=s.device)
    else:
        floor = s[0] * torch.finfo(X1.dtype).eps * 100.0
    s_reg = torch.where(s > floor, s, floor)
    M = (X2 @ Vh.mT) * (1.0 / s_reg)  # = (X2 Vh^T) diag(1 / s), product for product
    return M, U.mT @ M


def lstsq_min_norm(A: Tensor, b: Tensor) -> Tensor:
    """Minimum-norm least squares of A x = b through the SVD, as
    ``jnp.linalg.lstsq`` with its default cutoff: singular values below
    eps * max(m, n) * s[0] are dropped."""
    m, n = A.shape
    rcond = torch.finfo(A.dtype).eps * max(m, n)
    u, s, vt = torch.linalg.svd(A, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)), torch.zeros_like(s))
    return (vt.mT @ (s_inv[:, None] * (u.mT @ b[:, None])))[:, 0]


def _amplitudes(Phi_re: Tensor, Phi_im: Tensor, x0: Tensor) -> np.ndarray:
    """Complex b minimising ||Phi b - x0|| for real x0, by the real 2N x 2r
    stacking; (r,) complex on the host (one copy)."""
    A = torch.cat([torch.cat([Phi_re, -Phi_im], dim=1), torch.cat([Phi_im, Phi_re], dim=1)], dim=0)
    sol = _to_host(lstsq_min_norm(A, torch.cat([x0, torch.zeros_like(x0)])))
    r = Phi_re.shape[1]
    return sol[:r] + 1j * sol[r:]


def _vandermonde(eigvals: np.ndarray, b: np.ndarray, T: int) -> np.ndarray:
    """Host: C[:, t] = b * eigvals**t, complex (r, T)."""
    t_pow = eigvals[None, :] ** np.arange(T)[:, None]  # (T, r)
    return (b[None, :] * t_pow).T


def _as_device(a: np.ndarray, like: Tensor) -> Tensor:
    # a copy: ``.imag`` of a real eigenvector matrix is a read-only view
    return torch.from_numpy(np.array(a)).to(like.device, like.dtype)


def _reconstruct(Phi_re: Tensor, Phi_im: Tensor, C: np.ndarray, H: int, W: int) -> Tensor:
    """Re(Phi C) reshaped back to the (T, H, W) stack."""
    recon = Phi_re @ _as_device(C.real, Phi_re) - Phi_im @ _as_device(C.imag, Phi_re)  # (N, T)
    return recon.mT.reshape(-1, H, W).contiguous()


def _prep(data: Tensor, r: int) -> tuple[Tensor, Tensor, Tensor]:
    """Snapshot split and projection: (M, Atilde, x0)."""
    T = data.shape[0]
    X = data.reshape(T, -1).mT
    M, Atilde = _project(X[:, :-1], X[:, 1:], r)
    return M, Atilde, X[:, 0]


def standard_dmd(data: Tensor, rank: int | None = None) -> Tensor:
    """Exact-DMD reconstruction of a (T, H, W) stack
    (comprehensive_benchmark.py:245-270): SVD of X1, projected operator,
    eigenmodes, initial amplitudes by least squares, Vandermonde rollup. The
    rank is min(rank or T - 1, T - 1, T - 2), as in ``pdx``."""
    T, H, W = data.shape
    r = min(rank or (T - 1), T - 1, T - 2)
    M, Atilde, x0 = _prep(data, r)
    eigvals, Wm = np.linalg.eig(_to_host(Atilde))
    Phi_re, Phi_im = M @ _as_device(Wm.real, M), M @ _as_device(Wm.imag, M)
    b = _amplitudes(Phi_re, Phi_im, x0)
    return _reconstruct(Phi_re, Phi_im, _vandermonde(eigvals, b, T), H, W)


def _frequency_split(data: Tensor, cutoff: float) -> tuple[Tensor, Tensor]:
    """Low / high parts of each frame at |k| < cutoff, k in cycles per
    sample (``fftfreq(n)``, unscaled)."""
    from pdx_torch.ops.spectral import _fftfreq

    H, W = data.shape[-2], data.shape[-1]
    KX, KY = torch.meshgrid(_fftfreq(H, 1.0, data.device), _fftfreq(W, 1.0, data.device), indexing="ij")
    low_mask = (torch.sqrt(KX**2 + KY**2) < cutoff).to(data.dtype)
    F = torch.fft.fft2(data)
    return torch.fft.ifft2(F * low_mask).real, torch.fft.ifft2(F * (1.0 - low_mask)).real


def multiscale_dmd(data: Tensor, low_rank: int = 5, high_rank: int = 15, cutoff: float = 0.1) -> Tensor:
    """Frequency-split DMD (comprehensive_benchmark.py:272-295): the low and
    high parts reconstructed at their own ranks, then added."""
    u_low, u_high = _frequency_split(data, cutoff)
    return standard_dmd(u_low, rank=low_rank) + standard_dmd(u_high, rank=high_rank)


def sparse_dmd(data: Tensor, rank: int = 20, sparsity: float = 0.1) -> Tensor:
    """Mode-energy selection DMD (comprehensive_benchmark.py:297-321): the
    modes whose total |Phi| is at or above the (1 - sparsity) percentile are
    kept and re-fitted. The rank is min(rank, T - 1). Phi, the energies and
    the selection are host work, as in ``pdx`` (one copy of M and Atilde
    together)."""
    T, H, W = data.shape
    r = min(rank, T - 1)
    M, Atilde, x0 = _prep(data, r)
    both = _to_host(torch.cat([M, Atilde], dim=0))
    M_h, Atilde_h = both[: M.shape[0]], both[M.shape[0] :]
    eigvals, Wm = np.linalg.eig(Atilde_h)
    Phi = M_h @ Wm  # (N, r) complex
    mode_energies = np.abs(Phi).sum(axis=0)
    keep = mode_energies >= np.percentile(mode_energies, 100 * (1 - sparsity))
    Phi_k, eig_k = Phi[:, keep], eigvals[keep]
    Pr, Pi = _as_device(Phi_k.real, data), _as_device(Phi_k.imag, data)
    b = _amplitudes(Pr, Pi, x0)
    return _reconstruct(Pr, Pi, _vandermonde(eig_k, b, T), H, W)
