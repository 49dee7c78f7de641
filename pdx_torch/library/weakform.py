"""The weak-form dataset (the integrated identity against test functions).

Port of ``pdx/library/weakform.py``:

  y[t, j]   = (<phi_j, u_{t+1}> - <phi_j, u_t>) / DT
  X_lap     = -k^2 <phi, u>     (Fourier, integration by parts)  or <lap phi, u>
  X_bih     = +k^4 <phi, u>                                     or <bih phi, u>
  X_gsq     = <phi, |grad u|^2>  with spectral low-pass gradients
  optional motion correction: y -= vx <u, phi_x> + vy <u, phi_y>

The inner products are matrix products S = area * U_flat @ Phi^T; the
nonlinear feature is one batched FFT (or one stencil pass) and one product.
``pdx`` computes them with no kernel of its own, and so they are
``torch.matmul`` and ``torch.fft`` here. The test functions are built on the
host in float64 (numpy, ``default_rng(123)`` for the Gaussian centres) and
cast to the frames' dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from pdx_torch.ops.fd import gradients_periodic, laplacian_periodic
from pdx_torch.ops.filters import smooth_1d
from pdx_torch.ops.spectral import gradients_spectral, laplacian_spectral
from pdx_torch.register.phasecorr import estimate_interframe_shifts

TRUE_NAMES = ["lap", "bih", "gradsq"]
RICH_NAMES = ["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"]


def fourier_test_functions(
    nx: int, ny: int, lx: float, ly: float, *, max_k: int, dtype=np.float64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(phis[(P, nx, ny)], k2[(P,)], k4[(P,)]): cos/sin pairs for all
    (m, n) in [0, max_k]^2 without (0, 0)."""
    x = np.linspace(0.0, lx, nx, endpoint=False)
    y = np.linspace(0.0, ly, ny, endpoint=False)
    X, Y = np.meshgrid(x, y, indexing="ij")
    phis, k2s, k4s = [], [], []
    for m in range(0, int(max_k) + 1):
        for n in range(0, int(max_k) + 1):
            if m == 0 and n == 0:
                continue
            kx = 2.0 * np.pi * m / float(lx)
            ky = 2.0 * np.pi * n / float(ly)
            k2 = float(kx**2 + ky**2)
            phase = kx * X + ky * Y
            phis.append(np.cos(phase))
            phis.append(np.sin(phase))
            k2s += [k2, k2]
            k4s += [k2 * k2, k2 * k2]
    return (
        np.stack(phis).astype(dtype),
        np.asarray(k2s, dtype=dtype),
        np.asarray(k4s, dtype=dtype),
    )


def gaussian_test_functions(
    nx: int, ny: int, *, n_phi: int, sigma_px: float, seed: int = 123, dtype=np.float64
) -> np.ndarray:
    """L2-normalized periodic Gaussian bumps at uniform random centres
    (``default_rng(123)``, the reference's seed)."""
    sigma_px = float(sigma_px)
    if sigma_px <= 0:
        raise ValueError("gaussian test functions need a positive sigma_px")
    rng = np.random.default_rng(seed)
    x = np.arange(nx, dtype=np.float64)
    y = np.arange(ny, dtype=np.float64)
    X, Y = np.meshgrid(x, y, indexing="ij")
    phis = []
    for _ in range(int(n_phi)):
        cx = float(rng.uniform(0, nx))
        cy = float(rng.uniform(0, ny))
        dxp = np.minimum(np.abs(X - cx), nx - np.abs(X - cx))
        dyp = np.minimum(np.abs(Y - cy), ny - np.abs(Y - cy))
        phi = np.exp(-0.5 * (dxp**2 + dyp**2) / (sigma_px**2))
        norm = float(np.sqrt(np.sum(phi**2)))
        if norm > 0:
            phi = phi / norm
        phis.append(phi)
    return np.stack(phis).astype(dtype)


def build_weakform_dataset(
    U: Tensor,
    *,
    dx: float,
    dy: float,
    dt_frame: float,
    lx: float,
    ly: float,
    max_k: int = 3,
    basis: str = "gaussian",
    n_phi: int = 64,
    sigma_px: float = 6.0,
    grad_cutoff: float | None = None,
    motion_correct: bool = False,
    motion_est_sigma_px: float = 0.0,
    motion_smooth_window: int = 1,
    motion_clip_px: float | None = None,
    dictionary: str = "true",
    operator: str = "spectral",
) -> tuple[list[str], Tensor, Tensor]:
    """Returns (names, X[(T-1)*P, p], y[(T-1)*P]) on U's device.

    dictionary='true' gives the terms [lap, bih, gradsq]. dictionary='rich'
    expresses every decoy with derivatives moved onto the test functions by
    integration by parts:

        <phi, 1>        constant per phi
        <phi, u>        = S (the base projection)
        <phi, u^2>      one extra product
        <phi, u_x>      = -<phi_x, u>
        <phi, u_y>      = -<phi_y, u>
        <phi, u lap u>  = 1/2 <lap phi, u^2> - <phi, |grad u|^2>

    so only the |grad u|^2 feature ever differentiates the (noisy) data.

    operator='spectral' (default) is the reference's quadrature (FFT
    derivatives, a k-space low-pass ``grad_cutoff`` on the gradient, 0.65
    when None); ``grad_cutoff`` with operator='fd' raises. operator='fd'
    builds discrete-adjoint columns: the periodic 5-point / central stencils
    the finite-difference simulator integrates with, applied to the test
    functions, so that on clean ``save_every=1`` data the weak identity holds
    exactly per Euler step.

    With the Fourier basis the ``one`` column <phi, 1> is exactly zero (the
    basis has zero mean); it is emitted as zeros, not as the round-off of
    the sum, which column standardization would blow up.
    """
    if U.ndim != 3:
        raise ValueError("expected a (T, Nx, Ny) frame stack")
    t_len, nx, ny = U.shape
    if t_len < 2:
        raise ValueError("weak-form targets need >= 2 frames")

    def on_device(a: np.ndarray) -> Tensor:
        return torch.as_tensor(a, dtype=U.dtype, device=U.device)

    k2 = k4 = None
    if basis == "fourier":
        phi_np, k2_np, k4_np = fourier_test_functions(nx, ny, lx, ly, max_k=max_k)
        phi, k2, k4 = on_device(phi_np), on_device(k2_np), on_device(k4_np)
    elif basis == "gaussian":
        phi = on_device(gaussian_test_functions(nx, ny, n_phi=n_phi, sigma_px=sigma_px))
    else:
        raise ValueError("unknown weak-form basis: use 'fourier' or 'gaussian'")

    if operator == "fd":
        # stencils have no spectral cutoff: an explicit value is rejected
        # instead of silently ignored
        if grad_cutoff is not None:
            raise ValueError(
                "grad_cutoff only applies to operator='spectral'; "
                "fd-mode gradients are plain central stencils (leave "
                "grad_cutoff=None with operator='fd')"
            )
    elif operator != "spectral":
        raise ValueError("weakform operator must be 'spectral' or 'fd'")
    if dictionary not in ("true", "rich"):
        raise ValueError("weakform dictionary must be 'true' or 'rich'")
    dx, dy, dt_frame = float(dx), float(dy), float(dt_frame)
    cutoff = float(0.65 if grad_cutoff is None else grad_cutoff)

    if operator == "fd":
        def d_grad(f, cutoff_frac=1.0):
            return gradients_periodic(f, dx, dy)

        def d_lap(f):
            return laplacian_periodic(f, dx, dy)
    else:
        def d_grad(f, cutoff_frac=1.0):
            return gradients_spectral(f, dx, dy, cutoff_frac=float(cutoff_frac))

        def d_lap(f):
            return laplacian_spectral(f, dx, dy, cutoff_frac=1.0)

    P = phi.shape[0]
    area = float(dx * dy)

    def project(F_flat: Tensor, test: Tensor) -> Tensor:
        """area * <test_j, F_t> for every frame t and test function j: (T', P)."""
        return area * (F_flat @ test.reshape(P, -1).T)

    U_flat = U.reshape(t_len, -1)  # (T, N)
    S = project(U_flat, phi)  # (T, P)
    y = (S[1:] - S[:-1]) / dt_frame  # (T-1, P)

    if motion_correct:
        sx_px, sy_px = estimate_interframe_shifts(U, estimate_sigma_px=float(motion_est_sigma_px))
        sx_px = smooth_1d(sx_px, window=int(motion_smooth_window))
        sy_px = smooth_1d(sy_px, window=int(motion_smooth_window))
        if motion_clip_px is not None and float(motion_clip_px) > 0:
            c = float(motion_clip_px)
            sx_px = torch.clamp(sx_px, -c, c)
            sy_px = torch.clamp(sy_px, -c, c)
        vx = (-sx_px * dx) / dt_frame
        vy = (-sy_px * dy) / dt_frame
        phi_x, phi_y = d_grad(phi)
        y = y - (vx[:, None] * project(U_flat[:-1], phi_x) + vy[:, None] * project(U_flat[:-1], phi_y))

    lap_phi = None
    if basis == "fourier" and operator == "spectral":
        X_lap = -S[:-1] * k2[None, :]
        X_bih = S[:-1] * k4[None, :]
    else:
        lap_phi = d_lap(phi)
        X_lap = project(U_flat[:-1], lap_phi)
        X_bih = project(U_flat[:-1], d_lap(lap_phi))

    # nonlinear feature <phi, |grad u|^2>: one batched FFT (spectral) or one
    # stencil pass (fd) over the frame axis
    ux, uy = d_grad(U[:-1], cutoff_frac=cutoff)
    X_gsq = project((ux**2 + uy**2).reshape(t_len - 1, -1), phi)

    if dictionary == "true":
        X = torch.stack([X_lap.reshape(-1), X_bih.reshape(-1), X_gsq.reshape(-1)], dim=1)
        return list(TRUE_NAMES), X, y.reshape(-1)

    Tm1 = t_len - 1
    if basis == "fourier":
        ones_col = torch.zeros((Tm1, P), dtype=U.dtype, device=U.device)
    else:
        ones_col = (area * torch.sum(phi.reshape(P, -1), dim=1))[None, :].expand(Tm1, P)
    U2_flat = (U[:-1] ** 2).reshape(Tm1, -1)
    phi_x, phi_y = d_grad(phi)
    X_ux = -project(U_flat[:-1], phi_x)
    X_uy = -project(U_flat[:-1], phi_y)
    if operator == "fd":
        # direct quadrature with the simulator's own stencil keeps the decoy
        # consistent with the data's discretization (the integration-by-parts
        # identity below mixes quadratures, and a solver exploits the mismatch)
        X_ulap = project((U[:-1] * d_lap(U[:-1])).reshape(Tm1, -1), phi)
    else:
        if lap_phi is None:  # Fourier basis: X_lap came from k^2, not from lap(phi)
            lap_phi = d_lap(phi)
        X_ulap = 0.5 * project(U2_flat, lap_phi) - X_gsq

    cols = [ones_col, S[:-1], project(U2_flat, phi), X_ux, X_uy, X_lap, X_bih, X_gsq, X_ulap]
    X = torch.stack([c.reshape(-1) for c in cols], dim=1)
    return list(RICH_NAMES), X, y.reshape(-1)
