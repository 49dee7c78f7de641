"""KS candidate-term dictionaries as stacked (p, T, H, W) tensors.

Port of ``pdx/library/dictionaries.py:29-114, 275``: finite-difference
(periodic stencils) or spectral (FFT, optional radial low-pass
``spectral_cutoff``) derivatives.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.ops.fd import gradients_periodic, laplacian_periodic
from pdx_torch.ops.spectral import gradients_spectral, laplacian_spectral

# Ground-truth KS coefficients
KS_GROUND_TRUTH = {"lap": -1.0, "bih": -1.0, "gradsq": -0.5}

# canonical ASCII term keys <-> the reference's display names
TERM_DISPLAY = {
    "one": "1",
    "u": "u",
    "u2": "u^2",
    "u3": "u^3",
    "ux": "u_x",
    "uy": "u_y",
    "uxx": "u_xx",
    "uyy": "u_yy",
    "lap": "∇²u",
    "bih": "∇⁴u",
    "gradsq": "|∇u|²",
    "u_lap": "u·∇²u",
    "u_ux": "u·u_x",
    "u_uy": "u·u_y",
    "ux2": "u_x²",
    "uy2": "u_y²",
}


def _ks_derivative_fields(
    U: Tensor, dx: float, dy: float, *, deriv: str, spectral_cutoff: float
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(ux, uy, lap, bih) for a (T, H, W) stack, periodic BCs."""
    if deriv == "spectral":
        ux, uy = gradients_spectral(U, dx, dy, cutoff_frac=spectral_cutoff)
        lap = laplacian_spectral(U, dx, dy, cutoff_frac=spectral_cutoff)
        bih = laplacian_spectral(lap, dx, dy, cutoff_frac=spectral_cutoff)
        return ux, uy, lap, bih
    if deriv != "finite":
        raise ValueError(f"deriv must be 'finite' or 'spectral', got '{deriv}'")
    ux, uy = gradients_periodic(U, dx, dy)
    lap = laplacian_periodic(U, dx, dy)
    bih = laplacian_periodic(lap, dx, dy)
    return ux, uy, lap, bih


def build_dictionary_true(
    U: Tensor,
    dx: float,
    dy: float,
    *,
    deriv: str = "finite",
    spectral_cutoff: float = 1.0,
    include_advection: bool = False,
) -> tuple[list[str], Tensor]:
    """KS true terms [lap, bih, gradsq] (+ ux, uy). Returns (names, terms)."""
    ux, uy, lap, bih = _ks_derivative_fields(
        U, dx, dy, deriv=deriv, spectral_cutoff=spectral_cutoff
    )
    gradsq = ux**2 + uy**2
    names = ["lap", "bih", "gradsq"]
    terms = [lap, bih, gradsq]
    if include_advection:
        names += ["ux", "uy"]
        terms += [ux, uy]
    return names, torch.stack(terms, dim=0)


def build_dictionary_rich(
    U: Tensor,
    dx: float,
    dy: float,
    *,
    deriv: str = "finite",
    spectral_cutoff: float = 1.0,
    drop_advection: bool = False,
) -> tuple[list[str], Tensor]:
    """KS rich dictionary [1, u, u^2, u_x, u_y, lap, bih, |grad u|^2, u*lap];
    ``drop_advection`` removes u_x/u_y."""
    ux, uy, lap, bih = _ks_derivative_fields(
        U, dx, dy, deriv=deriv, spectral_cutoff=spectral_cutoff
    )
    gradsq = ux**2 + uy**2
    names = ["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"]
    terms = [torch.ones_like(U), U, U**2, ux, uy, lap, bih, gradsq, U * lap]
    if drop_advection:
        keep = [i for i, n in enumerate(names) if n not in {"ux", "uy"}]
        names = [names[i] for i in keep]
        terms = [terms[i] for i in keep]
    return names, torch.stack(terms, dim=0)


def display_names(names: list[str]) -> list[str]:
    return [TERM_DISPLAY.get(n, n) for n in names]
