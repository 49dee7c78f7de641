"""Candidate-term dictionaries as stacked (p, T, H, W) tensors.

Port of ``pdx/library/dictionaries.py``: the KS dictionaries from
finite-difference (periodic stencils) or spectral (FFT, optional radial
low-pass ``spectral_cutoff``) derivatives, and the real-image term fields
(reflect-101 derivatives for Models 1-6, notebook 02's 25-term 4th-order
library for Model 7) as dicts of same-shape fields.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.ops.fd import derivs_2d_reflect, gradients_periodic, laplacian_periodic
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


# ---------------------------------------------------------------------------
# Real-image model families (non-periodic derivatives)
# ---------------------------------------------------------------------------

# Nested model term sets (analyze_results.py:598-624). Models 1 and 2 are
# the same set in the reference; kept so the numbering lines up.
REAL_MODEL_TERMS: dict[int, list[str]] = {
    1: ["one", "u", "lap"],
    2: ["one", "u", "lap"],
    3: ["one", "u", "ux", "uy", "lap"],
    4: ["one", "u", "ux", "uy", "lap", "u2"],
    5: ["one", "u", "ux", "uy", "uxx", "uyy", "lap", "u2", "u_ux", "u_uy"],
    6: ["one", "u", "ux", "uy", "uxx", "uyy", "lap", "u2", "u_ux", "u_uy", "u3", "ux2", "uy2"],
}

# 13-term registration-study library (pde_discovery_improved_registration.py:411-424)
REGISTRATION_STUDY_TERMS: list[str] = [
    "one", "u", "ux", "uy", "uxx", "uyy", "lap", "u2", "u_ux", "u_uy", "u3", "ux2", "uy2",
]


def real_image_term_fields(U: Tensor, dx: float, dy: float) -> dict[str, Tensor]:
    """Every field of the real-image model families for a (..., H, W)
    stack, from reflect-101 central differences (x = columns)."""
    ux, uy, uxx, uyy = derivs_2d_reflect(U, dx, dy)
    lap = uxx + uyy
    return {
        "one": torch.ones_like(U),
        "u": U,
        "u2": U**2,
        "u3": U**3,
        "ux": ux,
        "uy": uy,
        "uxx": uxx,
        "uyy": uyy,
        "lap": lap,
        "u_ux": U * ux,
        "u_uy": U * uy,
        "ux2": ux**2,
        "uy2": uy**2,
    }


# 25-term 4th-order extended library (notebook 02 cells 8-9)
FOURTH_ORDER_TERMS: list[str] = [
    "one", "u", "ux", "uy", "uxx", "uyy", "lap",
    "u2", "u_ux", "u_uy", "ux2", "uy2", "u_uxx", "u_uyy", "u_lap",
    "u3", "u2_ux", "u2_uy", "uxxx", "uyyy",
    "uxxxx", "uyyyy", "bih", "u_uxxxx", "u_uyyyy",
]

FOURTH_ORDER_DISPLAY = {
    **TERM_DISPLAY,
    "u_uxx": "u·u_xx",
    "u_uyy": "u·u_yy",
    "u2_ux": "u²·u_x",
    "u2_uy": "u²·u_y",
    "uxxx": "u_xxx",
    "uyyy": "u_yyy",
    "uxxxx": "u_xxxx",
    "uyyyy": "u_yyyy",
    "u_uxxxx": "u·u_xxxx",
    "u_uyyyy": "u·u_yyyy",
}


def _edge_pad(U: Tensor, n: int) -> Tensor:
    """``np.pad(mode="edge")`` by n on each side of the trailing two axes."""
    H, W = U.shape[-2], U.shape[-1]
    rows = torch.clamp(torch.arange(-n, H + n, device=U.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-n, W + n, device=U.device), 0, W - 1)
    return U.index_select(U.ndim - 2, rows).index_select(U.ndim - 1, cols)


def fourth_order_term_fields(U: Tensor, dx: float, dy: float) -> dict[str, Tensor]:
    """The 25 fields of notebook 02's 4th-order library (x = columns).

    The notebook's quirk is kept: the 4th-order 1st and 2nd derivatives are
    taken on a 3-pixel edge-padded grid by periodic rolls and cropped back,
    while the 2nd-order 3rd and 4th derivatives roll the unpadded field
    periodically.
    """
    p = _edge_pad(U, 3)
    r = torch.roll

    ux = (-r(p, -2, -1) + 8 * r(p, -1, -1) - 8 * r(p, 1, -1) + r(p, 2, -1)) / (12 * dx)
    uy = (-r(p, -2, -2) + 8 * r(p, -1, -2) - 8 * r(p, 1, -2) + r(p, 2, -2)) / (12 * dy)
    uxx = (-r(p, -2, -1) + 16 * r(p, -1, -1) - 30 * p + 16 * r(p, 1, -1) - r(p, 2, -1)) / (12 * dx**2)
    uyy = (-r(p, -2, -2) + 16 * r(p, -1, -2) - 30 * p + 16 * r(p, 1, -2) - r(p, 2, -2)) / (12 * dy**2)
    ux, uy, uxx, uyy = (f[..., 3:-3, 3:-3] for f in (ux, uy, uxx, uyy))

    uxxx = (r(U, -2, -1) - 2 * r(U, -1, -1) + 2 * r(U, 1, -1) - r(U, 2, -1)) / (2 * dx**3)
    uyyy = (r(U, -2, -2) - 2 * r(U, -1, -2) + 2 * r(U, 1, -2) - r(U, 2, -2)) / (2 * dy**3)
    uxxxx = (r(U, -2, -1) - 4 * r(U, -1, -1) + 6 * U - 4 * r(U, 1, -1) + r(U, 2, -1)) / dx**4
    uyyyy = (r(U, -2, -2) - 4 * r(U, -1, -2) + 6 * U - 4 * r(U, 1, -2) + r(U, 2, -2)) / dy**4

    lap = uxx + uyy
    return {
        "one": torch.ones_like(U),
        "u": U,
        "ux": ux,
        "uy": uy,
        "uxx": uxx,
        "uyy": uyy,
        "lap": lap,
        "u2": U**2,
        "u_ux": U * ux,
        "u_uy": U * uy,
        "ux2": ux**2,
        "uy2": uy**2,
        "u_uxx": U * uxx,
        "u_uyy": U * uyy,
        "u_lap": U * lap,
        "u3": U**3,
        "u2_ux": U**2 * ux,
        "u2_uy": U**2 * uy,
        "uxxx": uxxx,
        "uyyy": uyyy,
        "uxxxx": uxxxx,
        "uyyyy": uyyyy,
        "bih": uxxxx + uyyyy,
        "u_uxxxx": U * uxxxx,
        "u_uyyyy": U * uyyyy,
    }


def stack_terms(fields: dict[str, Tensor], names: list[str]) -> Tensor:
    """Stack named fields into a (p, ...) term tensor."""
    return torch.stack([fields[n] for n in names], dim=0)


def display_names(names: list[str]) -> list[str]:
    return [TERM_DISPLAY.get(n, n) for n in names]
