"""Single-trajectory rollout RMSE curves (port of
``pdx/validate/rollout.py:481-534``).

An eager loop replaces ``lax.scan``; the per-step errors stay on the device
and are stacked once at the end, so the host reads the curve in one copy.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from pdx_torch.ops.fd import gradients_periodic, laplacian_periodic


def rollout_rmse_curve(
    U: Tensor, rhs: Callable[[Tensor], Tensor], n_steps: int, dt: float
) -> Tensor:
    """Rollout from U[0]: errs[k] = rmse(U[k+1], u_hat_k)."""
    u = U[0]
    errs = []
    for k in range(n_steps):
        u = u + dt * rhs(u)
        errs.append(torch.sqrt(torch.mean((U[k + 1] - u) ** 2)))
    return torch.stack(errs)


def rollout_rmse_curve_named(
    U: Tensor, coeffs, names: list[str], n_steps: int, dt: float, dx: float, dy: float
) -> Tensor:
    """:func:`rollout_rmse_curve` for the periodic term-map RHS
    sum_i coeffs[i] * term_i(u) over the KS term vocabulary."""
    c = torch.as_tensor(coeffs, dtype=U.dtype, device=U.device)

    def rhs(u: Tensor) -> Tensor:
        ux, uy = gradients_periodic(u, dx, dy)
        lap = laplacian_periodic(u, dx, dy)
        vals = {
            "one": lambda: torch.ones_like(u), "u": lambda: u, "u2": lambda: u**2,
            "ux": lambda: ux, "uy": lambda: uy, "lap": lambda: lap,
            "bih": lambda: laplacian_periodic(lap, dx, dy),
            "gradsq": lambda: ux**2 + uy**2, "u_lap": lambda: u * lap,
        }
        out = torch.zeros_like(u)
        for i, name in enumerate(names):
            out = out + c[i] * vals[name]()
        return out

    return rollout_rmse_curve(U, rhs, n_steps, dt)
