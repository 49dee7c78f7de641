"""Periodic finite-difference stencils on the trailing two axes.

Port of ``pdx/ops/fd.py`` (periodic part). Axis -2 is "x" (rows), axis -1 is
"y" (cols); ``torch.roll`` has ``jnp.roll``'s semantics, and the operation
order is the reference's, so f64 results agree to the last bits.
"""

from __future__ import annotations

import torch
from torch import Tensor


def gradients_periodic(f: Tensor, dx: float, dy: float) -> tuple[Tensor, Tensor]:
    """Central-difference gradient with periodic wrap."""
    gx = (torch.roll(f, -1, -2) - torch.roll(f, 1, -2)) / (2.0 * dx)
    gy = (torch.roll(f, -1, -1) - torch.roll(f, 1, -1)) / (2.0 * dy)
    return gx, gy


def laplacian_periodic(f: Tensor, dx: float, dy: float) -> Tensor:
    """5-point Laplacian with periodic wrap."""
    return (
        (torch.roll(f, -1, -2) - 2.0 * f + torch.roll(f, 1, -2)) / (dx * dx)
        + (torch.roll(f, -1, -1) - 2.0 * f + torch.roll(f, 1, -1)) / (dy * dy)
    )


def biharmonic_periodic(f: Tensor, dx: float, dy: float) -> Tensor:
    """Biharmonic = laplacian(laplacian(f)) with periodic wrap."""
    return laplacian_periodic(laplacian_periodic(f, dx, dy), dx, dy)
