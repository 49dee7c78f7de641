"""Finite-difference stencils on the trailing two axes.

Port of ``pdx/ops/fd.py``. The periodic stencils (KS convention:
axis -2 is "x", the rows; axis -1 is "y", the columns) use ``torch.roll``,
which has ``jnp.roll``'s semantics. The non-periodic ones serve the
real-image pipelines: the reflect-101 same-grid derivatives of
``analyze_results.py:302-315`` (x = columns there), ``np.gradient``'s
one-sided edges, and notebook 02's 4th-order stencils. The operation order
is ``pdx``'s, so float64 results agree to the last bits; leading axes are a
batch.
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


def _gradient_edge1(f: Tensor, h: float, dim: int) -> Tensor:
    """``jnp.gradient`` along ``dim`` (one-sided first-order edges), in its
    operation order: ``(f[2:] - f[:-2]) * 0.5 / h`` inside."""
    n = f.shape[dim]
    upper = (f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)) / h
    inner = (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) * 0.5 / h
    lower = (f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)) / h
    return torch.cat([upper, inner, lower], dim=dim)


def gradients_central_interior(f: Tensor, dx: float, dy: float) -> tuple[Tensor, Tensor]:
    """Central differences inside, one-sided at the edges: ``np.gradient``
    with edge_order=1 along axis -2 (dx) and axis -1 (dy)."""
    return _gradient_edge1(f, dx, f.ndim - 2), _gradient_edge1(f, dy, f.ndim - 1)


def gradient_edge2(f: Tensor, d: float, axis: int) -> Tensor:
    """``np.gradient(..., edge_order=2)`` along ``axis``: central inside,
    3-point second-order one-sided stencils at the two ends."""
    f = torch.movedim(f, axis, -1)
    interior = (f[..., 2:] - f[..., :-2]) / (2.0 * d)
    first = (-3.0 * f[..., 0] + 4.0 * f[..., 1] - f[..., 2]) / (2.0 * d)
    last = (3.0 * f[..., -1] - 4.0 * f[..., -2] + f[..., -3]) / (2.0 * d)
    out = torch.cat([first[..., None], interior, last[..., None]], dim=-1)
    return torch.movedim(out, -1, axis)


def _reflect101_neighbours(f: Tensor, dim: int) -> tuple[Tensor, Tensor]:
    """(f[i + 1], f[i - 1]) along ``dim`` under reflect-101 padding
    (``np.pad(mode="reflect")``): f[n] is f[n - 2] and f[-1] is f[1]."""
    n = f.shape[dim]
    nxt = torch.cat([f.narrow(dim, 1, n - 1), f.narrow(dim, n - 2, 1)], dim=dim)
    prv = torch.cat([f.narrow(dim, 1, 1), f.narrow(dim, 0, n - 1)], dim=dim)
    return nxt, prv


def derivs_2d_reflect(f: Tensor, dx: float, dy: float) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Same-grid (u_x, u_y, u_xx, u_yy) by second-order central differences
    on the reflect-101 padded field. Real-image convention: x is the
    column axis (-1), y the row axis (-2)."""
    fcol_p, fcol_m = _reflect101_neighbours(f, f.ndim - 1)
    frow_p, frow_m = _reflect101_neighbours(f, f.ndim - 2)
    ux = (fcol_p - fcol_m) / (2.0 * dx)
    uy = (frow_p - frow_m) / (2.0 * dy)
    uxx = (fcol_p - 2.0 * f + fcol_m) / (dx * dx)
    uyy = (frow_p - 2.0 * f + frow_m) / (dy * dy)
    return ux, uy, uxx, uyy


def gradients_4th_order(f: Tensor, dx: float, dy: float) -> tuple[Tensor, Tensor]:
    """4th-order central first derivatives with periodic wrap:
    (-f[i+2] + 8 f[i+1] - 8 f[i-1] + f[i-2]) / (12 h)."""
    r = torch.roll
    gx = (-r(f, -2, -2) + 8.0 * r(f, -1, -2) - 8.0 * r(f, 1, -2) + r(f, 2, -2)) / (12.0 * dx)
    gy = (-r(f, -2, -1) + 8.0 * r(f, -1, -1) - 8.0 * r(f, 1, -1) + r(f, 2, -1)) / (12.0 * dy)
    return gx, gy


def second_derivs_4th_order(f: Tensor, dx: float, dy: float) -> tuple[Tensor, Tensor]:
    """4th-order central second derivatives with periodic wrap:
    (-f[i+2] + 16 f[i+1] - 30 f[i] + 16 f[i-1] - f[i-2]) / (12 h^2)."""
    r = torch.roll
    gxx = (-r(f, -2, -2) + 16.0 * r(f, -1, -2) - 30.0 * f + 16.0 * r(f, 1, -2) - r(f, 2, -2)) / (12.0 * dx * dx)
    gyy = (-r(f, -2, -1) + 16.0 * r(f, -1, -1) - 30.0 * f + 16.0 * r(f, 1, -1) - r(f, 2, -1)) / (12.0 * dy * dy)
    return gxx, gyy


def d4_1d_periodic(f: Tensor, dx: float) -> Tensor:
    """4th derivative, 2nd-order accurate, periodic, on the trailing axis:
    (f[i+2] - 4 f[i+1] + 6 f[i] - 4 f[i-1] + f[i-2]) / dx^4."""
    r = torch.roll
    return (r(f, -2, -1) - 4.0 * r(f, -1, -1) + 6.0 * f - 4.0 * r(f, 1, -1) + r(f, 2, -1)) / (dx**4)
