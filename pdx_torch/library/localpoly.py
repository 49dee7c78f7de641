"""Local 3-D polynomial derivative estimation, batched (port of
``pdx/library/localpoly.py``).

Fit p(t, x, y) of total degree ``deg`` over a (2rt+1) x (2rs+1) x (2rs+1)
neighbourhood by least squares and read (u, u_t, u_x, u_y, u_xx, u_yy) from
its coefficients. The design matrix depends only on the offset grid, so the
extraction operator E = S pinv(A) is computed once on the host in float64,
and every point's derivatives are one row of a single (N, K) x (K, 6)
product after one flat gather: the minimum-norm least-squares solution the
reference computes per point with ``lstsq``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import Tensor


def poly3d_exponents(deg: int) -> list[tuple[int, int, int]]:
    """Exponents (a, b, c) of t^a x^b y^c in the reference's order
    (patch_based_pde_discovery.py:176-182)."""
    exps: list[tuple[int, int, int]] = []
    for a in range(deg + 1):
        for b in range(deg + 1 - a):
            for c in range(deg + 1 - a - b):
                exps.append((a, b, c))
    return exps


@lru_cache(maxsize=32)
def _extraction_operator(rt: int, rs: int, deg: int, dt: float, dx: float, dy: float) -> np.ndarray:
    """E (K, 6), read-only: flattened neighbourhood values -> (u, ut, ux,
    uy, uxx, uyy). The neighbourhood flattens as meshgrid(t, y, x,
    indexing="ij") with local physical coordinates (t dt, y dy, x dx); the
    design is built on (t, x, y), as the reference calls it."""
    t_off = np.arange(-rt, rt + 1, dtype=np.float64) * dt
    y_off = np.arange(-rs, rs + 1, dtype=np.float64) * dy
    x_off = np.arange(-rs, rs + 1, dtype=np.float64) * dx
    Tt, Yy, Xx = np.meshgrid(t_off, y_off, x_off, indexing="ij")
    t_flat, x_flat, y_flat = Tt.ravel(), Xx.ravel(), Yy.ravel()

    exps = poly3d_exponents(deg)
    A = np.column_stack([(t_flat**a) * (x_flat**b) * (y_flat**c) for a, b, c in exps])
    pinv = np.linalg.pinv(A)  # (n_coefs, K)

    def row(a, b, c, scale=1.0):
        if (a, b, c) not in exps:
            return np.zeros(pinv.shape[1])
        return scale * pinv[exps.index((a, b, c))]

    E = np.stack(
        [row(0, 0, 0), row(1, 0, 0), row(0, 1, 0), row(0, 0, 1), row(0, 2, 0, 2.0), row(0, 0, 2, 2.0)],
        axis=1,
    )
    E.setflags(write=False)  # shared by every caller of the cache
    return E


def local_poly_derivatives_batch(
    U: Tensor,
    points: np.ndarray | Tensor,
    *,
    rt: int,
    rs: int,
    deg: int,
    dt: float,
    dx: float,
    dy: float,
) -> Tensor:
    """Derivatives at a batch of points: ``U`` (T, H, W) indexed U[t, y, x],
    ``points`` (N, 3) integer rows (t0, y0, x0) -> (N, 6) rows (u, u_t,
    u_x, u_y, u_xx, u_yy)."""
    pts = torch.as_tensor(points, device=U.device).long()
    T, H, W = U.shape
    ot = torch.arange(-rt, rt + 1, device=U.device)
    os_ = torch.arange(-rs, rs + 1, device=U.device)
    ti = pts[:, 0:1, None, None] + ot[None, :, None, None]  # (N, Kt, 1, 1)
    yi = pts[:, 1:2, None, None] + os_[None, None, :, None]  # (N, 1, Ks, 1)
    xi = pts[:, 2:3, None, None] + os_[None, None, None, :]  # (N, 1, 1, Ks)
    flat_idx = ((ti * H + yi) * W + xi).reshape(pts.shape[0], -1)  # (N, K)
    vals = U.reshape(-1)[flat_idx]
    E = torch.tensor(_extraction_operator(rt, rs, deg, float(dt), float(dx), float(dy)), dtype=U.dtype, device=U.device)
    return vals @ E
