"""Plain reference of the KS-2D ground-truth benchmark.

Explicit-Euler Kuramoto-Sivashinsky u_t = -lap u - lap^2 u - |grad u|^2 / 2
on a periodic grid from a seeded uniform(-0.1, 0.1) start, the forward
difference u_t, the true library [lap u, lap^2 u, |grad u|^2] by periodic
central stencils over every sample, the 5 x 6 alpha x threshold STRidge
grid on RMS-scaled, standardised columns, selection by (R^2, -n_active,
-rmse) and a rollout of the selected model from the first frame.

Written from the equations, every array materialised, in the dtype asked
for; it shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch


def _roll_lap(u, h):
    return (torch.roll(u, 1, -2) + torch.roll(u, -1, -2) + torch.roll(u, 1, -1) + torch.roll(u, -1, -1)
            - 4.0 * u) / (h * h)


def _grad_sq(u, h):
    gx = (torch.roll(u, -1, -2) - torch.roll(u, 1, -2)) / (2.0 * h)
    gy = (torch.roll(u, -1, -1) - torch.roll(u, 1, -1)) / (2.0 * h)
    return gx * gx + gy * gy


def terms(u, h):
    """The true library (lap u, lap^2 u, |grad u|^2) of a field (..., n, n)."""
    lap = _roll_lap(u, h)
    return lap, _roll_lap(lap, h), _grad_sq(u, h)


def simulate(cfg: dict, dtype, device) -> torch.Tensor:
    """(steps, n, n): frame k is the state after k + 1 Euler steps."""
    n, dt = int(cfg["Nx"]), float(cfg["dt"])
    h = float(cfg["Lx"]) / n
    steps = int(float(cfg["n_seconds"]) / dt)
    u = torch.as_tensor(np.random.default_rng(int(cfg["ic_seed"])).uniform(-0.1, 0.1, size=(n, int(cfg["Ny"]))),
                        dtype=dtype, device=device)
    U = torch.empty((steps,) + tuple(u.shape), dtype=dtype, device=device)
    for k in range(steps):
        lap, bih, gsq = terms(u, h)
        u = torch.nan_to_num(u + dt * (-lap - bih - 0.5 * gsq))
        U[k] = u
    return U


def stridge(Gs: np.ndarray, bs: np.ndarray, alpha: float, threshold: float, max_iter: int = 25) -> np.ndarray:
    """Sequentially thresholded ridge on standardised normal equations:
    ridge on the support, drop |c| < threshold, refit, until the support
    stops changing (or every coefficient is small: all dropped)."""
    p = len(bs)
    keep = np.ones(p, dtype=bool)

    def solve(m):
        c = np.zeros(p, dtype=Gs.dtype)
        if m.any():
            idx = np.flatnonzero(m)
            c[idx] = np.linalg.solve(Gs[np.ix_(idx, idx)] + alpha * np.eye(len(idx), dtype=Gs.dtype), bs[idx])
        return c

    c = solve(keep)
    for _ in range(max_iter):
        small = np.abs(c) < threshold
        new = np.zeros(p, dtype=bool) if np.all(small | ~keep) else keep & ~small
        if np.array_equal(new, keep):
            break
        keep = new
        c = solve(keep)
    return c


def run(cfg: dict, dtype=torch.float64, device="cuda") -> dict:
    """Everything the benchmark entry returns, plus the field and the
    statistics for the traced comparison."""
    U = simulate(cfg, dtype, device)
    n, dt = int(cfg["Nx"]), float(cfg["dt"])
    h = float(cfg["Lx"]) / n
    Ut = (U[1:] - U[:-1]) / dt
    X = torch.stack([t.reshape(-1) for t in terms(U[:-1], h)], dim=1)
    y = Ut.reshape(-1)
    N = X.shape[0]
    stats = {"G": (X.T @ X).cpu().numpy(), "b": (X.T @ y).cpu().numpy(), "sx": X.sum(0).cpu().numpy(),
             "sy": float(y.sum()), "syy": float(y @ y), "n": float(N)}

    # RMS scaling, then standardised columns (centred by their mean, scaled
    # by their population std) against the uncentred target
    rms = torch.sqrt((X * X).mean(0)) + 1e-12
    Xr = X / rms
    mean = Xr.mean(0)
    std = Xr.std(0, correction=0)
    Xs = (Xr - mean) / std
    Gs = (Xs.T @ Xs).cpu().numpy()
    bs = (Xs.T @ y).cpu().numpy()
    sst = float(((y - y.mean()) ** 2).sum())
    best = None
    for a in cfg["grid_alphas"]:
        for t in cfg["grid_thresholds"]:
            c_std = stridge(Gs, bs, float(a), float(t))
            c = c_std / (std.cpu().numpy() + 1e-12) / rms.cpu().numpy()
            resid = float(((y - X @ torch.as_tensor(c, dtype=dtype, device=X.device)) ** 2).sum())
            r2, rmse, nact = 1.0 - resid / (sst + 1e-18), (resid / N) ** 0.5, int((np.abs(c) > 0).sum())
            key = (r2, -nact, -rmse)
            if best is None or key > best["key"]:
                best = {"key": key, "coeffs": c, "r2": r2, "rmse": rmse, "n_active": nact}
    del X, Xr, Xs, y, Ut

    c = torch.as_tensor(best["coeffs"], dtype=dtype, device=U.device)
    u = U[0]
    errs = []
    for k in range(int(cfg["rollout_steps"])):
        lap, bih, gsq = terms(u, h)
        u = u + dt * (c[0] * lap + c[1] * bih + c[2] * gsq)
        errs.append(float(torch.sqrt(torch.mean((U[k + 1] - u) ** 2))))
    errs = np.asarray(errs)
    return {
        "coeffs": np.asarray(best["coeffs"], dtype=np.float64), "r2": best["r2"], "rmse": best["rmse"],
        "n_active": best["n_active"], "rollout": np.array([errs[0], errs[-1], errs.mean()]),
        "field": U, "stats": stats, "field_rms": float(torch.sqrt(torch.mean(U * U))),
    }
