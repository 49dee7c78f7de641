"""Plain reference of transport-form (continuity-equation) discovery (the
upstream ``transport_pde_discovery.py`` with its default settings).

Frames scaled by their maximum -> bilinear shrink by 4 -> each frame
min-max scaled for the flow -> the Farnebäck flow of every consecutive
pair (3 levels, box window 15, 3 iterations, poly_n 5, sigma 1.2, two
refinement passes), in the stack's dtype -> the 13-term transport library
with ``numpy.gradient(edge_order=2)`` derivatives -> Gaussian smoothing
(sigma 0.5) of every term and the target -> on the finite rows, sklearn's
Lasso objective for each alpha, solved by FISTA on the centred Gram matrix
(step 1 / largest eigenvalue, stop when no coefficient moves by 1e-8 or
after 5000 iterations) -> R^2, MSE and MAE. Returns the pair flows and the
centred Gram and b too. Shares no code with the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import farneback, imaging


def pair_flows(U_raw: np.ndarray, cfg: dict, dtype, device):
    """(frames shrunk, flow_u (columns), flow_v (rows)) of every pair."""
    img = torch.as_tensor(U_raw.astype(np.float64), device=device).to(dtype)
    img = img / img.max()
    T, H, W = img.shape
    ds = int(cfg["downsample"])
    rho = imaging.resize_bilinear(img, H // ds, W // ds)
    mn = rho.amin(dim=(1, 2), keepdim=True)
    mx = rho.amax(dim=(1, 2), keepdim=True)
    n = (rho - mn) / (mx - mn + 1e-12)
    fr, fc = farneback.flow(n[:-1], n[1:], levels=int(cfg["flow_levels"]), winsize=int(cfg["flow_winsize"]),
                            iterations=int(cfg["flow_iterations"]), poly_n=int(cfg["flow_poly_n"]),
                            poly_sigma=float(cfg["flow_poly_sigma"]), gaussian=False, refine=2)
    return rho, fc, fr


def fista(G: np.ndarray, b: np.ndarray, alpha: float, max_iter: int = 5000, tol: float = 1e-8):
    """min 1/2 w'Gw - b'w + alpha |w|_1."""
    step = 1.0 / (np.linalg.eigvalsh(G)[-1] + 1e-12)
    w = np.zeros_like(b)
    z, t = w, 1.0
    for _ in range(max_iter):
        v = z - step * (G @ z - b)
        w_new = np.sign(v) * np.maximum(np.abs(v) - alpha * step, 0.0)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        d = w_new - w
        z = w_new + ((t - 1.0) / t_new) * d
        w, t = w_new, t_new
        if np.max(np.abs(d)) < tol:
            break
    return w


def run(U_raw: np.ndarray, cfg: dict, dtype=torch.float64, device="cuda") -> dict:
    rho, fu, fv = pair_flows(U_raw, cfg, dtype, device)
    dt, dx, dy = float(cfg["dt"]), float(cfg["dx"]), float(cfg["dy"])
    r_t = imaging.gradient(rho, dt, 0)[:-1]
    r_x = imaging.gradient(rho, dx, 2)
    r_y = imaging.gradient(rho, dy, 1)
    lap = (imaging.gradient(r_x, dx, 2) + imaging.gradient(r_y, dy, 1))[:-1]
    div = imaging.gradient(fu, dx, 2) + imaging.gradient(fv, dy, 1)
    r, r_x, r_y = rho[:-1], r_x[:-1], r_y[:-1]
    adv = fu * r_x + fv * r_y
    terms = [torch.ones_like(r), r, r_x, r_y, lap, r * div + adv, r * div, adv, r * fu, r * fv, r * r,
             fu * r_x, fv * r_y, r_t]
    L = torch.stack(terms)
    sigma = float(cfg["spatial_smooth"])
    if sigma > 0:
        L = imaging.gaussian_filter(L, sigma)
    L = L.reshape(len(terms), -1).T.cpu().numpy()
    L = L[np.isfinite(L).all(axis=1)]
    X, y = L[:, :-1], L[:, -1]
    n = len(y)
    x_mean, y_mean = X.mean(0), y.mean()
    Xc, yc = X - x_mean, y - y_mean
    G, b = Xc.T @ Xc / n, Xc.T @ yc / n
    ss_tot = float(np.sum(yc * yc))
    coefs, intercepts, fits = [], [], []
    for alpha in cfg["alphas"]:
        w = fista(G, b, float(alpha))
        c0 = y_mean - w @ x_mean
        resid = y - (X @ w + c0)
        ss_res = float(np.sum(resid * resid))
        coefs.append(w)
        intercepts.append(c0)
        fits.append([1.0 - ss_res / ss_tot, ss_res / n, float(np.mean(np.abs(resid)))])
    return {
        "coefs": np.array(coefs), "intercepts": np.array(intercepts), "fits": np.array(fits),
        "mean_flow_speed": float(torch.mean(torch.sqrt(fu * fu + fv * fv))),
        "flow_u": fu.cpu().numpy(), "flow_v": fv.cpu().numpy(), "gram": G, "b": b,
    }
