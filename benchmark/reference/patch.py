"""Plain reference of patch-based PDE discovery on a frame stack (the
upstream ``patch_based_pde_discovery.py`` with its default settings).

Area shrink by 2 -> Gaussian (sigma 1) -> min-max to [0, 1] -> the
Farnebäck registration chain -> Gaussian (sigma 1.2) -> crop and subsample
-> an overlapping patch grid -> per patch, sample points drawn with numpy's
``default_rng`` in the upstream order -> derivatives from a local cubic
fit in (t, x, y) -> the 8-term library -> STRidge -> the median over
patches of the terms kept in >= 60% of them -> held-out metrics and the
one-step error. Every fit and statistic is computed in numpy on the host.
Shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import farneback, imaging

def preprocess(U_raw: np.ndarray, cfg: dict, dtype, device) -> torch.Tensor:
    T, H, W = U_raw.shape
    ds = int(cfg["downsample"])
    U = imaging.resize_area(torch.as_tensor(U_raw.astype(np.float64), device=device), H // ds, W // ds).to(dtype)
    U = imaging.gaussian_filter(U, float(cfg["denoise_sigma1"]))
    return (U - U.min()) / (U.max() - U.min() + 1e-12)


def flow_ds(H: int, W: int, device) -> int:
    """The chain's flow resolution on the card: half size while the flow
    grid keeps 64 pixels a side; full size on the CPU."""
    ds = 1 if torch.device(device).type == "cpu" else 2
    while ds > 1 and min(H, W) // ds < 64:
        ds //= 2
    return ds


def working(U: torch.Tensor, cfg: dict) -> torch.Tensor:
    U = imaging.gaussian_filter(U, float(cfg["denoise_sigma2"]))
    s, sub = int(cfg["skip"]), int(cfg["subsample"])
    return U[:, s:-s:sub, s:-s:sub]


def extraction(cfg: dict) -> np.ndarray:
    """(K, 6): neighbourhood values (t, y, x order) -> (u, u_t, u_x, u_y,
    u_xx, u_yy) of the least-squares polynomial of total degree ``deg``."""
    rt, rs, deg = int(cfg["rt"]), int(cfg["rs"]), int(cfg["deg"])
    t = np.arange(-rt, rt + 1) * float(cfg["dt"])
    y = np.arange(-rs, rs + 1) * float(cfg["dy"])
    x = np.arange(-rs, rs + 1) * float(cfg["dx"])
    Tt, Yy, Xx = (a.ravel() for a in np.meshgrid(t, y, x, indexing="ij"))
    exps = [(a, b, c) for a in range(deg + 1) for b in range(deg + 1 - a) for c in range(deg + 1 - a - b)]
    P = np.linalg.pinv(np.column_stack([Tt**a * Xx**b * Yy**c for a, b, c in exps]))
    want = [((0, 0, 0), 1.0), ((1, 0, 0), 1.0), ((0, 1, 0), 1.0), ((0, 0, 1), 1.0), ((0, 2, 0), 2.0),
            ((0, 0, 2), 2.0)]
    return np.stack([s * P[exps.index(e)] if e in exps else np.zeros(P.shape[1]) for e, s in want], axis=1)


def derivatives(U: np.ndarray, pts: np.ndarray, cfg: dict, E: np.ndarray) -> np.ndarray:
    rt, rs = int(cfg["rt"]), int(cfg["rs"])
    ot, os_ = np.arange(-rt, rt + 1), np.arange(-rs, rs + 1)
    vals = U[pts[:, 0, None, None, None] + ot[None, :, None, None],
             pts[:, 1, None, None, None] + os_[None, None, :, None],
             pts[:, 2, None, None, None] + os_[None, None, None, :]]
    return vals.reshape(len(pts), -1) @ E


def library(d: np.ndarray) -> np.ndarray:
    u, ux, uy, lap = d[:, 0], d[:, 2], d[:, 3], d[:, 4] + d[:, 5]
    return np.stack([np.ones_like(u), u, ux, uy, lap, u * u, u * ux, u * uy], axis=1)


def stridge(X: np.ndarray, y: np.ndarray, alpha: float, threshold: float, max_iter: int = 25) -> np.ndarray:
    """STRidge on standardised columns (a constant column left unscaled)
    against the uncentred target, coefficients back in column units."""
    mean = X.mean(0)
    std = X.std(0)
    tol = np.sqrt(np.finfo(X.dtype).eps) * 10.0 * np.abs(mean)
    scale = np.where(std > tol, std, 1.0)
    Xs = (X - mean) / scale
    Gs, bs = Xs.T @ Xs, Xs.T @ y
    p = X.shape[1]
    keep = np.ones(p, dtype=bool)

    def solve(m):
        c = np.zeros(p, dtype=X.dtype)
        idx = np.flatnonzero(m)
        if len(idx):
            c[idx] = np.linalg.solve(Gs[np.ix_(idx, idx)] + alpha * np.eye(len(idx), dtype=X.dtype), bs[idx])
        return c

    c = solve(keep)
    for _ in range(max_iter):
        small = np.abs(c) < threshold
        new = np.zeros(p, dtype=bool) if np.all(small | ~keep) else keep & ~small
        if np.array_equal(new, keep):
            break
        keep = new
        c = solve(keep)
    return c / (scale + 1e-12)


def metrics(y: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """rmse, r2, nrmse, mae, corr."""
    r = y - pred
    rmse = np.sqrt(np.mean(r * r))
    yc, pc = y - y.mean(), pred - pred.mean()
    return np.array([
        rmse, 1.0 - np.sum(r * r) / (np.sum(yc * yc) + 1e-18), rmse / (y.std() + 1e-12), np.mean(np.abs(r)),
        np.sum(yc * pc) / (np.sqrt(np.sum(yc * yc)) * np.sqrt(np.sum(pc * pc)) + 1e-18),
    ])


def _points(rng, t_choices, y_lo, y_hi, x_lo, x_hi, n):
    ys = rng.integers(y_lo, y_hi, size=n)
    xs = rng.integers(x_lo, x_hi, size=n)
    ts = rng.choice(t_choices, size=n, replace=True)
    return np.stack([ts, ys, xs], axis=1)


def discover(U: np.ndarray, cfg: dict) -> dict:
    """Everything after registration, on the working stack (host numpy)."""
    T, h, w = U.shape
    rt, rs, patch = int(cfg["rt"]), int(cfg["rs"]), int(cfg["patch"])
    t_valid = np.arange(rt, T - rt)
    split = int(np.floor(float(cfg["train_frac"]) * len(t_valid)))
    t_train, t_test = t_valid[:split], t_valid[split:]
    stride = max(1, patch - int(cfg["overlap"]))
    corners = [(y0, x0) for y0 in range(0, h - patch + 1, stride) for x0 in range(0, w - patch + 1, stride)]
    rng = np.random.default_rng(int(cfg["seed"]))
    n_s = int(cfg["samples_per_patch"])
    n_te = max(30, n_s // 3)
    E = extraction(cfg).astype(U.dtype)
    alpha, thr = float(cfg["alpha"]), float(cfg["threshold"])
    C, m_tr, m_te = [], [], []
    for y0, x0 in corners:
        ylo, yhi = max(rs, y0 + rs), min(h - rs, y0 + patch - rs)
        xlo, xhi = max(rs, x0 + rs), min(w - rs, x0 + patch - rs)
        if yhi <= ylo or xhi <= xlo:
            continue
        d_tr = derivatives(U, _points(rng, t_train, ylo, yhi, xlo, xhi, n_s), cfg, E)
        d_te = derivatives(U, _points(rng, t_test, ylo, yhi, xlo, xhi, n_te), cfg, E)
        X_tr, X_te = library(d_tr), library(d_te)
        c = stridge(X_tr, d_tr[:, 1], alpha, thr)
        C.append(c)
        m_tr.append(metrics(d_tr[:, 1], X_tr @ c))
        m_te.append(metrics(d_te[:, 1], X_te @ c))
    C = np.array(C)
    freq = (np.abs(C) > thr).mean(0)
    keep = freq >= float(cfg["stability_freq"])
    agg = np.where(keep, np.median(C, axis=0), 0.0)

    dg = derivatives(U, _points(rng, t_test, rs, h - rs, rs, w - rs, 800), cfg, E)
    spts = _points(rng, t_valid[:-1], rs, h - rs, rs, w - rs, 1200)
    ds = derivatives(U, spts, cfg, E)
    pred = library(dg) @ agg
    du = U[spts[:, 0] + 1, spts[:, 1], spts[:, 2]] - U[spts[:, 0], spts[:, 1], spts[:, 2]]
    one_step = np.sqrt(np.mean((du - float(cfg["dt"]) * (library(ds) @ agg)) ** 2))
    held = np.concatenate([metrics(dg[:, 1], pred), [np.median(np.abs(dg[:, 1] - pred)), one_step]])
    return {"agg": agg, "keep": keep, "patch_coeffs": C, "patch_metrics": np.array([m_tr, m_te]), "held": held}


def run(U_raw: np.ndarray, cfg: dict, dtype=torch.float64, device="cuda") -> dict:
    """The configuration computes the stack and the fits in float64 and the
    registration's flow in float32 (TF32 off); any other ``dtype`` is the
    step below both: the stack and fits in it, the flow's products in TF32."""
    head = preprocess(U_raw, cfg, dtype, device)
    H, W = head.shape[-2:]
    reg = farneback.register_chain(head, flow_ds=flow_ds(H, W, device), refine=int(cfg["register_refine"]),
                                   tf32=dtype != torch.float64)
    out = discover(working(reg, cfg).cpu().numpy(), cfg)
    out["head"], out["registered"] = head, reg
    return out
