"""Plain reference of the registration study (the upstream
``pde_discovery_improved_registration.py`` with its default settings).

Gaussian (sigma 1) -> min-max to [0, 1] -> two warp-to-previous chains:
Farnebäck (``farneback.register_chain``) and DIS -> the mean optical-flow
magnitude of every consecutive pair before and after each (Farnebäck, 3
levels, box window 15, 3 iterations, poly_n 5, sigma 1.2, two refinement
passes) and the percent improvement -> the method that improves more,
Farnebäck on a tie -> Savitzky-Golay along time (window 7, degree 3, edges
by the polynomial fit over the first and last window) -> crop and
subsample -> central differences, each cut to the common shape from the
start -> the 13-term library -> STRidge on standardised columns -> R^2.

DIS after Kroeger et al., "Fast Optical Flow using Dense Inverse Search"
(ECCV 2016), in the simplified form the upstream registers with: a pyramid
of factor 2 (4 levels, none under 16 px), at each level 8x8 patches at
stride 4 from the top-left corner, each patch's translation found by 8
inverse-compositional Lucas-Kanade steps from the coarser flow at its centre
(the template's gradient Hessian fixed and damped by 5% of its mean trace),
then each pixel the mean of the covering patches' translations weighted by
1 / (mean |residual| + 1e-3), the coarser flow where none covers it. Each
chain step smooths the flow by an 11-tap Gaussian (sigma 2) and warps the
frame by it (bilinear, reflect-101 border).

Departures from the upstream: the stack is synthetic (``data/stack.py``);
both chains warp by x + flow, which aligns under OpenCV's flow convention,
where the upstream builds its map as x - flow (the configuration's
``reference_compat_warp`` false, as the program's default); the Farnebäck
chain's flow is computed at half resolution on the card, as
the program's chain is; the Savitzky-Golay filter runs on the cropped pixels
only (it acts on each pixel's time series alone, so the result is the
same); the densification scatter-adds in float64, whose order on the card
varies from run to run by rounding. Shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import farneback, imaging
from benchmark.reference.patch import flow_ds, stridge


def preprocess(U_raw: np.ndarray, sigma: float, dtype, device) -> torch.Tensor:
    U = torch.as_tensor(U_raw.astype(np.float64), device=device).to(dtype)
    U = imaging.gaussian_filter(U, sigma)
    return (U - U.min()) / (U.max() - U.min())


def _gradient(f: torch.Tensor, dim: int) -> torch.Tensor:
    """Central differences of unit spacing, one-sided at the two ends."""
    n = f.shape[dim]
    s = lambda a, k: f.narrow(dim, a, k)  # noqa: E731
    return torch.cat([s(1, 1) - s(0, 1), (s(2, n - 2) - s(0, n - 2)) / 2.0, s(n - 1, 1) - s(n - 2, 1)], dim=dim)


def _sample(f: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """f (H, W) at fractional (rows, cols) of any one shape, bilinear,
    reflect-101 border."""
    H, W = f.shape
    r0f, c0f = torch.floor(rows), torch.floor(cols)
    tr, tc = rows - r0f, cols - c0f
    r0, c0 = r0f.long(), c0f.long()

    def fold(i, n):
        period = max(2 * (n - 1), 1)
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - j, j)

    flat = f.reshape(-1)
    at = lambda r, c: flat[fold(r, H) * W + fold(c, W)]  # noqa: E731
    return ((1 - tr) * (1 - tc) * at(r0, c0) + (1 - tr) * tc * at(r0, c0 + 1)
            + tr * (1 - tc) * at(r0 + 1, c0) + tr * tc * at(r0 + 1, c0 + 1))


def _dis_level(ref, mov, init_r, init_c, ps: int, st: int, iters: int):
    H, W = ref.shape
    dev, dt = ref.device, ref.dtype
    y0 = torch.arange(0, H - ps + 1, st, device=dev)
    x0 = torch.arange(0, W - ps + 1, st, device=dev)
    Y0 = y0[:, None].expand(len(y0), len(x0)).reshape(-1)
    X0 = x0[None, :].expand(len(y0), len(x0)).reshape(-1)
    off = torch.arange(ps, device=dev)
    rows = (Y0[:, None, None] + off[None, :, None]).expand(-1, ps, ps)  # (P, ps, ps)
    cols = (X0[:, None, None] + off[None, None, :]).expand(-1, ps, ps)
    tmpl = ref[rows, cols]
    gr, gc = _gradient(ref, 0)[rows, cols], _gradient(ref, 1)[rows, cols]
    h11, h12, h22 = (gr * gr).sum((1, 2)), (gr * gc).sum((1, 2)), (gc * gc).sum((1, 2))
    damp = 0.05 * torch.mean(h11 + h22) + 1e-8
    h11, h22 = h11 + damp, h22 + damp
    det = h11 * h22 - h12 * h12 + 1e-8
    u, v = init_r[Y0 + ps // 2, X0 + ps // 2], init_c[Y0 + ps // 2, X0 + ps // 2]
    rf, cf = rows.to(dt), cols.to(dt)
    for _ in range(iters):
        res = _sample(mov, rf + u[:, None, None], cf + v[:, None, None]) - tmpl
        g1, g2 = (gr * res).sum((1, 2)), (gc * res).sum((1, 2))
        u, v = u - (h22 * g1 - h12 * g2) / det, v - (h11 * g2 - h12 * g1) / det
    res = _sample(mov, rf + u[:, None, None], cf + v[:, None, None]) - tmpl
    w = 1.0 / (res.abs().mean((1, 2)) + 1e-3)
    # each pixel sums the weighted translations of the patches covering it
    pix = (rows * W + cols).reshape(-1)
    acc = torch.zeros((3, H * W), dtype=dt, device=dev)
    for k, val in enumerate((w * u, w * v, w)):
        acc[k].index_add_(0, pix, val[:, None].expand(-1, ps * ps).reshape(-1))
    acc = acc.reshape(3, H, W)
    covered = acc[2] > 0
    return (torch.where(covered, acc[0] / (acc[2] + 1e-12), init_r),
            torch.where(covered, acc[1] / (acc[2] + 1e-12), init_c))


def dis_flow(img1, img2, levels: int = 4, patch: int = 8, stride: int = 4, iters: int = 8, min_size: int = 16):
    """(flow_r, flow_c) with img2(x + flow(x)) ~ img1(x)."""
    H, W = img1.shape
    shapes = [(H, W)]
    while len(shapes) < levels and min(shapes[-1][0] // 2, shapes[-1][1] // 2) >= min_size:
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    fr = torch.zeros(shapes[-1], dtype=img1.dtype, device=img1.device)
    fc = torch.zeros_like(fr)
    for h, w in reversed(shapes):
        a = img1 if (h, w) == (H, W) else imaging.resize_bilinear(img1, h, w)
        b = img2 if (h, w) == (H, W) else imaging.resize_bilinear(img2, h, w)
        if fr.shape != (h, w):
            ph, pw = fr.shape
            fr, fc = imaging.resize_bilinear(fr, h, w) * (h / ph), imaging.resize_bilinear(fc, h, w) * (w / pw)
        ps = min(patch, min(h, w) // 2)
        fr, fc = _dis_level(a, b, fr, fc, ps, max(1, min(stride, ps // 2)), iters)
    return fr, fc


def dis_step(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """``cur`` warped onto ``prev`` by their DIS flow, smoothed."""
    taps = imaging.gaussian_taps(2.0, 5)
    sm = imaging.correlate(imaging.correlate(torch.stack(dis_flow(prev, cur)), taps, 1), taps, 2)
    return imaging.warp(cur, sm[0], sm[1])


def dis_chain(U: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(U)
    out[0] = U[0]
    for i in range(1, U.shape[0]):
        out[i] = dis_step(out[i - 1], U[i])
    return out


def mean_flow(U: torch.Tensor) -> float:
    """Mean |flow| over every consecutive pair, the pairs in blocks of at
    most 2^23 pixels."""
    T, H, W = U.shape
    block = max(1, 2**23 // (H * W))
    total = 0.0
    for s in range(0, T - 1, block):
        e = min(s + block, T - 1)
        fr, fc = farneback.flow(U[s:e], U[s + 1 : e + 1], levels=3, winsize=15, iterations=3, poly_n=5,
                                poly_sigma=1.2, gaussian=False, refine=2)
        total += float(torch.sqrt(fr * fr + fc * fc).sum())
    return total / ((T - 1) * H * W)


def quality(head: torch.Tensor, fb: torch.Tensor, dis: torch.Tensor):
    """Each registration's (mean |flow| before, after, improvement in
    percent), and the method that improves more: (Farnebäck's, DIS's,
    "Farneback" or "DIS")."""
    before = mean_flow(head)
    q_fb, q_dis = ([before, after, (before - after) / (before + 1e-12) * 100.0]
                   for after in (mean_flow(fb), mean_flow(dis)))
    return np.array(q_fb), np.array(q_dis), "DIS" if q_dis[2] > q_fb[2] else "Farneback"


def savgol_time(U: np.ndarray, window: int, poly: int) -> np.ndarray:
    """Savitzky-Golay along axis 0, scipy's ``mode="interp"``."""
    T, half = U.shape[0], window // 2
    V = np.vander(np.arange(window, dtype=np.float64), poly + 1, increasing=True)
    P = (V @ np.linalg.pinv(V)).astype(U.dtype)  # the least-squares fit's values over a window
    out = np.empty_like(U)
    for t in range(half, T - half):
        out[t] = np.tensordot(P[half], U[t - half : t + half + 1], axes=1)
    out[:half] = np.tensordot(P[:half], U[:window], axes=1)
    out[T - half :] = np.tensordot(P[window - half :], U[T - window :], axes=1)
    return out


def library(U: np.ndarray, dx: float, dy: float, dt: float):
    """(X (n, 13), u_t (n,)): the sliced central differences, each cut to
    the common shape from the start, and the 13 terms."""
    u_x = (U[:, :, 2:] - U[:, :, :-2]) / (2 * dx)
    u_y = (U[:, 2:, :] - U[:, :-2, :]) / (2 * dy)
    u_xx = (U[:, :, 2:] - 2 * U[:, :, 1:-1] + U[:, :, :-2]) / dx**2
    u_yy = (U[:, 2:, :] - 2 * U[:, 1:-1, :] + U[:, :-2, :]) / dy**2
    u_t = (U[2:] - U[:-2]) / (2 * dt)
    parts = (U, u_x, u_y, u_xx, u_yy, u_t)
    m = tuple(min(a.shape[i] for a in parts) for i in range(3))
    u, u_x, u_y, u_xx, u_yy, u_t = (a[: m[0], : m[1], : m[2]].ravel() for a in parts)
    X = np.stack([np.ones_like(u), u, u_x, u_y, u_xx, u_yy, u_xx + u_yy, u * u, u * u_x, u * u_y, u**3, u_x**2,
                  u_y**2], axis=1)
    return X, u_t


def fit(U_reg: torch.Tensor, cfg: dict) -> dict:
    """Everything after the selection, on the host in the stack's dtype."""
    s, sub = int(cfg["skip"]), int(cfg["subsample"])
    U = U_reg[:, s:-s:sub, s:-s:sub].cpu().numpy()
    U = savgol_time(U, int(cfg["savgol_window"]), int(cfg["savgol_poly"]))
    X, y = library(U, float(cfg["dx"]), float(cfg["dy"]), float(cfg["dt"]))
    c = stridge(X, y, float(cfg["alpha"]), float(cfg["threshold"]), max_iter=20)
    r = y - X @ c
    yc = y - y.mean()
    return {"coefs": c.astype(np.float64), "r2": float(1.0 - np.sum(r * r) / (np.sum(yc * yc) + 1e-18))}


def run(U_raw: np.ndarray, cfg: dict, dtype=torch.float64, device="cuda") -> dict:
    """The configuration computes in float64 but for the Farnebäck chain's
    flow, which is float32 (TF32 off); any other ``dtype`` is the step
    below: the stack, DIS, the sweeps and the fit in it, the chain's flow
    products in TF32. The registered stacks stay on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    head = preprocess(U_raw, float(cfg["denoise_sigma"]), dtype, device)
    H, W = head.shape[-2:]
    fb = farneback.register_chain(head, flow_ds=flow_ds(H, W, device), refine=1, tf32=dtype != torch.float64)
    dis = dis_chain(head)
    q_fb, q_dis, method = quality(head, fb, dis)
    reg = dis if method == "DIS" else fb
    return dict(fit(reg, cfg), fb=q_fb, dis=q_dis, method=method, head=head, fb_registered=fb,
                dis_registered=dis, registered=reg)
