"""Comprehensive benchmark: 21 discovery methods x 8 corruption regimes
(port of ``pdx/pipelines/comprehensive.py``;
scripts/comprehensive_benchmark.py).

KS-2D on a 64x64 grid (dt = 1e-4, a frame every 50 steps, the clip guard,
the deterministic sin/cos initial condition) -> the corruption suite N1-N7
(host scipy, as in ``pdx``) -> methods M01-M21 (the preprocessor bank,
Huber and RANSAC regressors, Fourier derivatives, the convolutional weak
form, the frame-bootstrap ensemble, the DMD preconditioners, detrending) ->
the relative coefficient error of each (regime, method), the rankings, and
``benchmark_results.json``.

The legacy global ``np.random`` stream decides every subsample, so the
draws keep ``pdx``'s order exactly: ``run`` seeds it, the corruption suite
reseeds it (123 for each shift, 456 for each noise, in the suite's order),
then each method draws in visit order (the ridge family's and Huber's
subsample indices, the weak form's draw that it consumes and does not use,
the ensemble's bootstrap frames and then each member's subsample).

Kept quirks of the reference: the FD biharmonic uses dx on both axes (dx ==
dy here); every ridge method uses Fourier derivatives (``sindy_discover``'s
default), so M09 equals M01; the weak form fits every row after its draw.
Deviations of ``pdx`` kept: M07 is Huber IRLS with a MAD scale, M08 a
textbook RANSAC (100 trials, MAD threshold), not sklearn's estimators.

On the device: ``simulate_clean`` is an eager loop of 10,000 roll-stencil
Euler steps; the 14 ridge-family methods of a regime are one batched
library build and one batched (B, n + p, p) QR; the weak form's 121-tap
wrap convolution runs once over its four stacked fields. The sequential
path (``batch_solves=False``) fits each ridge method as a batch of one
through the same code, so both paths give the same bits. ``multi_device``
is accepted and places nothing: one process drives one card (a split over
cards is later work); ``placement`` names the card.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from pdx_torch import resolve_device, resolve_dtype
from pdx_torch.io_host.artifacts import write_json
from pdx_torch.preprocess import (
    preprocess_bilateral,
    preprocess_detrend,
    preprocess_detrend_global,
    preprocess_gaussian,
    preprocess_median,
    preprocess_temporal,
    preprocess_tv,
)
from pdx_torch.solve.dmd import multiscale_dmd, sparse_dmd, standard_dmd
from pdx_torch.solve.robust import irls_huber
from pdx_torch.utils.profiling import null_stage

TRUE_COEF = np.array([-1.0, -1.0, -0.5])

# sindy_discover's defaults, which the frame-bootstrap ensemble also reads
# (``pdx`` repeats them as literals there)
SINDY_MARGIN = 3
SINDY_N_SUBSAMPLE = 20_000
SINDY_USE_FOURIER = True
RIDGE_ALPHA = 1e-4


@dataclass(frozen=True)
class ComprehensiveConfig:
    output_dir: str = "outputs/latest/benchmark"
    Lx: float = 100.0
    Ly: float = 100.0
    Nx: int = 64
    Ny: int = 64
    dt: float = 1e-4
    n_seconds: float = 1.0
    save_every: int = 50
    n_subsample: int = 20_000
    methods: tuple[str, ...] = ()  # empty = all
    noises: tuple[str, ...] = ()  # empty = all
    seed: int = 42
    dtype: str = "float64"
    multi_device: bool = True  # accepted; one card places nothing
    write_artifacts: bool = True
    # the 14 ridge-family methods of a regime as one batched fit; the draws
    # keep the visit order, so the coefficients equal the sequential path's
    batch_solves: bool = True


# ---------------------------------------------------------------------------
# data (comprehensive_benchmark.py:79-157)
# ---------------------------------------------------------------------------


def simulate_clean(cfg: ComprehensiveConfig, device: str | torch.device | None = None) -> Tensor:
    """(n_frames, Ny, Nx) KS-2D frames from explicit Euler steps of the
    roll stencils with the clip guard; frame k is the state after
    k * save_every + 1 updates (the reference saves after the update)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(cfg.dtype)
    dx = cfg.Lx / cfg.Nx
    x = np.linspace(0, cfg.Lx, cfg.Nx, endpoint=False)
    y = np.linspace(0, cfg.Ly, cfg.Ny, endpoint=False)
    X, Y = np.meshgrid(x, y)  # the reference's default 'xy' indexing
    u0 = 0.1 * (
        np.sin(2 * np.pi * X / cfg.Lx) * np.cos(2 * np.pi * Y / cfg.Ly)
        + 0.5 * np.sin(4 * np.pi * X / cfg.Lx) * np.sin(4 * np.pi * Y / cfg.Ly)
    )
    total_steps = int(cfg.n_seconds / cfg.dt)
    n_frames = total_steps // cfg.save_every

    def lap(f):
        return (
            torch.roll(f, -1, 0) + torch.roll(f, 1, 0) + torch.roll(f, -1, 1) + torch.roll(f, 1, 1) - 4 * f
        ) / (dx**2)

    def step(u):
        l = lap(u)
        gx = (torch.roll(u, -1, 0) - torch.roll(u, 1, 0)) / (2 * dx)
        gy = (torch.roll(u, -1, 1) - torch.roll(u, 1, 1)) / (2 * dx)  # dx on both axes, as the reference
        return torch.clamp(u + cfg.dt * (-l - lap(l) - 0.5 * (gx**2 + gy**2)), -10, 10)

    u = torch.as_tensor(u0, dtype=dtype).to(dev)
    U = torch.empty((n_frames,) + tuple(u.shape), dtype=dtype, device=dev)
    for k in range(n_frames):
        u = step(u)
        U[k] = u
        for _ in range(cfg.save_every - 1):
            u = step(u)
    return U


def corruption_suite(U_clean: np.ndarray) -> dict[str, np.ndarray]:
    """Host scipy corruption suite (comprehensive_benchmark.py:120-157):
    spline shifts with wrap, noise, blur, drift, and their mixes. Each shift
    and each noise reseeds the legacy global stream (123, 456), in this
    order."""
    from scipy.ndimage import gaussian_filter, shift as ndshift

    def add_shifts(data, max_shift=1.5):
        result = np.zeros_like(data)
        np.random.seed(123)
        for i in range(len(data)):
            s = np.random.uniform(-max_shift, max_shift, 2) if i > 0 else [0, 0]
            result[i] = ndshift(data[i], s, mode="wrap")
        return result

    def add_noise(data, std=0.02):
        np.random.seed(456)
        return data + std * np.std(data) * np.random.randn(*data.shape)

    def add_blur(data, sigma=1.5):
        return np.stack([gaussian_filter(f, sigma=sigma) for f in data])

    def add_drift(data, decay_rate=0.02):
        t = np.arange(len(data))
        return data * np.exp(-decay_rate * t)[:, None, None]

    return {
        "N1_shifts": add_shifts(U_clean, 1.5),
        "N2_noise": add_noise(U_clean, 0.03),
        "N3_blur": add_blur(U_clean, 1.5),
        "N4_drift": add_drift(U_clean, 0.02),
        "N5_shifts_noise": add_noise(add_shifts(U_clean, 1.5), 0.02),
        "N6_blur_noise": add_noise(add_blur(U_clean, 1.0), 0.02),
        "N7_all": add_noise(add_blur(add_drift(add_shifts(U_clean, 1.0), 0.015), 1.0), 0.02),
    }


# ---------------------------------------------------------------------------
# discovery core (comprehensive_benchmark.py:327-471)
# ---------------------------------------------------------------------------


def _derivative_fields(U: Tensor, dx: float, use_fourier: bool) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(ux, uy, lap, biharm) of a frame stack on its trailing two axes;
    square grid (dx == dy). Fourier: ``ifft2(...).real`` on the 'ij' grid of
    2 pi fftfreq(n, dx); otherwise the periodic roll stencils."""
    if use_fourier:
        n = U.shape[-1]
        k = torch.as_tensor(2 * np.pi * np.fft.fftfreq(n, dx)).to(U.device)
        KX, KY = torch.meshgrid(k, k, indexing="ij")
        k2 = KX**2 + KY**2
        F = torch.fft.fft2(U)
        ux = torch.fft.ifft2(1j * KX * F).real
        uy = torch.fft.ifft2(1j * KY * F).real
        lap = torch.fft.ifft2(-k2 * F).real
        biharm = torch.fft.ifft2(k2**2 * F).real
        return ux, uy, lap, biharm
    ux = (torch.roll(U, -1, -2) - torch.roll(U, 1, -2)) / (2 * dx)
    uy = (torch.roll(U, -1, -1) - torch.roll(U, 1, -1)) / (2 * dx)

    def lap_op(f):
        return (
            torch.roll(f, -1, -2) + torch.roll(f, 1, -2) + torch.roll(f, -1, -1) + torch.roll(f, 1, -1) - 4 * f
        ) / (dx**2)

    lap = lap_op(U)
    return ux, uy, lap, lap_op(lap)


def _build_lib_tgt(U: Tensor, dx: float, dt_frame: float, use_fourier: bool, margin: int) -> tuple[Tensor, Tensor]:
    """[lap, biharm, |grad u|^2] library (..., n, 3) and forward-difference
    target (..., n) over the interior margin crop of frames U[..., :-1, :, :];
    leading axes of U are a batch."""
    Uk = U[..., :-1, :, :]
    dudt = (U[..., 1:, :, :] - Uk) / dt_frame
    ux, uy, lap, biharm = _derivative_fields(Uk, dx, use_fourier)
    grad_sq = ux**2 + uy**2
    m = margin
    lead = U.shape[:-3]

    def crop(f):
        return f[..., m:-m, m:-m].reshape(lead + (-1,))

    return torch.stack([crop(lap), crop(biharm), crop(grad_sq)], dim=-1), crop(dudt)


def _scales(lib: Tensor) -> Tensor:
    """Column std over the rows (population), 1 where it is below 1e-10."""
    s = torch.std(lib, dim=-2, correction=0)
    return torch.where(s < 1e-10, torch.ones_like(s), s)


def _centered_ridge(X: Tensor, y: Tensor, alpha: float) -> Tensor:
    """sklearn ``Ridge(fit_intercept=True).coef_``: centre X (..., n, p) and
    y (..., n), then solve the ridge problem by the QR of the augmented
    [X - x̄; sqrt(alpha) I] and a triangular solve. Leading axes are a
    batch: one batched QR, and each member's result does not depend on
    the batch size."""
    xm = torch.mean(X, dim=-2, keepdim=True)
    ym = torch.mean(y, dim=-1, keepdim=True)
    p = X.shape[-1]
    ridge = math.sqrt(alpha) * torch.eye(p, dtype=X.dtype, device=X.device).expand(X.shape[:-2] + (p, p))
    A = torch.cat([X - xm, ridge], dim=-2)
    b = torch.cat([y - ym, torch.zeros(y.shape[:-1] + (p,), dtype=X.dtype, device=X.device)], dim=-1)
    Q, R = torch.linalg.qr(A)
    # Q^T b as a product and a sum over the rows: a batched matrix product
    # rounds differently for different batch sizes, this does not
    Qtb = torch.sum(Q * b[..., None], dim=-2)
    return torch.linalg.solve_triangular(R, Qtb[..., None], upper=True)[..., 0]


def _subsample_rows(U: Tensor, idx: Tensor, dx: float, dt_frame: float, use_fourier: bool, margin: int):
    """(Xs, ys, scales): the scaled library rows ``idx`` of each member of
    the batch U (B, T, H, W); the scales come from every row."""
    lib, tgt = _build_lib_tgt(U, dx, dt_frame, use_fourier, margin)
    scales = _scales(lib)
    Xs = torch.take_along_dim(lib, idx[..., None], dim=-2) / scales[..., None, :]
    return Xs, torch.take_along_dim(tgt, idx, dim=-1), scales


def _ridge_family(U: Tensor, idx: Tensor, dx: float, dt_frame: float, use_fourier: bool, margin: int) -> Tensor:
    """sindy_discover's ridge path for a batch: library, std scaling, row
    gather, centred ridge QR, unscaling. U (B, T, H, W), idx (B, n_s) ->
    coefficients (B, 3)."""
    Xs, ys, scales = _subsample_rows(U, idx, dx, dt_frame, use_fourier, margin)
    return _centered_ridge(Xs, ys, RIDGE_ALPHA) / scales


def _ransac_fit(X: np.ndarray, y: np.ndarray, rng: np.random.Generator, max_trials: int = 100) -> np.ndarray:
    """Textbook RANSAC with a least-squares base, on the host (``pdx``'s
    deviation from sklearn): minimal samples of p + 1 rows, inliers within
    the MAD of y, the best consensus refitted."""
    n, p = X.shape
    min_samples = p + 1
    resid_thr = np.median(np.abs(y - np.median(y)))
    best_mask = None
    best_count = -1
    Xh = np.column_stack([X, np.ones(n)])
    for _ in range(max_trials):
        idx = rng.choice(n, size=min_samples, replace=False)
        coef, *_ = np.linalg.lstsq(Xh[idx], y[idx], rcond=None)
        inliers = np.abs(y - Xh @ coef) < resid_thr
        c = int(inliers.sum())
        if c > best_count:
            best_count = c
            best_mask = inliers
    coef, *_ = np.linalg.lstsq(Xh[best_mask], y[best_mask], rcond=None)
    return coef[:p]


def _draw_subsample(T: int, H: int, W: int, margin: int, n_subsample: int) -> np.ndarray:
    """Subsample row indices from the legacy global stream."""
    n_total = (T - 1) * (H - 2 * margin) * (W - 2 * margin)
    return np.random.choice(n_total, min(n_subsample, n_total), replace=False)


def _as_index(idx: np.ndarray, device) -> Tensor:
    return torch.as_tensor(idx).to(device)


def sindy_discover(
    U: Tensor,
    dx: float,
    dt_frame: float,
    *,
    use_fourier: bool = SINDY_USE_FOURIER,
    regressor: str = "ridge",
    margin: int = SINDY_MARGIN,
    n_subsample: int = SINDY_N_SUBSAMPLE,
) -> np.ndarray:
    """sindy_discover (comprehensive_benchmark.py:352-403): subsample
    indices from the legacy global stream, then ridge, Huber or RANSAC."""
    idx = _as_index(_draw_subsample(*U.shape, margin, n_subsample), U.device)
    if regressor not in ("huber", "ransac"):  # pdx's default branch: ridge
        return _ridge_family(U[None], idx[None], dx, dt_frame, use_fourier, margin)[0].cpu().numpy()
    Xs, ys, scales = (t[0] for t in _subsample_rows(U[None], idx[None], dx, dt_frame, use_fourier, margin))
    if regressor == "huber":
        coef = irls_huber(Xs - Xs.mean(dim=0), ys - ys.mean(), alpha=RIDGE_ALPHA, delta=1.35, max_iter=200)
        return (coef / scales).cpu().numpy()
    coef = _ransac_fit(Xs.cpu().numpy(), ys.cpu().numpy(), np.random.default_rng(0))
    return coef / scales.cpu().numpy()


def _wrap_conv_fields(fields: Tensor, phi: np.ndarray, test_width: int) -> Tensor:
    """Each field (trailing two axes) correlated with the (k, k) taps
    ``phi`` under wrap padding, tap by tap in ``pdx``'s order (row-major,
    from zero)."""
    H, W = fields.shape[-2], fields.shape[-1]
    k = 2 * test_width + 1
    rows = torch.arange(-test_width, H + test_width, device=fields.device) % H
    cols = torch.arange(-test_width, W + test_width, device=fields.device) % W
    p = fields.index_select(-2, rows).index_select(-1, cols)
    out = torch.zeros_like(fields)
    for i in range(k):
        for j in range(k):
            out = out + float(phi[i, j]) * p[..., i : i + H, j : j + W]
    return out


def weak_form_sindy(
    U: Tensor, dx: float, dt_frame: float, *, test_width: int = 5, margin: int = 5,
    n_subsample: int = 20_000,
) -> np.ndarray:
    """weak_form_sindy (comprehensive_benchmark.py:409-454): the FD library
    fields and u_t convolved with an 11 x 11 Gaussian test function (wrap),
    cropped by ``margin``, fitted by the centred ridge on every row. The
    subsample draw is made and not used, as in the reference, so the stream
    stays aligned."""
    x = np.arange(-test_width, test_width + 1)
    Xk, Yk = np.meshgrid(x, x)
    sigma = test_width / 2
    phi = np.exp(-(Xk**2 + Yk**2) / (2 * sigma**2))
    phi /= phi.sum()
    phi = phi.astype(np.float32 if U.dtype == torch.float32 else np.float64)  # pdx rounds the taps to U's dtype

    T, H, W = U.shape
    _draw_subsample(T, H, W, margin, n_subsample)  # consumed, unused (reference quirk)
    Uk = U[:-1]
    dudt = (U[1:] - Uk) / dt_frame
    ux, uy, lap, biharm = _derivative_fields(Uk, dx, use_fourier=False)
    conv = _wrap_conv_fields(torch.stack([lap, biharm, ux**2 + uy**2, dudt]), phi, test_width)
    crop = conv[..., margin:-margin, margin:-margin].reshape(4, -1)
    lib, tgt = crop[:3].mT, crop[3]
    scales = _scales(lib)
    return (_centered_ridge(lib / scales, tgt, RIDGE_ALPHA) / scales).cpu().numpy()


def ensemble_sindy(U: Tensor, dx: float, dt_frame: float, n_ensemble: int = 5) -> np.ndarray:
    """Frame-bootstrap ensemble (comprehensive_benchmark.py:456-471): each
    member draws frames with replacement (kept unique and sorted; members of
    fewer than 3 frames are skipped), then its subsample, from the legacy
    global stream; the member fits are sindy_discover's ridge path with its
    defaults; the median over members is taken on the host."""
    n_frames, H, W = U.shape
    margin = SINDY_MARGIN
    coefs = []
    for _ in range(n_ensemble):
        idx = np.sort(np.unique(np.random.choice(n_frames, n_frames, replace=True)))
        if len(idx) < 3:
            continue
        sample_idx = _draw_subsample(len(idx), H, W, margin, SINDY_N_SUBSAMPLE)
        member = U[_as_index(idx, U.device)]
        coefs.append(_ridge_family(member[None], _as_index(sample_idx, U.device)[None], dx, dt_frame,
                                   SINDY_USE_FOURIER, margin)[0])
    if not coefs:
        raise ValueError("every bootstrap member had fewer than 3 frames")
    return np.median(torch.stack(coefs).cpu().numpy(), axis=0)


def _unchanged(d: Tensor) -> Tensor:
    return d


# (family, preprocessor, the stage it is timed under) of each method, in the
# reference's visit order. Every ridge method is sindy_discover's default
# ridge path (Fourier derivatives) on its preprocessed stack.
METHODS: dict[str, tuple[str, Callable | None, str]] = {
    "M01_baseline": ("ridge", _unchanged, "preprocess"),
    "M02_gaussian": ("ridge", preprocess_gaussian, "preprocess"),
    "M03_median": ("ridge", preprocess_median, "preprocess"),
    "M04_tv": ("ridge", preprocess_tv, "preprocess"),
    "M05_bilateral": ("ridge", preprocess_bilateral, "preprocess"),
    "M06_temporal": ("ridge", preprocess_temporal, "preprocess"),
    "M07_huber": ("huber", None, "huber"),
    "M08_ransac": ("ransac", None, "ransac"),
    "M09_fourier": ("ridge", _unchanged, "preprocess"),
    "M10_weak_form": ("weak", None, "weak_form"),
    "M11_ensemble": ("ensemble", None, "ensemble"),
    "M12_dmd": ("ridge", lambda d: standard_dmd(d, rank=30), "dmd"),
    "M13_dmd_opt": ("ridge", lambda d: standard_dmd(d, rank=50), "dmd"),
    "M14_dmd_fourier": ("ridge", lambda d: standard_dmd(d, rank=40), "dmd"),
    "M15_sparse_dmd": ("ridge", lambda d: sparse_dmd(d, rank=30), "dmd"),
    "M16_multiscale_dmd": ("ridge", lambda d: multiscale_dmd(d), "dmd"),
    "M17_physics_dmd": ("ridge", lambda d: multiscale_dmd(d, low_rank=8, high_rank=20), "dmd"),
    "M18_detrend": ("ridge", preprocess_detrend, "preprocess"),
    "M19_detrend_global": ("ridge", preprocess_detrend_global, "preprocess"),
    "M20_detrend_dmd": ("ridge", lambda d: standard_dmd(preprocess_detrend(d), rank=40), "dmd"),
    "M21_detrend_multiscale": ("ridge", lambda d: multiscale_dmd(preprocess_detrend(d)), "dmd"),
}


def build_methods(cfg: ComprehensiveConfig, dx: float, dt_frame: float) -> dict[str, Callable]:
    """The 21 methods as callables of a (T, H, W) stack, each returning
    host coefficients (the sequential path; the batched one calls them for
    every family but the ridge family)."""
    n_sub = cfg.n_subsample

    def method(fam, pre):
        if fam == "ridge":
            return lambda d: sindy_discover(pre(d), dx, dt_frame, n_subsample=n_sub)
        if fam in ("huber", "ransac"):
            return lambda d: sindy_discover(d, dx, dt_frame, regressor=fam, n_subsample=n_sub)
        if fam == "weak":
            return lambda d: weak_form_sindy(d, dx, dt_frame, n_subsample=n_sub)
        return lambda d: ensemble_sindy(d, dx, dt_frame)

    return {name: method(fam, pre) for name, (fam, pre, _) in METHODS.items()}


def _failed(e: Exception) -> dict:
    return {"error": float("inf"), "coef": [0, 0, 0], "time": 0.0, "error_msg": str(e)}


def _scored(coef: np.ndarray, seconds: float) -> dict:
    return {"error": compute_error(coef), "coef": [float(c) for c in coef], "time": float(seconds)}


def _run_methods_batched(
    cfg: ComprehensiveConfig, methods: dict[str, Callable], data: Tensor, dx: float, dt_frame: float,
    st=null_stage,
) -> dict[str, dict]:
    """One regime's methods in the visit order of the draws: the ridge
    family's preprocessed stacks and subsamples are gathered and fitted as
    one batch afterwards; every other method runs as in the sequential
    path."""
    T, H, W = data.shape
    jobs: list[tuple[str, Tensor, np.ndarray]] = []
    coefs: dict[str, np.ndarray] = {}
    results: dict[str, dict] = {}
    times: dict[str, float] = {}
    for name, fn in methods.items():
        fam, pre, stage = METHODS[name]
        t0 = time.time()
        try:
            with st(stage):
                if fam == "ridge":
                    jobs.append((name, pre(data), _draw_subsample(T, H, W, SINDY_MARGIN, cfg.n_subsample)))
                else:
                    coefs[name] = fn(data)
        except Exception as e:  # a failing method scores inf, as in pdx
            results[name] = _failed(e)
        times[name] = time.time() - t0

    if jobs:
        t0 = time.time()
        try:
            with st("ridge_family"):
                U_stack = torch.stack([d for _, d, _ in jobs])
                idx_stack = _as_index(np.stack([i for _, _, i in jobs]), data.device)
                fitted = _ridge_family(U_stack, idx_stack, dx, dt_frame, SINDY_USE_FOURIER, SINDY_MARGIN)
                fitted = fitted.cpu().numpy()
            solve_t = (time.time() - t0) / len(jobs)
            for (name, _, _), coef in zip(jobs, fitted):
                coefs[name] = coef
                times[name] += solve_t
        except Exception as e:
            for name, _, _ in jobs:
                results[name] = _failed(e)
    for name, coef in coefs.items():
        results[name] = _scored(coef, times[name])
    return {n: results[n] for n in methods}


def compute_error(coef: np.ndarray, true: np.ndarray = TRUE_COEF) -> float:
    return float(np.linalg.norm(coef - true) / np.linalg.norm(true) * 100.0)


def run(cfg: ComprehensiveConfig, device: str | torch.device | None = None, timer=None) -> dict[str, Any]:
    """The method x regime matrix on the CUDA card unless ``device="cpu"``;
    raises without a card otherwise. ``timer`` (a
    :class:`pdx_torch.utils.profiling.StageTimer`) times the stages."""
    dev = resolve_device(device)
    st = timer.stage if timer is not None else null_stage
    dx = cfg.Lx / cfg.Nx
    dt_frame = cfg.dt * cfg.save_every

    np.random.seed(cfg.seed)  # the legacy global stream, in the reference's draw order
    with st("simulate_clean"):
        U_clean = simulate_clean(cfg, dev)
    with st("corruption_suite"):
        datasets: dict[str, Tensor] = {"N0_clean": U_clean}
        for name, arr in corruption_suite(U_clean.cpu().numpy()).items():
            datasets[name] = torch.as_tensor(arr, dtype=U_clean.dtype).to(dev)

    methods = build_methods(cfg, dx, dt_frame)
    if cfg.methods:
        unknown = sorted(set(cfg.methods) - set(methods))
        if unknown:
            raise ValueError(f"unknown methods {unknown}; valid: {sorted(methods)}")
        methods = {k: v for k, v in methods.items() if k in set(cfg.methods)}
    if cfg.noises:
        unknown = sorted(set(cfg.noises) - set(datasets))
        if unknown:
            raise ValueError(f"unknown noise regimes {unknown}; valid: {sorted(datasets)}")
        datasets = {k: v for k, v in datasets.items() if k in set(cfg.noises) or k == "N0_clean"}

    results: dict[str, dict] = {}
    for noise_name, data in datasets.items():
        if cfg.batch_solves:
            results[noise_name] = _run_methods_batched(cfg, methods, data, dx, dt_frame, st)
            continue
        results[noise_name] = {}
        for method_name, fn in methods.items():
            try:
                t0 = time.time()
                coef = np.asarray(fn(data))
                results[noise_name][method_name] = _scored(coef, time.time() - t0)
            except Exception as e:  # a failing method scores inf, not a crash
                results[noise_name][method_name] = _failed(e)
    return _finalize(cfg, datasets, methods, results)


def _finalize(cfg, datasets, methods, results) -> dict[str, Any]:
    method_avg = {}
    for m in methods:
        errs = [results[n][m]["error"] for n in results if m in results[n] and np.isfinite(results[n][m]["error"])]
        if errs:
            method_avg[m] = float(np.mean(errs))
    sorted_methods = sorted(method_avg.items(), key=lambda x: x[1])
    output = {
        "true_coef": TRUE_COEF.tolist(),
        "noise_configs": list(datasets.keys()),
        "placement": {n: str(d.device) for n, d in datasets.items()},
        "methods": list(methods.keys()),
        "results": results,
        "rankings": dict(sorted_methods),
        "best_overall": sorted_methods[0][0] if sorted_methods else None,
        "best_per_noise": {n: min(results[n].items(), key=lambda x: x[1]["error"])[0] for n in results},
    }
    if cfg.write_artifacts:
        write_json(Path(cfg.output_dir) / "benchmark_results.json", output)
    return output


def cmd_comprehensive(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="pdx_torch comprehensive")
    parser.add_argument("--output-dir", default="outputs/latest/benchmark")
    parser.add_argument("--methods", default="", help="comma-separated subset (default all)")
    parser.add_argument("--noises", default="", help="comma-separated subset (default all)")
    parser.add_argument("--n-seconds", type=float, default=1.0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = ComprehensiveConfig(
        output_dir=args.output_dir,
        methods=tuple(m for m in args.methods.split(",") if m),
        noises=tuple(n for n in args.noises.split(",") if n),
        n_seconds=args.n_seconds,
    )
    out = run(cfg, args.device)
    print(f"{'':20}", *[f"{n[:8]:>10}" for n in out["noise_configs"]])
    for m in out["methods"]:
        row = [f"{m:<20}"]
        for n in out["noise_configs"]:
            e = out["results"][n][m]["error"]
            row.append(f"{e:>10.1f}" if np.isfinite(e) else f"{'FAIL':>10}")
        print("".join(row))
    print(f"\nBEST OVERALL: {out['best_overall']}")
    return 0
