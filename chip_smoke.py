#!/usr/bin/env python3
"""Smoke test of the pdx_torch port on one CUDA card (run from the repo root).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build the CUDA kernels from ``pdx_torch/csrc`` (nvcc, sm_90a, one
   compiler process per source, in parallel);
2. kernels K1 (fused_ks_gram), K2 (fused_ks_gram_terms), K3
   (fused_blockwise_gram) and K4 (fused_blockwise_gram_terms) against their
   plain PyTorch versions on the card, at the main path's (1999, 100, 100)
   shape (K2/K4 with the rich 9-term list) and at a ragged (8, 30, 126) one
   (K2/K4 with the 7-term no-advection and the 5-term advection lists; K2
   also with the advection list at the main shape, as ``pallas_adv`` feeds
   it), each statistic within 1e-5 of its own Cauchy-Schwarz scale,
   bitwise repeatable; median CUDA-event times of kernel and plain, and
   each kernel's bound (the larger of its bytes over 3.35 TB/s and its
   float64 operations over 67 TFLOP/s, the H100 SXM data sheet's FP64 rate
   through the tensor cores). All four are also checked and timed on the
   main path's float64 input (its bound counts float64 bytes), through the
   wrapper as the path calls it; at the main shape the bare launch (the C
   entry point on preallocated buffers, no wrapper) is timed beside the
   wrapper; for K1 and K3 the copy route (bulk, element-wise, or float64
   rounded in flight) and the band of every shape and input type are
   printed, the bare launch is timed on the bulk and on the element-wise
   route, and K3 is also held to its plain version on float64 input with
   64-row blocks, whose bands fit only when rounded in flight; K1 must be
   faster than K2 with 5 terms and K3 than K4 (bare launches; the
   wrappers' times are printed beside them); each kernel's registers
   a thread and resident CTAs per SM at the main shape come from a C query
   (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
3. the KS-2D benchmark's main paths, ``pipelines.ks2d_bench.run`` at the
   full default size (100x100, 2000 Euler steps, float64): solver auto,
   pallas (K1), pallas blockwise (K3), pallas rich (K2), pallas blockwise
   rich (K4), pallas with advection (K2) and a perturbed configuration (N5
   jitter, stabilised, denoised, rich blockwise: K4). Every launch counter
   is set to 0 just before each run and read just after; the run's kernel
   must have moved. Gates: worst ground-truth error < 1% (true library) or
   < 2% (rich / advection), finite coefficients and rollout; the perturbed
   run is gated on finite coefficients and its launch only. Then, at the
   same size, ten configurations of the dataset / regression branch (no
   kernel of their own: matrix products, FFTs, QR and solves): the single
   fit, the batched grid on blockwise rows, the weak form (Fourier columns;
   rich library by stencils; motion-corrected on jittered noisy frames),
   Huber IRLS, the robust pipeline (trim, 30 bootstrap members, signs), the
   restandardized ensemble, the float32 QR grid and the u_t advection
   correction. Gates: finite coefficients of the right count for all; worst
   ground-truth error < 1% for the clean true-library fits, < 2% for the
   clean rich float32 QR grid, < 0.01% with decoys < 1e-4 for the rich weak
   form by stencils; the perturbed ones print their error only. The batched
   QR grid, one robust fit and the weak-form build are also timed on their
   own (host clock ending in a synchronize, warm, median of 5);
4. the card against the CPU at a small size (32x32, 0.2 s): coefficients
   within rtol 1e-6 (and, for the rich library only, 1e-6 of max|coef|,
   for decoys the CPU leaves at ~1e-10 where the card gives 0); the looser
   limits of the dataset / regression branch stand beside its table below;
   the spectral stepper at 100x100 within 1e-9 of max|u|.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

STAT_KEYS = ("G", "b", "sx", "n", "sy", "syy")
RTOL = 1e-5  # of each statistic's own scale: float32 fields, float64 sums in both
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP64_FLOP_PER_S = 67e12  # H100 SXM data sheet, FP64 through the tensor cores (its highest FP64 rate)
RICH = ("one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap")
NO_ADV = tuple(n for n in RICH if n not in ("ux", "uy"))
ADV = ("lap", "bih", "gradsq", "ux", "uy")
TRUE = ("lap", "bih", "gradsq")

# The dataset / regression branch: label -> (config beside the defaults, gate, number of terms,
# limit of card against CPU at the small size as a share of max|coef|, why that limit).
# Gates: a number = worst ground-truth error in % must stay under it; "fd" = < 0.01% and
# decoys < 1e-4; None = finite coefficients only (the fit is off by the method, as pdx's is).
_IRLS = "IRLS stops when a step is under 1e-6: card and CPU may stop one step apart"
BRANCH = {
    "slow_pointwise": (dict(), 1.0, 3, 1e-6, ""),
    "slow_grid_blockwise": (dict(method="blockwise", grid_search=True), 1.0, 3, 1e-6, ""),
    "weakform_fourier": (dict(method="weakform", weak_basis="fourier", grid_search=True), None, 3, 1e-6, ""),
    "weakform_rich_fd": (
        dict(method="weakform", dictionary="rich", weak_operator="fd", weak_basis="gaussian", grid_search=True),
        "fd", 9, 1e-6, "",
    ),
    "weakform_noisy_motion": (
        dict(method="weakform", perturbation="N5_shifts_noise", shift_mode="jitter", weak_motion_correct=True),
        None, 3, 1e-6, "",
    ),
    "huber_noisy": (dict(regression="huber", perturbation="N2_noise", method="blockwise"), None, 3, 1e-4, _IRLS),
    "robust_noisy": (
        dict(robust=True, perturbation="N2_noise", method="blockwise", sign_constraints=(-1, -1, -1)),
        None, 3, 1e-3, _IRLS + "; a trimmed row or a member's support may flip on a round-off tie",
    ),
    "ensemble": (dict(regression="ensemble", n_sample=20000), 1.0, 3, 1e-4, _IRLS),
    "qr_rich_f32": (
        dict(dictionary="rich", dtype="float32", grid_search=True), 2.0, 9, 1e-3,
        "float32 throughout: cuSOLVER's and LAPACK's Householder QR round differently",
    ),
    "shift_ut": (dict(perturbation="N1_shifts", correct_shift_ut=True, grid_search=True), None, 3, 1e-6, ""),
}


def _time_ms(fn, reps: int = 15) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _scales(want: dict) -> dict:
    """Each statistic's own scale, from the Cauchy-Schwarz bound on it:
    sqrt(G_ii G_jj) for G_ij, sqrt(G_ii syy) for b_i, sqrt(G_ii n) for sx_i,
    sqrt(n syy) for sy, syy and n for themselves."""
    import torch

    d = want["G"].diagonal().abs()
    n, syy = want["n"].abs(), want["syy"].abs()
    return {"G": torch.sqrt(d[:, None] * d[None, :]), "b": torch.sqrt(d * syy), "sx": torch.sqrt(d * n),
            "n": n, "sy": torch.sqrt(n * syy), "syy": syy}


def _check_stats(name: str, got: dict, want: dict) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / scale) over every entry of
    every statistic, scale from :func:`_scales`; raises past RTOL * scale."""
    import torch

    scales = _scales(want)
    worst, worst_rel = 0.0, 0.0
    for k in STAT_KEYS:
        err, scale = (got[k] - want[k]).abs(), scales[k]
        bad = ~(err <= RTOL * scale)
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: stat {k} differs by {err[bad].tolist()} (limits {(RTOL * scale[bad]).tolist()})"
            )
        rel = float(torch.where(scale > 0, err / scale, torch.zeros_like(err)).max())
        worst, worst_rel = max(worst, float(err.max())), max(worst_rel, rel)
    return worst, worst_rel


def _bound(
    blockwise: bool, shape: tuple[int, int, int], names: tuple[str, ...], blocks=(3, 8, 8), itemsize: int = 4
) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for one
    call. Bytes: U and Ut read once (``itemsize`` bytes a value), the S statistics written
    once. Operations: the float64 work the statistics need, for the q terms
    other than ``one`` (its entries are sx, n and sy and need no product):
    one FMA (2 flop) per Gram, b and syy entry and one add per sx and sy
    entry, per sample (pointwise) or per block row (blockwise); blockwise
    adds the q + 1 block-sum adds per sample and one multiply per block
    mean. The float32 stencil arithmetic (~40 flop a sample, ~0.01 ms at
    (1999, 100, 100)) is left out, as in PERF.md."""
    T, H, W = shape
    n = T * H * W
    p = len(names)
    q = p - ("one" in names)
    stat_flops = 2 * (q * (q + 1) // 2 + q + 1) + (q + 1)
    n_stats = p * (p + 1) // 2 + 2 * p + 2
    if blockwise:
        bt, bx, by = blocks
        rows = -(-T // bt) * -(-H // bx) * -(-W // by)
        flops = n * (q + 1) + rows * (q + 1 + stat_flops)
    else:
        flops = n * stat_flops
    t_bytes = (2 * n * itemsize + n_stats * 8) / HBM_BYTES_PER_S
    t_ops = flops / FP64_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _print_occupancy(lib, kg, kb, dev, card: str) -> None:
    """Registers a thread and resident CTAs per SM of each kernel at the main
    shape's launch (100 x 100 frames, 3 x 8 x 8 blocks), both input types."""
    import ctypes

    KH, KW = kg._tile(100, 1, kg._TERMS_MAX_TILE)[0], kg._tile(100, 1, kg._TERMS_MAX_TILE)[0]
    kbx, kby, G, _, _ = kb._blockwise_plan(100, 100, 8, 8)
    queries = {}
    for f64 in (0, 1):
        kind = "float64" if f64 else "float32"
        _, TH, threads, *_ = kg._gram_launch(1999, 100, 100, f64, kg._ROUTE_BULK, dev)
        _, kbr, G3, *_ = kb._blockwise_launch(1999, 100, 100, 3, 8, 8, f64, kg._ROUTE_BULK, dev)
        for route in (kg._ROUTE_BULK, kg._ROUTE_ELEMENTWISE):
            how = kg.ROUTE_NAMES[route]
            queries[f"fused_ks_gram {kind} ({how}, bands of {TH} rows, {threads} threads)"] = (
                lambda r, c, f64=f64, route=route, a=(TH, 100, threads): lib.pdx_fused_ks_gram_occupancy(
                    *a, f64, route, r, c))
            queries[f"fused_blockwise_gram {kind} ({how}, bands of {kbr} block-rows, {G3} threads a block)"] = (
                lambda r, c, f64=f64, route=route, a=(100, 8, 8, kbr, G3): lib.pdx_fused_blockwise_occupancy(
                    *a, f64, route, r, c))
        for p in (9, 5):  # two instances: X~ wider than 8 columns or not
            queries[f"fused_ks_gram_terms {kind} p={p}"] = (
                lambda r, c, f64=f64, p=p: lib.pdx_fused_ks_gram_terms_occupancy(KH, KW, f64, p, r, c))
        queries[f"fused_blockwise_gram_terms {kind}"] = (
            lambda r, c, f64=f64: lib.pdx_fused_blockwise_terms_occupancy(kbx, kby, 8, 8, G, f64, r, c))
    for name, query in queries.items():
        regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
        rc = query(ctypes.byref(regs), ctypes.byref(ctas))
        if rc != 0:
            raise RuntimeError(f"occupancy query of {name} failed with CUDA error {rc}")
        print(f"[occupancy] {name}: {regs.value} registers a thread, {ctas.value} resident CTAs per SM ({card})")


def _band_text(name: str, kg, kb, U, Ut, blocks) -> str:
    """How K1 or K3 stages this input: the copy route and the band ("" for K2/K4)."""
    T, H, W = U.shape
    f64 = int(U.dtype == Ut.dtype and U.element_size() == 8)
    aligned = kg._band_route(W, U.element_size(), U.data_ptr(), Ut.data_ptr())
    if name == "fused_ks_gram":
        route, TH, threads, fpc, n_bands, n_chunks = kg._gram_launch(T, H, W, f64, aligned, U.device)
        return (f", {kg.ROUTE_NAMES[route]}, {n_bands} band(s) of {TH} rows x {n_chunks} chunks of {fpc} frames, "
                f"{threads} threads")
    if name == "fused_blockwise_gram":
        route, kbr, G, tpc, n_bands, n_chunks = kb._blockwise_launch(T, H, W, *blocks, f64, aligned, U.device)
        return (f", {kg.ROUTE_NAMES[route]}, {n_bands} band(s) of {kbr} block-rows x {n_chunks} chunks of {tpc} "
                f"temporal blocks, {G} threads a block")
    return ""


def _bare_launch(name: str, lib, kg, kb, U, Ut, names, blocks, route=None):
    """The kernel's C entry point on preallocated buffers, as the wrapper
    calls it for these 16-byte aligned U and Ut (both float32 or both
    float64) at dx = dy = 0.5: a function that launches once and raises on a
    CUDA error. ``route``: for K1 and K3, the copy route to take at the
    plan's launch shape instead of the plan's own."""
    import torch

    T, H, W = U.shape
    f64 = int(U.element_size() == 8)
    dev, stream = U.device, torch.cuda.current_stream().cuda_stream
    stencil, p = kg._stencil_args(0.5, 0.5), len(names)
    n_stats = 14 if name in ("fused_ks_gram", "fused_blockwise_gram") else p * (p + 1) // 2 + 2 * p + 2
    out = torch.empty(n_stats, dtype=torch.float64, device=dev)
    ptrs = (U.data_ptr(), Ut.data_ptr())
    if name == "fused_ks_gram":
        planned, TH, threads, fpc, nb, nc = kg._gram_launch(T, H, W, f64, kg._ROUTE_BULK, dev)
        route = planned if route is None else route
        part = torch.empty((nb * nc, 14), dtype=torch.float64, device=dev)
        call = lambda: lib.pdx_fused_ks_gram(  # noqa: E731
            *ptrs, f64, route, T, H, W, TH, threads, fpc, nb, nc, *stencil, part.data_ptr(), out.data_ptr(), stream)
    elif name == "fused_blockwise_gram":
        planned, kbr, G, tpc, nb, nc = kb._blockwise_launch(T, H, W, *blocks, f64, kg._ROUTE_BULK, dev)
        route = planned if route is None else route
        part = torch.empty((nb * nc, 14), dtype=torch.float64, device=dev)
        call = lambda: lib.pdx_fused_blockwise_gram(  # noqa: E731
            *ptrs, f64, route, T, H, W, *blocks, kbr, G, tpc, nb, nc, *stencil, part.data_ptr(), out.data_ptr(), stream)
    elif name == "fused_ks_gram_terms":
        TH, TW, fpc, ntx, nty, ntz = kg._terms_launch(T, H, W, f64, dev)
        part = torch.empty((ntx * nty * ntz, n_stats), dtype=torch.float64, device=dev)
        call = lambda: lib.pdx_fused_ks_gram_terms(  # noqa: E731
            *ptrs, f64, T, H, W, TH, TW, fpc, ntx, nty, ntz, *stencil, kg._codes_arg(names), p,
            part.data_ptr(), out.data_ptr(), stream)
    else:
        kbx, kby, G, tpc, ntx, nty, ntz = kb._blockwise_terms_launch(T, H, W, *blocks, f64, dev)
        part = torch.empty((ntx * nty * ntz, n_stats), dtype=torch.float64, device=dev)
        call = lambda: lib.pdx_fused_blockwise_gram_terms(  # noqa: E731
            *ptrs, f64, T, H, W, *blocks, kbx, kby, G, tpc, ntx, nty, ntz, *stencil, kg._codes_arg(names), p,
            part.data_ptr(), out.data_ptr(), stream)

    def launch():
        rc = call()
        if rc != 0:
            raise RuntimeError(f"{name}: bare launch failed with CUDA error {rc}")

    return launch


def _host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of fn() in ms, each run ended by a synchronize,
    after one warm-up: for stages that read back from the card as they go."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _train_rows(cfg, dev):
    """(names, RMS-scaled train rows, their targets) as ``run`` regresses
    them: the same frames, host draws and 70/30 split."""
    import numpy as np
    import torch

    from pdx_torch.pipelines.ks2d_bench import _rms_scale, build_dataset, prepare_frames

    rng = np.random.default_rng(0)
    names, X, y = build_dataset(cfg, prepare_frames(cfg, dev), rng)
    tr = torch.as_tensor(rng.permutation(X.shape[0])[: int(0.7 * X.shape[0])], device=dev)
    return names, X[tr] / _rms_scale(X[tr], names), y[tr]


def _time_branch_stages(dev, card: str) -> None:
    """The new stages most likely to set a wall, each on its own at the
    full size: the batched QR grid on qr_rich_f32's rows, one robust fit on
    robust_noisy's, the weak-form build of weakform_rich_fd."""
    import torch

    from pdx_torch.library.weakform import build_weakform_dataset
    from pdx_torch.pipelines.ks2d_bench import GRID_ALPHAS, GRID_THRESHOLDS, Ks2dBenchConfig, prepare_frames
    from pdx_torch.solve.robust import robust_stridge
    from pdx_torch.solve.stridge import _masked_ridge_qr, stridge_grid, stridge_qr_grid
    from pdx_torch.ops.linalg import gram_stats

    _n, X, y = _train_rows(Ks2dBenchConfig(**BRANCH["qr_rich_f32"][0]), dev)
    a = torch.tensor(GRID_ALPHAS, dtype=X.dtype, device=dev)
    t = torch.tensor(GRID_THRESHOLDS, dtype=X.dtype, device=dev)
    grid_ms = _host_ms(lambda: stridge_qr_grid(X, y, a, t, max_iter=25))
    ones = torch.ones((5, 6, X.shape[1]), dtype=X.dtype, device=dev)
    one_qr_ms = _host_ms(lambda: _masked_ridge_qr(X, y, ones, a[:, None].expand(5, 6)))
    gram_ms = _host_ms(lambda: stridge_grid(gram_stats(X, y), a, t, max_iter=25))
    print(f"[stage] batched QR grid (30 points, rows {tuple(X.shape)} {X.dtype}): {grid_ms:.3f} ms, of which one batched "
          f"QR solve of (5, 6, {X.shape[0] + X.shape[1]}, {X.shape[1]}) {one_qr_ms:.3f} ms; the Gram grid on the same rows "
          f"{gram_ms:.3f} ms ({card})")

    kw = BRANCH["robust_noisy"][0]
    _n, X, y = _train_rows(Ks2dBenchConfig(**kw), dev)
    fit = dict(alpha=1e-6, threshold=1e-10, max_iter=25, signs=list(kw["sign_constraints"]))
    robust_ms = _host_ms(lambda: robust_stridge(X, y, use_huber=True, trim_frac=0.05, n_bootstrap=30, **fit))
    print(f"[stage] one robust_stridge fit (trim 5%, 30 members, Huber IRLS, rows {tuple(X.shape)} {X.dtype}): "
          f"{robust_ms:.3f} ms ({card})")

    cfg = Ks2dBenchConfig(**BRANCH["weakform_rich_fd"][0])
    fr = prepare_frames(cfg, dev)
    weak_ms = _host_ms(lambda: build_weakform_dataset(
        fr["U_for_ut"], dx=fr["dx"], dy=fr["dy"], dt_frame=fr["DT"], lx=cfg.Nx * fr["dx"], ly=cfg.Ny * fr["dy"],
        basis="gaussian", n_phi=cfg.weak_n_phi, sigma_px=cfg.weak_sigma_px, dictionary="rich", operator="fd"))
    print(f"[stage] build_weakform_dataset (rich, fd, 64 Gaussian test functions, frames {tuple(fr['U'].shape)}): "
          f"{weak_ms:.3f} ms ({card})")


def _run_branch(dev, card: str, counters: dict) -> None:
    """Phase 3's second half: the dataset / regression branch at full size."""
    import torch

    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig, run

    for label, (kw, gate, p, _tol, _why) in BRANCH.items():
        cfg = Ks2dBenchConfig(**kw)
        run(cfg, dev)  # warm-up: first-use allocations, cuSOLVER and cuFFT plans
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(cfg, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = {n: c.launches for n, c in counters.items()}
        if any(moved.values()):
            raise AssertionError(f"{label}: this branch launches no kernel, yet {moved}")
        coeffs = dict(zip(res["names"], res["coeffs"]))
        worst = max(v["rel_err_pct"] for v in res["gt_errors"].values())
        fit, roll = res["fit"], res["rollout"]
        if len(res["coeffs"]) != p or not all(math.isfinite(c) for c in res["coeffs"]):
            raise AssertionError(f"{label}: bad coefficients {res['coeffs']}")
        if not all(math.isfinite(fit[k]) for k in fit):
            raise AssertionError(f"{label}: fit not finite: {fit}")
        if gate is not None and not all(math.isfinite(roll[k]) for k in roll):  # a far-off fit's rollout may blow up
            raise AssertionError(f"{label}: rollout not finite: {roll}")
        if gate == "fd":
            decoys = max(abs(c) for n, c in coeffs.items() if n not in TRUE)
            if not (worst < 0.01 and decoys < 1e-4):
                raise AssertionError(f"{label}: recovery degraded (limit 0.01%, decoys 1e-4): {coeffs}")
        elif gate is not None and not worst < gate:
            raise AssertionError(f"{label}: recovery degraded (limit {gate}%): {res['gt_errors']}")
        best = res.get("grid_best")
        chosen = f", grid best alpha {best['alpha']:g} threshold {best['threshold']:g}" if best else ""
        print(
            f"[branch] {label}: warm wall {wall:.4f} s, names {res['names']}, coeffs {res['coeffs']}, "
            f"worst GT err {worst:.3e}% (gate {gate}), test R2 {fit['test_r2']:.6f}{chosen}, "
            f"rollout mean {roll['mean']:.3e} ({card})"
        )


def _branch_card_vs_cpu(dev) -> None:
    """Phase 4's second half: each configuration of the branch on the card
    against the CPU at the small size, each at its own stated limit."""
    import numpy as np

    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig, run

    from pdx_torch.sim.ks2d import Ks2dConfig, simulate_ks2d_spectral

    # the spectral stepper (no configuration of the benchmark calls it): 100x100, 200 steps of dt = 0.01
    sim = Ks2dConfig(dt=1e-2, n_seconds=2.0)
    on_card, on_cpu = (simulate_ks2d_spectral(sim, device=d)[0].cpu().numpy() for d in (dev, "cpu"))
    apart = np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max()
    if not (np.isfinite(on_card).all() and apart < 1e-9):
        raise AssertionError(f"simulate_ks2d_spectral: card and CPU apart by {apart:.1e} of max|u| (limit 1e-9)")
    print(f"[small] simulate_ks2d_spectral {on_card.shape}: card and CPU apart by {apart:.1e} of max|u| (limit 1e-9)")

    small = dict(Nx=32, Ny=32, n_seconds=0.2)
    for label, (kw, _gate, _p, tol, why) in BRANCH.items():
        on_card = np.array(run(Ks2dBenchConfig(**small, **kw), dev)["coeffs"])
        on_cpu = np.array(run(Ks2dBenchConfig(**small, **kw), "cpu")["coeffs"])
        np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=tol * np.abs(on_cpu).max(), err_msg=label)
        diff = np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max()
        print(f"[small] {label}: card {on_card.tolist()} vs CPU {on_cpu.tolist()}: apart by {diff:.1e} of max|coef| "
              f"(limit {tol:g}{'; ' + why if why else ''})")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA card visible; this check runs only on the GPU")
    from pdx_torch.ops.kernels import _build
    from pdx_torch.ops.kernels import fused_blockwise as kb
    from pdx_torch.ops.kernels import fused_gram as kg
    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig, prepare_frames, run

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s (sources {_build.source_hash()})")
    _print_occupancy(_build.library(), kg, kb, dev, card)

    # 2. kernels vs plain versions on the card
    kw3 = dict(block_t=3, block_x=8, block_y=8)
    blocks = (3, 8, 8)
    lib = _build.library()
    main_ms = {}  # (kernel, number of terms) -> (wrapper, bare launch) times at the main shape, float32
    specs = {
        "fused_ks_gram": dict(
            wrapper=lambda U, Ut, names: kg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5),
            plain=lambda U, Ut, names: kg.fused_ks_gram_reference(U, Ut, 0.5, 0.5),
            source="pdx_torch/csrc/fused_gram.cu",
            replaces="pdx/ops/pallas/fused_gram.py:279",
            counter=kg.fused_ks_gram, blockwise=False, main=[TRUE], ragged=[TRUE],
        ),
        "fused_ks_gram_terms": dict(
            wrapper=lambda U, Ut, names: kg.fused_ks_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names),
            plain=lambda U, Ut, names: kg._terms_reference(U, Ut, 0.5, 0.5, names),
            source="pdx_torch/csrc/fused_gram_terms.cu",
            replaces="pdx/ops/pallas/fused_gram.py:177",
            counter=kg.fused_ks_gram_terms, blockwise=False, main=[RICH, ADV], ragged=[NO_ADV, ADV],
        ),
        "fused_blockwise_gram": dict(
            wrapper=lambda U, Ut, names: kb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw3),
            plain=lambda U, Ut, names: kb.fused_blockwise_gram_reference(U, Ut, 0.5, 0.5, **kw3),
            source="pdx_torch/csrc/fused_blockwise.cu",
            replaces="pdx/ops/pallas/fused_blockwise.py:272",
            counter=kb.fused_blockwise_gram, blockwise=True, main=[TRUE], ragged=[TRUE],
        ),
        "fused_blockwise_gram_terms": dict(
            wrapper=lambda U, Ut, names: kb.fused_blockwise_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names, **kw3),
            plain=lambda U, Ut, names: kb.fused_blockwise_gram_terms_reference(U, Ut, 0.5, 0.5, names=names, **kw3),
            source="pdx_torch/csrc/fused_blockwise_terms.cu",
            replaces="pdx/ops/pallas/fused_blockwise.py:179",
            counter=kb.fused_blockwise_gram_terms, blockwise=True, main=[RICH], ragged=[NO_ADV, ADV],
        ),
    }
    rng = np.random.default_rng(0)
    results = {name: {"max_abs_err": 0.0} for name in specs}
    for shape in [(1999, 100, 100), (8, 30, 126)]:
        U = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        Ut = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        main_shape = shape[0] == 1999
        for name, s in specs.items():
            for names in s["main"] if main_shape else s["ragged"]:
                got, again = s["wrapper"](U, Ut, names), s["wrapper"](U, Ut, names)
                want = s["plain"](U, Ut, names)
                torch.cuda.synchronize()
                label = f"{name} {shape} p={len(names)}"
                err, rel = _check_stats(label, got, want)
                for k in STAT_KEYS:
                    if not torch.equal(got[k], again[k]):
                        raise AssertionError(f"{label}: stat {k} differs between two runs")
                r = results[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                ms = _time_ms(lambda: s["wrapper"](U, Ut, names))
                plain_ms = _time_ms(lambda: s["plain"](U, Ut, names))
                bound_ms, bound_by = _bound(s["blockwise"], shape, names)
                bare = ""
                if main_shape:
                    bare_ms = _time_ms(_bare_launch(name, lib, kg, kb, U, Ut, names, blocks))
                    bare = f" (bare launch {bare_ms:.4f} ms, at {100 * bound_ms / bare_ms:.1f}%)"
                    if "ms" not in r:  # the kernels line times each kernel's first main list
                        r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                    main_ms[name, len(names)] = (ms, bare_ms)
                print(
                    f"[kernel] {label}: max|err| {err:.3e} (at most {rel:.1e} of an entry's scale, limit {RTOL:.0e}), "
                    f"kernel {ms:.4f} ms{bare}, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                    f"kernel at {100 * bound_ms / ms:.1f}% of it){_band_text(name, kg, kb, U, Ut, blocks)} ({card})"
                )
        if main_shape:  # every kernel on the path's own float64 input, through the wrapper
            U64 = torch.from_numpy(rng.normal(size=shape)).to(dev)
            Ut64 = torch.from_numpy(rng.normal(size=shape)).to(dev)
            for name, s in specs.items():
                for names in s["main"]:
                    label = f"{name} {shape} p={len(names)} float64"
                    got, again = s["wrapper"](U64, Ut64, names), s["wrapper"](U64, Ut64, names)
                    err, rel = _check_stats(label, got, s["plain"](U64, Ut64, names))
                    if not all(torch.equal(got[k], again[k]) for k in STAT_KEYS):
                        raise AssertionError(f"{label}: differs between two runs")
                    ms = _time_ms(lambda: s["wrapper"](U64, Ut64, names))
                    bound_ms, bound_by = _bound(s["blockwise"], shape, names, itemsize=8)
                    print(
                        f"[kernel] {label}: max|err| {err:.3e} (at most {rel:.1e} of an entry's scale), "
                        f"wrapper {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                        f"at {100 * bound_ms / ms:.1f}% of it){_band_text(name, kg, kb, U64, Ut64, blocks)} ({card})"
                    )
            # K3 with blocks whose band of raw float64 does not fit shared memory
            tall = dict(block_t=3, block_x=64, block_y=8)
            label = f"fused_blockwise_gram {shape} float64, blocks (3, 64, 8)"
            got = kb.fused_blockwise_gram(U64, Ut64, dx=0.5, dy=0.5, **tall)
            err, rel = _check_stats(label, got, kb.fused_blockwise_gram_reference(U64, Ut64, 0.5, 0.5, **tall))
            ms = _time_ms(lambda: kb.fused_blockwise_gram(U64, Ut64, dx=0.5, dy=0.5, **tall))
            print(
                f"[kernel] {label}: max|err| {err:.3e} (at most {rel:.1e} of an entry's scale), wrapper {ms:.4f} ms"
                f"{_band_text('fused_blockwise_gram', kg, kb, U64, Ut64, (3, 64, 8))} ({card})"
            )
            # bulk copies against element-wise copies in the same band layout, bare launches
            for name in ("fused_ks_gram", "fused_blockwise_gram"):
                for kind, pair in (("float32", (U, Ut)), ("float64", (U64, Ut64))):
                    t = [_time_ms(_bare_launch(name, lib, kg, kb, *pair, TRUE, blocks, route=route))
                         for route in (kg._ROUTE_BULK, kg._ROUTE_ELEMENTWISE)]
                    print(f"[route] {name} {shape} {kind}: bare launch with bulk copies {t[0]:.4f} ms, "
                          f"with element-wise copies {t[1]:.4f} ms ({card})")
            del U64, Ut64
            # each true-library kernel computes a subset of its term-list sibling's terms
            for small, big, p in (("fused_ks_gram", "fused_ks_gram_terms", 5),
                                  ("fused_blockwise_gram", "fused_blockwise_gram_terms", 9)):
                (a, a_bare), (b, b_bare) = main_ms[small, 3], main_ms[big, p]
                print(f"[kernel] {small} {a:.4f} ms (bare launch {a_bare:.4f}) vs {big} at p={p} {b:.4f} ms "
                      f"(bare launch {b_bare:.4f}) ({card})")
                if not a_bare < b_bare:
                    raise AssertionError(
                        f"{small} (bare launch {a_bare:.4f} ms) is not faster than {big} at p={p} ({b_bare:.4f} ms)")
        del U, Ut

    # 3. the main paths at full size; counters set to 0 before each run
    base = dict(grid_search=True)
    perturbed = dict(
        method="blockwise", dictionary="rich", solver="pallas", perturbation="N5_shifts_noise",
        shift_mode="jitter", shift_max=1.0, stabilize_shifts=True, denoise_time_window=3,
        denoise_space_sigma=1.0,
    )
    # label: (config, kernel it must launch, GT-error gate in % or None, number of terms)
    configs = {
        "auto": (dict(), None, 1.0, 3),
        "pallas": (dict(solver="pallas"), "fused_ks_gram", 1.0, 3),
        "pallas_blockwise": (dict(solver="pallas", method="blockwise"), "fused_blockwise_gram", 1.0, 3),
        "pallas_rich": (dict(solver="pallas", dictionary="rich"), "fused_ks_gram_terms", 2.0, 9),
        "pallas_blockwise_rich": (
            dict(solver="pallas", method="blockwise", dictionary="rich"), "fused_blockwise_gram_terms", 2.0, 9,
        ),
        "pallas_adv": (dict(solver="pallas", include_advection=True), "fused_ks_gram_terms", 2.0, 5),
        "perturbed": (perturbed, "fused_blockwise_gram_terms", None, 9),
    }
    for kw, *_ in configs.values():  # warm-up: first-use allocations, cuSOLVER and cuFFT plans
        run(Ks2dBenchConfig(**base, **kw), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepare_frames(Ks2dBenchConfig(**base), dev)
    torch.cuda.synchronize()
    print(f"[slice] simulate_ks2d alone (2000 steps, 100x100, float64): {time.perf_counter() - t0:.4f} s ({card})")

    launches = {name: 0 for name in specs}
    for label, (kw, needs, gate, p) in configs.items():
        for s in specs.values():
            s["counter"].launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(Ks2dBenchConfig(**base, **kw), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = {n: s["counter"].launches for n, s in specs.items()}
        for n, c in moved.items():
            launches[n] += c
        worst = max(v["rel_err_pct"] for v in res["gt_errors"].values())
        roll = res["rollout"]
        if len(res["coeffs"]) != p or not all(math.isfinite(c) for c in res["coeffs"]):
            raise AssertionError(f"{label}: bad coefficients {res['coeffs']}")
        if gate is not None:
            if not worst < gate:
                raise AssertionError(f"{label}: recovery degraded (limit {gate}%): {res['gt_errors']}")
            if not all(math.isfinite(roll[k]) for k in ("first", "last", "mean")):
                raise AssertionError(f"{label}: rollout not finite: {roll}")
        if needs is not None and moved[needs] < 1:
            raise AssertionError(f"{label}: kernel {needs} was not launched")
        print(
            f"[slice] {label}: warm wall {wall:.4f} s, names {res['names']}, coeffs {res['coeffs']}, "
            f"worst GT err {worst:.3e}%, rollout mean {roll['mean']:.3e}, launches {moved} ({card})"
        )
    for name in specs:
        results[name]["launches"] = launches[name]
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the main paths")
    _run_branch(dev, card, {n: s["counter"] for n, s in specs.items()})
    _time_branch_stages(dev, card)

    # 4. the card against the CPU on a small input
    small = dict(grid_search=True, Nx=32, Ny=32, n_seconds=0.2)
    for label, kw in {
        "pallas": dict(solver="pallas"),
        "pallas_blockwise": dict(solver="pallas", method="blockwise"),
        "pallas_rich": dict(solver="pallas", dictionary="rich"),
        "pallas_blockwise_rich": dict(solver="pallas", method="blockwise", dictionary="rich"),
        "perturbed": perturbed,
    }.items():
        on_card = np.array(run(Ks2dBenchConfig(**small, **kw), dev)["coeffs"])
        on_cpu = np.array(run(Ks2dBenchConfig(**small, **kw), "cpu")["coeffs"])
        # the rich library's decoys: ~1e-10 on the CPU where the card gives 0
        atol = 1e-6 * np.abs(on_cpu).max() if kw.get("dictionary") == "rich" else 0.0
        np.testing.assert_allclose(on_card, on_cpu, rtol=1e-6, atol=atol, err_msg=label)
        print(f"[small] {label}: card {on_card.tolist()} vs CPU {on_cpu.tolist()}")
    _branch_card_vs_cpu(dev)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": specs[name]["source"],
         "replaces": specs[name]["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        for name, r in results.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
