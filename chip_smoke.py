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
   (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
   Then the Farnebäck flow's four kernels (``ops/kernels/flow_windows``:
   the expansion, the warped expansion, the update, the window blur)
   against their plain PyTorch versions at the main paths' shapes: the
   quality sweep's chunk (6 x 1024 x 1280 float64, poly_n 5, box window
   15), transport's pairs (50 x 256 x 320 float64), the patch and study
   chains' flow grids (one float32 pair of 256 x 320 and of 512 x 640,
   poly_n 7, Gaussian window 25) and the 11-tap flow smoothing (the DIS
   chain's 2 x 1024 x 1280 float64, the chains' float32 2 x 512 x 640 and
   2 x 1024 x 1280), each within 1e-12 (float64) or 1e-5 (float32) of the
   plain result's largest magnitude, timed beside the plain version and
   its byte bound (each plane read or written once at 3.35 TB/s); their
   launches are counted in the timed runs of phases 5, 7 and 9, each of
   which must launch them;
3. the KS-2D benchmark's main paths, ``pipelines.ks2d_bench.run`` at the
   full default size (100x100, 2000 Euler steps, float64): solver auto,
   pallas (K1), pallas blockwise (K3), pallas rich (K2), pallas blockwise
   rich (K4), pallas with advection (K2) and a perturbed configuration (N5
   jitter, stabilised, denoised, rich blockwise: K4). Every launch count
   of the tracer is read just before each run and just after; the run's
   kernel's must have moved. Gates: worst ground-truth error < 1% (true library) or
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
   the spectral stepper at 100x100 within 1e-9 of max|u|;
5. ``[patch]``: the real-image patch ensemble,
   ``pipelines.patch_discovery.run``, with registration in ``auto`` mode
   (the warp-to-previous Farnebäck chain, each flow at half resolution), on
   two stacks of ``tools/make_synth_stack.make_stack``: the real dataset's
   shape (51 x 1024 x 1280 uint16, the default configuration) and
   ``bench.py``'s (51 x 512 x 640 float64, skip 12, subsample 6). For each:
   the warm wall (median of 3), ``[stage]`` lines (preprocessing head,
   registration in total and per flow, local-poly datasets, patch fits,
   held-out evaluation; host clock ending in a synchronize, median of 3),
   the residual motion (RMS of frame-to-previous differences) before and
   after registration. Gates: patches fit, finite coefficients and
   metrics, residual motion lowered by registration, none of K1-K4
   launched, every flow kernel launched (the default configuration). One
   run writes the artifacts to a temporary directory and checks the CSV
   header, the report's "Aggregated PDE:" line and the JSON summary. Then the card against the CPU on 12 x 128 x
   128 frames: registration off (coefficients within 1e-10 of max|coef|)
   and on (1e-5 of max|coef|, the same kept support; registered frames
   within 5e-6), and the chain with ``flow_ds=2`` passed to both on
   128 x 128 working frames (within 5e-6): the limits of the CPU tests;
6. ``[analyze]``: ``pipelines.analyze.run`` on the same stack read as 8-bit
   grayscale (as ``load_images(mode="grayscale_u8")`` reads 16-bit
   frames), default configuration (2x downsample, the 50-flow chain, a
   51 x 39 x 50 working stack, six models, k = 1..10, two spatial
   holdouts): warm wall (median of 3), ``[stage]`` lines from the port's
   ``StageTimer`` (median of 3), one run each with robust regression and
   with Model 7; one run writing the artifacts, whose keys are held to
   ``pdx``'s schema (the figures are skipped without matplotlib, as ``pdx``
   skips them); FIG4's rollouts on the card against the CPU (1e-9). Gates:
   six (seven) results, every R2 and k-step metric finite, Models 1 and 2
   equal, the best model one of the family, none of K1-K4 launched. Then the
   card against the CPU on 12 x 128 x 128 frames: registration off (1e-9 of
   max|coef|) and on (1e-5, the same supports), the same selected models;
7. ``[transport]``: ``pipelines.transport.run`` on the uint16 stack,
   default configuration (4x downsample, 50 pair flows as one float64
   batch, a 13-term library of 50 x 256 x 320 rows, FISTA over three
   alphas): warm wall (median of 3), ``[stage]`` lines, FISTA's iterations
   and host syncs at ``pdx``'s alphas and at alphas that keep terms
   active; gates: finite coefficients and R2 for every alpha, none of
   K1-K4 launched, the flow's expansions and update launched. Then the card against the CPU on 8 x 220 x 220 frames (2
   pyramid levels, as ``pdx``'s test): flows within 1e-9 px, coefficients
   within 1e-6 of max|coef|, R2 within 1e-9;
8. ``[patch_sindy]``: ``pipelines.patch_sindy.run`` on the same stack read
   as 8-bit and scaled by 1/255 (as its TIFF path reads frames; 30 patches
   of 256 px): the default configuration (no registration; warm wall,
   median of 3), the per-patch optical flow (compose path, flows at
   64 x 64), ECC (30 patches as one batch, 50 host steps) and frame scope
   (one warm run each), with ``[stage]`` lines from the port's
   ``StageTimer``, and the ECC iterations a step; gates: 30 patches, finite
   coefficients, 0 < average quality <= 1 for the registered schedules,
   none of K1-K4 launched. Then the card against the CPU on 6 x 96 x 96 frames,
   every schedule, at the CPU tests' limits, and the batched ECC's
   iterations;
9. ``[improved_registration]``: ``pipelines.improved_registration.run`` on
   the uint16 stack, default configuration (the Farnebäck and DIS chains,
   three quality sweeps of 50 float64 pairs at 1024 x 1280, a 49 x 80 x 101
   working stack): warm wall (median of 3 if a run takes under 10 s, else
   one run) and ``[stage]`` lines; gates: finite coefficients, R2 and
   quality metrics, the working shape, a selected method, none of K1-K4
   launched, every flow kernel launched. Then the card against the CPU on
   6 x 96 x 96 frames (the same method, flow magnitudes within 1e-6,
   coefficients within 1e-5 of max|coef|), and ``dis_flow`` twice on the
   card, bitwise equal;
10. ``[comprehensive]``: ``pipelines.comprehensive.run`` at its default
   size (21 methods x 8 regimes, 200 frames of 64 x 64 float64 from 10,000
   Euler steps), writing ``benchmark_results.json`` to a temporary
   directory: warm wall (median of 3), ``[stage]`` lines (the simulation,
   the host corruption suite, the preprocessors, the DMD calls, the batched
   ridge family, Huber, host RANSAC, the weak form, the ensemble), the DMD's
   device-to-host copies a regime; gates: no method failed, finite
   coefficients (M15 on the noise-free regimes excepted: fault F7), M01 on
   N0_clean at pdx's error on the CPU to 1e-6 points, no kernel launched.
   Then the card against the CPU at n_seconds=0.25 on four regimes: every
   method within 1e-8 of max|coef| but M04 (F8) and M15 on N0/N3 (F7), the
   same best method overall and per regime;
11. ``[sindy1d]``: ``pipelines.sindy1d.run`` at its default size (KS-1D,
   N = 200, 2000 ETD steps) in every scenario, derivative, denoiser and
   regressor, and ``ensemble_over_ics``; warm walls (median of 3) and
   ``[stage]`` lines of four configurations, ``simulate_ks1d`` and
   ``varying_ic_data`` alone; gates: finite coefficients, clean STRidge
   within 1.1 x pdx's worst error on the CPU, registration lowering the
   shifted data's error, no kernel launched. Then the card against the CPU
   at n_steps=400, every configuration, within 1e-9 of max|coef|;
12. ``[run_all]``: ``pipelines.run_all.run`` from the stack written as 51
   TIFFs, with the CLI's list-resolutions and doctor as subprocesses (see
   ``_run_all_phase``);
13. ``[mesh]``: the multi-device mesh (``pdx_torch.shard``) over every card,
   or 4 virtual shards of the one card: ks2d_bench's sample-sharded Gram,
   the patch axis of the patch ensemble and of patch_sindy, comprehensive's
   regime round-robin and split ridge family, each with the mesh on and off
   (warm walls in turns, median of 3, recorded and not claimed; coefficients
   within tests/test_torch_shard.py's limits; n_shard_devices the mesh's
   size), and ``shard.dryrun.dryrun_multichip`` over the mesh.

Before each phase from 2 on, the script waits (at most 700 s in all) until
the card has that phase's peak memory and 1 GiB free, in case another
process holds the card; after each phase it prints the phase's peak
(``[memory]`` lines) and hands its cached blocks back to the card.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import collections
import dataclasses
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


def _launch_totals(counters: dict) -> dict:
    """{name: the tracer's process-wide total} of each launch count
    (``counters`` maps a kernel's name to its count's name)."""
    from pdx_torch.utils.profiling import total

    return {n: total(c) for n, c in counters.items()}


def _launches_since(counters: dict, base: dict) -> dict:
    """Launches of each kernel since ``base`` (:func:`_launch_totals`)."""
    return {n: v - base[n] for n, v in _launch_totals(counters).items()}


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


GIB = 2**30
# Device memory each phase reserves at its peak, in GiB, as its [memory] line printed it on the H100
# (rounded up); before the phase, that and 1 GiB for the CUDA context and a margin must be free.
PHASE_PEAK_GIB = {"the kernels": 4.7,
                  # the plain update's 15-fold windows of 5 fields of the sweep chunk (6 x 1024 x 1280 float64),
                  # 4.7 GB, beside its inputs: the phase reserved 9.143 GiB
                  "the flow kernels": 9.2,
                  "the KS-2D paths": 2.9, "the KS-2D card against the CPU": 0.5,
                  "[patch]": 3.8, "[analyze]": 4.3, "[transport]": 7.7, "[patch_sindy]": 8.3,
                  "[improved_registration]": 18.4,
                  # reckoned 1-3 and < 0.1 GiB before the first run (the batched ridge family's Fourier fields,
                  # 14 x 199 x 64 x 64 complex128 = 183 MB each; sindy1d's 2001 x 200 states); each phase run alone
                  # reserved 2.098 and 0.326 GiB, after the earlier phases 3.475 and 1.697 (their cached stacks)
                  "[comprehensive]": 3.5, "[sindy1d]": 1.7,
                  # run alone, the phase reserved 13.279 GiB (improved_registration's 13.2 is its peak)
                  "[run_all]": 13.3,
                  # reckoned 5 GiB before the first run (patch_sindy's float64 stack and its 30 patch sequences
                  # padded to 32, 0.86 GB, copied by the padding); run alone, the phase reserved 6.242 GiB
                  "[mesh]": 6.3}
WAIT_FOR_CARD_S = 700.0  # at most this long in all, waiting for other processes to free the card's memory
_waited = [0.0]


def _other_processes() -> str:
    """The card's compute processes as nvidia-smi lists them (pid, used memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return "; ".join(out.splitlines()) or "none listed"


def _await_card(phase: str, dev) -> None:
    """Before a phase: wait, polling every 5 s and for at most WAIT_FOR_CARD_S
    over the whole script, until the phase's peak and 1 GiB of the card's
    memory are free (another process may be holding it). The phase then runs
    whatever the wait found: an allocation it cannot make fails it."""
    import torch

    need = PHASE_PEAK_GIB[phase] + 1.0
    free, total = torch.cuda.mem_get_info(dev)
    if free >= need * GIB:
        return
    print(f"[memory] before {phase}: {free / GIB:.2f} of {total / GIB:.2f} GiB free, {need:.1f} needed; "
          f"this process holds {torch.cuda.memory_reserved(dev) / GIB:.2f} GiB; compute processes: "
          f"{_other_processes()}; waiting", flush=True)
    t0 = time.perf_counter()
    while free < need * GIB and _waited[0] + time.perf_counter() - t0 < WAIT_FOR_CARD_S:
        time.sleep(5.0)
        free = torch.cuda.mem_get_info(dev)[0]
    _waited[0] += time.perf_counter() - t0
    print(f"[memory] before {phase}: {free / GIB:.2f} GiB free after {time.perf_counter() - t0:.0f} s "
          f"({_waited[0]:.0f} s waited in all)", flush=True)


def _phase_memory(phase: str, dev) -> None:
    """After a phase: print its peak device memory in this process, then hand
    the allocator's cached blocks back to the card and reset the peaks."""
    import torch

    print(f"[memory] {phase}: peak {torch.cuda.max_memory_allocated(dev) / GIB:.3f} GiB allocated, "
          f"{torch.cuda.max_memory_reserved(dev) / GIB:.3f} GiB reserved by this process", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


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


# The Farnebäck flow's windowed kernels (csrc/farneback.cu): wrapper -> (its launch count, the planes of one
# pixel it reads and writes once each, which bound its bytes).
FLOW_KERNELS = {"poly_expansion": ("poly_expansion.launches", 6),
                "warped_poly_expansion": ("warped_poly_expansion.launches", 8),
                "flow_update": ("flow_update.launches", 14), "window_blur": ("window_blur.launches", 2)}
FLOW_COUNTERS = {n: c for n, (c, _) in FLOW_KERNELS.items()}
# each kernel's gap to its plain version, of the plain result's largest magnitude: the sums run in another order
# (~K ulp a pass), so float64 keeps ~4 digits of room over ~1e-16 and float32 ~2 over ~1e-7
FLOW_TOL = {"float64": 1e-12, "float32": 1e-5}
# the main paths' shapes: (label, planes (B, H, W), dtype, poly_n, poly_sigma, window taps, Gaussian window)
FLOW_SHAPES = (("quality sweep chunk", (6, 1024, 1280), "float64", 5, 1.2, 15, False),
               ("transport pairs", (50, 256, 320), "float64", 5, 1.2, 15, False),
               ("patch chain flow", (1, 256, 320), "float32", 7, 1.5, 25, True),
               ("study chain flow", (1, 512, 640), "float32", 7, 1.5, 25, True))
# the 11-tap sigma 2 flow smoothing: the DIS chain's (float64 at full size) and the chains' (their float32 flows
# at the frames' size)
BLUR_SHAPES = (("DIS chain smoothing", (2, 1024, 1280), "float64"),
               ("patch chain smoothing", (2, 512, 640), "float32"),
               ("study chain smoothing", (2, 1024, 1280), "float32"))


def _flow_kernels(dev, card: str) -> dict:
    """Each of the Farnebäck flow's four kernels against its plain PyTorch
    version on the card at the main paths' shapes, timed beside it and
    beside its byte bound; returns {wrapper: the kernels line's entry},
    timed at its first shape."""
    import torch

    from pdx_torch.register import farneback as fb

    def gap(got, want):
        return float((got - want).abs().max()), float((got - want).abs().max() / want.abs().max())

    def warped_plain(img, flow, n, sigma):
        return fb._poly_exp_plain(fb.warp_flow(img, flow[0], flow[1]), n, sigma)

    g = torch.Generator(device=dev).manual_seed(0)
    results = {name: {"max_abs_err": 0.0} for name in FLOW_KERNELS}

    def check(name, label, shape, dtype, kernel, plain, tol):
        (err, rel), px = gap(kernel(), plain()), math.prod(shape)
        if not rel < tol:
            raise AssertionError(f"{name} {label} {shape} {dtype}: {rel:.3e} of the plain result's largest "
                                 f"magnitude from it (limit {tol:g})")
        ms, plain_ms = _time_ms(kernel), _time_ms(plain, reps=5)
        bound_ms = FLOW_KERNELS[name][1] * (8 if dtype == "float64" else 4) * px / HBM_BYTES_PER_S * 1e3
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "ms" not in r:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes")
        print(f"[kernel] {name} {label} {shape} {dtype}: max|err| {err:.3e} ({rel:.1e} of the largest magnitude, "
              f"limit {tol:g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes; kernel "
              f"at {100 * bound_ms / ms:.1f}% of it) ({card})")

    for label, shape, dtype, pn, ps, win, gauss in FLOW_SHAPES:
        dt, n, tol = getattr(torch, dtype), pn // 2, FLOW_TOL[dtype]
        f1 = torch.rand(shape, dtype=dt, device=dev, generator=g)
        f2 = torch.roll(f1, (1, 2), (-2, -1)) + 0.01 * torch.rand(shape, dtype=dt, device=dev, generator=g)
        flow = torch.randn((2,) + shape, dtype=dt, device=dev, generator=g)
        e1, e2 = fb._poly_exp_plain(f1, n, ps), fb._poly_exp_plain(f2, n, ps)
        check("poly_expansion", label, shape, dtype, lambda: fb._poly_exp(f1, n, ps),
              lambda: fb._poly_exp_plain(f1, n, ps)[:5], tol)
        check("warped_poly_expansion", label, shape, dtype, lambda: fb._warped_poly_exp(f2, flow, n, ps),
              lambda: warped_plain(f2, flow, n, ps)[:5], tol)
        check("flow_update", label, shape, dtype, lambda: fb._flow_iteration(e1, e2, flow, win, gauss),
              lambda: fb._flow_iteration_plain(e1, e2, flow, win, gauss), tol)
        del f1, f2, flow, e1, e2
        torch.cuda.empty_cache()
    for label, shape, dtype in BLUR_SHAPES:
        f = torch.randn(shape, dtype=getattr(torch, dtype), device=dev, generator=g)
        check("window_blur", label, shape, dtype, lambda: fb._blur(f, 11, 2.0, True),
              lambda: fb._blur_plain(f, 11, 2.0, True), FLOW_TOL[dtype])
        del f
    return results


def _tally_flows(label: str, base: dict, tally, needs: tuple[str, ...]) -> None:
    """Add the flow kernels' launches since ``base`` to ``tally``; raise if
    one of ``needs`` was not launched (a main path's flow left plain)."""
    moved = _launches_since(FLOW_COUNTERS, base)
    missing = [n for n in needs if moved[n] < 1]
    if missing:
        raise AssertionError(f"{label}: the flow kernels {missing} were not launched ({moved})")
    tally.update(moved)


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
        base = _launch_totals(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(cfg, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = _launches_since(counters, base)
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


def _motion(U) -> float:
    """Residual motion of a (T, H, W) stack: RMS of frame-to-previous differences."""
    import torch

    return float(torch.sqrt(torch.mean((U[1:] - U[:-1]) ** 2)))


PATCH_SMALL = dict(data_dir="unused", max_images=12, skip=4, subsample=2, patch=11, overlap=5,
                   samples_per_patch=60, rt=1, rs=2, deg=2, write_artifacts=False)


def _patch_run(label: str, U, cfg, dev, card: str, counters: dict, tally=None) -> dict:
    """One stack through the patch ensemble: warm wall, stage lines, gates;
    the timed runs' flow-kernel launches go to ``tally`` if given."""
    import numpy as np
    import torch

    from pdx_torch.pipelines import patch_discovery as pd

    U.setflags(write=False)  # a read-only stack is shipped to the card once (io_host.images.device_stack)
    pd.run(cfg, U_raw=U, device=dev)  # warm-up
    walls = []
    base, flow_base = _launch_totals(counters), _launch_totals(FLOW_COUNTERS)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pd.run(cfg, U_raw=U, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    moved = _launches_since(counters, base)
    if any(moved.values()):
        raise AssertionError(f"{label}: the patch ensemble launches none of K1-K4, yet {moved}")
    if tally is not None:
        _tally_flows(label, flow_base, tally, tuple(FLOW_KERNELS))
    C = np.asarray(out["patch_coeffs"])
    m = out["global_test_metrics"]
    if not (out["n_patches"] > 0 and np.isfinite(C).all() and np.isfinite(out["stats"]["coeffs"]).all()):
        raise AssertionError(f"{label}: no patch fit or coefficients not finite: {out['n_patches']}, {C}")
    metrics = [v for pm in out["patch_train_metrics"] + out["patch_test_metrics"] for v in pm.values()]
    if not all(math.isfinite(v) for v in metrics + list(m.values()) + [out["one_step_rmse"]]):
        raise AssertionError(f"{label}: metrics not finite: {m}, one-step {out['one_step_rmse']}")
    print(f"[patch] {label}: warm wall {statistics.median(walls):.4f} s (median of 3: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), {out['n_patches']} patches, working grid {out['working_shape']}, "
          f"test R2 {m['r2']:.6f}, one-step RMSE {out['one_step_rmse']:.6f}, launches {moved}; {out['equation']} ({card})")

    # the stages on their own, in run's order
    names = pd._term_names(cfg)
    T = U.shape[0]
    U_pre = pd.preprocess_head(cfg, U, dev)
    U_reg = pd.register(cfg, U_pre)
    before, after = _motion(U_pre), _motion(U_reg)
    if not after < before:
        raise AssertionError(f"{label}: registration did not lower the residual motion: {before} -> {after}")
    Uw = pd.working_stack(cfg, U_reg)
    rng, tr, te, t_valid, t_test = pd.sample_patch_points(cfg, tuple(Uw.shape))
    d_tr, d_te = pd.patch_datasets(cfg, Uw, tr, te)
    fit = lambda: pd.all_patch_fits(d_tr, d_te, names=names, alpha=cfg.alpha, threshold=cfg.threshold)  # noqa: E731
    h, w = Uw.shape[1:]
    gpts = pd._safe_sample_points(rng, t_test, h, w, cfg.rs, 800)
    spts = pd._safe_sample_points(rng, t_valid[:-1], h, w, cfg.rs, 1200)
    agg = torch.as_tensor(out["stats"]["coeffs"], dtype=Uw.dtype, device=dev)

    def heldout():
        dg, ds = pd._local_poly(cfg, Uw, gpts), pd._local_poly(cfg, Uw, spts)
        return pd.heldout_eval(Uw, pd.feature_matrix(dg, names), dg[:, 1], pd.feature_matrix(ds, names),
                               torch.as_tensor(spts, device=dev), agg, cfg.dt)

    ms = {
        "preprocessing head (ship, INTER_AREA, cast, blur, normalise)": _host_ms(lambda: pd.preprocess_head(cfg, U, dev), 3),
        "registration": _host_ms(lambda: pd.register(cfg, U_pre), 3),
        "smooth, crop and host draws": _host_ms(
            lambda: pd.sample_patch_points(cfg, tuple(pd.working_stack(cfg, U_reg).shape)), 3),
        f"local-poly datasets ({tr.shape[0]} patches x ({tr.shape[1]} + {te.shape[1]}) points)": _host_ms(
            lambda: pd.patch_datasets(cfg, Uw, tr, te), 3),
        f"patch fits ({tr.shape[0]} STRidge fits as one batch)": _host_ms(fit, 3),
        "held-out evaluation (2000 points' derivatives, metrics, one-step)": _host_ms(heldout, 3),
    }
    for name, t in ms.items():
        extra = f", {t / (T - 1):.3f} ms a flow ({T - 1} flows of {tuple(U_pre.shape[1:])})" if name == "registration" else ""
        print(f"[stage] {label} {name}: {t:.3f} ms{extra} ({card})")
    print(f"[patch] {label}: residual motion {before:.6e} unregistered, {after:.6e} registered ({card})")
    return out


def _patch_card_vs_cpu(dev) -> None:
    """The patch ensemble on the card against the CPU at a small size."""
    import numpy as np

    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines import patch_discovery as pd
    from pdx_torch.register.farneback import farneback_register_sequence

    U = make_stack(T=12, H=128, W=128, seed=1)
    for reg, tol in ((False, 1e-10), (True, 1e-5)):
        cfg = pd.PatchDiscoveryConfig(registration=reg, **PATCH_SMALL)
        on_card, on_cpu = (pd.run(cfg, U_raw=U, device=d) for d in (dev, "cpu"))
        a, b = np.asarray(on_card["patch_coeffs"]), np.asarray(on_cpu["patch_coeffs"])
        apart = np.abs(a - b).max() / np.abs(b).max()
        same = np.array_equal(on_card["stats"]["keep"], on_cpu["stats"]["keep"])
        if not (apart < tol and same):
            raise AssertionError(f"patch registration={reg}: card and CPU apart by {apart:.1e} of max|coef| "
                                 f"(limit {tol:g}), same support {same}")
        print(f"[small] patch registration={reg} {U.shape}: patch coefficients apart by {apart:.1e} of max|coef| "
              f"(limit {tol:g}), same kept support; {on_card['equation']}")
    cfg = pd.PatchDiscoveryConfig(registration=True, **PATCH_SMALL)
    for label, raw, kw in (("run's chain (flow_ds 1: 64 px frames)", U, {}),
                           ("chain with flow_ds=2 on 128 px frames", make_stack(T=12, H=256, W=256, seed=2),
                            dict(flow_ds=2))):
        reg = [farneback_register_sequence(pd.preprocess_head(cfg, raw, d), **kw).cpu().numpy() for d in (dev, "cpu")]
        apart = np.abs(reg[0] - reg[1]).max()
        if not apart < 5e-6:
            raise AssertionError(f"{label}: registered frames apart by {apart:.1e} (limit 5e-6)")
        print(f"[small] {label}: registered frames on card and CPU apart by {apart:.1e} (limit 5e-6)")


def _patch_phase(full, dev, card: str, counters: dict, tally) -> None:
    """Phase 5: the real-image patch ensemble at full size (``full``: the
    51 x 1024 x 1280 uint16 stack), its artifacts, and the card against the
    CPU; the default run's flow-kernel launches go to ``tally``."""
    import json as _json
    import tempfile
    from pathlib import Path

    import numpy as np

    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines.patch_discovery import PatchDiscoveryConfig, run

    _patch_run("real dataset's shape 51x1024x1280 uint16, default configuration", full,
               PatchDiscoveryConfig(write_artifacts=False, data_dir="unused"), dev, card, counters, tally)
    bench = make_stack(T=51, H=512, W=640).astype(np.float64)
    bench_cfg = PatchDiscoveryConfig(write_artifacts=False, data_dir="unused", skip=12, subsample=6)
    _patch_run("bench.py's stack 51x512x640 float64, skip 12, subsample 6", bench, bench_cfg, dev, card, counters)
    print("[patch] for scale: pdx's own TPU record on this stack is 1.63 s warm (docs/RESULTS.md:35,45), "
          "the reference's number, not this port's")

    with tempfile.TemporaryDirectory() as d:
        out = run(dataclasses.replace(bench_cfg, write_artifacts=True, output_dir=d), U_raw=bench, device=dev)
        csv = (Path(d) / "PATCH_PDE_COEFFS.csv").read_text()
        report = (Path(d) / "PATCH_PDE_REPORT.txt").read_text()
        summary = _json.loads((Path(d) / "patch_pde_summary.json").read_text())
        if not csv.startswith("term,median,q25,q75,nonzero_freq,sign_stability,agg_coeff") or "lap(u)" not in csv:
            raise AssertionError(f"PATCH_PDE_COEFFS.csv: unexpected content {csv[:200]!r}")
        if f"Aggregated PDE:\n  {out['equation']}" not in report:
            raise AssertionError("PATCH_PDE_REPORT.txt: no 'Aggregated PDE:' line with the equation")
        if summary["equation"] != out["equation"] or summary["n_patches"] != out["n_patches"] or len(
                summary["agg_coeffs"]) != len(out["names"]):
            raise AssertionError(f"patch_pde_summary.json disagrees with the run: {summary}")
        print(f"[patch] artifacts: {sorted(p.name for p in Path(d).iterdir())}, CSV header, report and JSON summary checked")
    _patch_card_vs_cpu(dev)


def _warm_walls(fn, counters: dict, label: str, reps: int = 3, warm: bool = True, tally=None,
                needs: tuple[str, ...] = ()) -> tuple[list[float], object]:
    """One warm-up call of fn (unless ``warm`` is False), then reps calls
    timed on the host clock, each ended by a synchronize, with every launch
    count read before and after them: (walls in s, the last result). Raises
    if one of K1-K4 was launched (the real-image paths run none of them).
    With ``tally``, adds the flow kernels' launches to it and raises if one
    of ``needs`` was not launched."""
    import torch

    if warm:
        fn()
    base, flow_base = _launch_totals(counters), _launch_totals(FLOW_COUNTERS)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    moved = _launches_since(counters, base)
    if any(moved.values()):
        raise AssertionError(f"{label}: this path launches none of K1-K4, yet {moved}")
    if tally is not None:
        _tally_flows(label, flow_base, tally, needs)
    return walls, out


def _stage_lines(label: str, run_with_timer, stages: tuple[str, ...], card: str, reps: int = 3) -> dict:
    """Median over reps runs of each stage's seconds from the port's
    StageTimer (each stage ended by a synchronize); prints one [stage] line
    a stage and raises if one of ``stages`` is missing."""
    from pdx_torch.utils.profiling import StageTimer

    per_run = []
    for _ in range(reps):
        timer = StageTimer()
        run_with_timer(timer)
        per_run.append(dict(timer.stages))
    missing = [s for s in stages if s not in per_run[0]]
    if missing:
        raise AssertionError(f"{label}: stages {missing} missing from the timer's {list(per_run[0])}")
    med = {s: statistics.median(r[s] for r in per_run) for s in per_run[0]}
    total = sum(med.values())
    for s, t in med.items():
        print(f"[stage] {label} {s}: {1e3 * t:.3f} ms ({100 * t / total:.1f}% of the stages' "
              f"{1e3 * total:.3f} ms; median of {reps}) ({card})")
    return med


def _wall_text(walls: list[float]) -> str:
    return f"{statistics.median(walls):.4f} s (median of {len(walls)}: {', '.join(f'{w:.4f}' for w in walls)})"


ANALYZE_STAGES = ("denoise_normalize", "registration", "smooth_crop", "sliced_fields", "models_batched",
                  "spatial_holdout", "best_rollout_bundle")
ANALYZE_SMALL = dict(data_dir="unused", max_images=12, skip=10, subsample=4, rollout_steps=(1, 2, 3),
                     write_artifacts=False)
# pdx's artifact schema: pdx/io_host/artifacts.py:47-147 and the baseline at pdx/pipelines/analyze.py:644-664
BEST_MODEL_KEYS = {
    "generated_at", "selection", "train_frac", "name", "r2", "rmse", "mae", "nrmse", "corr", "resid_med_abs",
    "one_step_rmse", "train_r2", "train_rmse", "train_nrmse", "train_corr", "train_one_step_rmse", "n_active",
    "n_total", "equation", "terms", "coeffs", "spatial_holdout", "spatial_holdout_top_bottom", "rollout_time_test",
    "rollout_space_test_left_right", "rollout_space_test_top_bottom",
}
COMPARISON_KEYS = {"generated_at", "train_frac", "space_train_frac", "rollout_steps", "use_robust_regression",
                   "best_simple", "best_overall", "models"}
COMPARISON_MODEL_KEYS = {"name", "r2_test", "rmse_test", "nrmse_test", "corr_test", "one_step_rmse", "n_active",
                         "n_total", "equation", "terms", "coeffs", "rollout", "rollout_curve_test"}
BASELINE_KEYS = {"selection", "name", "r2", "rmse", "nrmse", "corr", "one_step_rmse", "n_active", "n_total",
                 "equation", "terms", "coeffs", "rollout_time_test"}


def _analyze_gates(label: str, out: dict, n_models: int) -> None:
    """n_models results, every R2 and k-step metric finite, Models 1 and 2
    with equal coefficients (the reference's quirk), a known best model."""
    import numpy as np

    from pdx_torch.pipelines.analyze import MODEL7, MODELS

    res = out["results"]
    if len(res) != n_models:
        raise AssertionError(f"{label}: {len(res)} results, expected {n_models}")
    for r in res:
        vals = [r["r2"], r["train_r2"]] + [v for m in r["rollout"].values() for v in m.values()]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{label}: {r['name']} has a metric that is not finite: r2 {r['r2']}, {r['rollout']}")
    if not np.array_equal(res[0]["coeffs"], res[1]["coeffs"]):
        raise AssertionError(f"{label}: Models 1 and 2 differ: {res[0]['coeffs']} vs {res[1]['coeffs']}")
    if out["best_overall"]["name"] not in list(MODELS) + [MODEL7]:
        raise AssertionError(f"{label}: best model {out['best_overall']['name']!r} is not a model of the family")


def _analyze_small_card_vs_cpu(dev) -> None:
    """analyze on the card against the CPU on 12 x 128 x 128 frames, each
    model's reading printed. Registration off: Models 1-5 within 1e-10 of
    max|coef|, Model 6 within 1e-9 (its 13 columns, u, u^2 and u^3 among
    them, amplify the Gram's summation order: 1.2e-10 measured on the
    H100). Registration on: 1e-5 and the same support (the chain's flows are
    float32; 64 px working frames run the flow at full resolution on both).
    The same selections."""
    import numpy as np

    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines import analyze as an

    U = (make_stack(T=12, H=128, W=128, seed=1) >> 8).astype(np.uint8)
    for reg in (False, True):
        cfg = an.AnalyzeConfig(registration=reg, **ANALYZE_SMALL)
        on_card, on_cpu = (an.run(cfg, U_raw=U, device=d) for d in (dev, "cpu"))
        readings = []
        for a, b in zip(on_card["results"], on_cpu["results"]):
            tol = 1e-5 if reg else 1e-9 if a["name"].startswith("Model 6") else 1e-10
            cb = np.asarray(b["coeffs"])
            apart = np.abs(np.asarray(a["coeffs"]) - cb).max() / np.abs(cb).max()
            readings.append(f"{a['name'].split(':')[0]} {apart:.1e} (limit {tol:g})")
            if not (apart < tol and a["n_active"] == b["n_active"]):
                raise AssertionError(f"analyze registration={reg} {a['name']}: card and CPU apart by {apart:.1e} of "
                                     f"max|coef| (limit {tol:g}), n_active {a['n_active']} vs {b['n_active']}")
        picks = [(on_card[k]["name"], on_cpu[k]["name"]) for k in ("best_simple", "best_overall")]
        if any(x != y for x, y in picks):
            raise AssertionError(f"analyze registration={reg}: the card selects {picks} (card, CPU)")
        print(f"[small] analyze registration={reg} {U.shape}: coefficients apart by, of max|coef|: "
              f"{'; '.join(readings)}; same supports; best simple {picks[0][0]!r}, best overall {picks[1][0]!r} "
              f"on both")


def _analyze_phase(full_u8, dev, card: str, counters: dict) -> None:
    """Phase 6: the analyze pipeline at the real dataset's shape (51 x 1024
    x 1280 read as 8-bit grayscale, default configuration), the robust and
    Model 7 runs, the artifacts, FIG4's rollouts on the card against the
    CPU, and the card against the CPU at a small size."""
    import importlib.util
    import tempfile
    from pathlib import Path

    import numpy as np

    from pdx_torch.pipelines import analyze as an
    from pdx_torch.report.figures import fig4_snapshot_data

    label = "analyze 51x1024x1280 grayscale_u8, default configuration"
    cfg = an.AnalyzeConfig(data_dir="unused", write_artifacts=False)
    walls, out = _warm_walls(lambda: an.run(cfg, U_raw=full_u8, device=dev), counters, label)
    _analyze_gates(label, out, 6)
    b = out["best_overall"]
    print(f"[analyze] {label}: warm wall {_wall_text(walls)}, working stack {out['working_shape']}, best overall "
          f"{b['name']!r} (test R2 {b['r2']:.6f}, k10 test nRMSE {b['rollout']['k10_test']['nrmse']:.6f}), best simple "
          f"{out['best_simple']['name']!r}; {b['equation']} ({card})")
    for r in out["results"]:
        print(f"[analyze]   {r['name']}: test R2 {r['r2']:.6f}, one-step RMSE {r['one_step_rmse']:.6e}, "
              f"k10 test nRMSE {r['rollout']['k10_test']['nrmse']:.6f}, {r['n_active']}/{r['n_total']} active")
    stages = _stage_lines("analyze", lambda t: an.run(cfg, U_raw=full_u8, timer=t, device=dev), ANALYZE_STAGES, card)
    print(f"[stage] analyze registration: {1e3 * stages['registration'] / 50:.3f} ms a flow (50 chained flows of "
          f"(512, 640) frames, each computed at (256, 320)) ({card})")

    for what, kw, n_models in (("robust_regression=True", dict(robust_regression=True), 6),
                               ("include_fourth_order=True", dict(include_fourth_order=True), 7)):
        one = dataclasses.replace(cfg, **kw)
        w, o = _warm_walls(lambda: an.run(one, U_raw=full_u8, device=dev), counters, f"analyze {what}", reps=1)
        _analyze_gates(f"analyze {what}", o, n_models)
        print(f"[analyze] {what}: warm wall {w[0]:.4f} s (one run), best overall {o['best_overall']['name']!r}, "
              f"test R2 {o['best_overall']['r2']:.6f} ({card})")

    with tempfile.TemporaryDirectory() as d:
        an.run(dataclasses.replace(cfg, write_artifacts=True, output_dir=d), U_raw=full_u8, device=dev)
        files = {n: json.loads((Path(d) / n).read_text()) for n in
                 ("best_model.json", "models_comparison.json", "best_model_baseline.json")}
        for name, got, want in (("best_model.json", files["best_model.json"], BEST_MODEL_KEYS),
                                ("models_comparison.json", files["models_comparison.json"], COMPARISON_KEYS),
                                ("best_model_baseline.json", files["best_model_baseline.json"], BASELINE_KEYS)):
            if set(got) != want:
                raise AssertionError(f"{name}: keys {sorted(set(got) ^ want)} differ from pdx's schema")
        models = files["models_comparison.json"]["models"]
        if len(models) != 6 or any(set(m) != COMPARISON_MODEL_KEYS for m in models):
            raise AssertionError(f"models_comparison.json: models' keys differ from pdx's schema: {models[0].keys()}")
        pngs = sorted(p.name for p in Path(d).glob("*.png"))
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        figs = (f"figures {pngs}" if has_mpl else
                "figures skipped: no matplotlib on this machine, as pdx skips them (drawn in the CPU tests)")
        print(f"[analyze] artifacts: best_model.json, models_comparison.json, best_model_baseline.json match pdx's "
              f"schema; {figs}")

    # FIG4's rollouts and error maps, the device work outside the pipeline's figure guard, called as the
    # pipeline calls it
    u = an.sliced_fields(cfg, an.preprocess(cfg, full_u8, device=dev))[0]["u"]
    test_sl = an._split_slices(u.shape[0], cfg.train_frac)[1]
    kw = dict(test_start=test_sl.start, test_stop=test_sl.stop, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy,
              k_default=cfg.rollout_steps[-1] if cfg.rollout_steps else 10)
    got = fig4_snapshot_data(u, out["results"], **kw)
    want = fig4_snapshot_data(u.cpu(), out["results"], **kw)
    ms = _host_ms(lambda: fig4_snapshot_data(u, out["results"], **kw), 3)
    maps_apart = float(np.abs(got["maps"] - want["maps"]).max() / np.abs(want["maps"]).max())
    # a horizon with no valid start in the test split is NaN on both (pdx's NaN rows)
    curves_apart = max(float(np.nanmax(np.abs(got[c] - want[c]) / np.abs(want[c]))) for c in ("curve4", "curve3"))
    same_nan = all(np.array_equal(np.isnan(got[c]), np.isnan(want[c])) for c in ("curve4", "curve3"))
    if not (got["ks"] == want["ks"] and maps_apart < 1e-6 and curves_apart < 1e-9 and same_nan
            and np.isfinite(got["maps"]).all()):
        raise AssertionError(f"fig4_snapshot_data: horizons {got['ks']} vs {want['ks']}; card and CPU apart by "
                             f"{maps_apart:.1e} (error maps, of max; limit 1e-6) and {curves_apart:.1e} (nRMSE "
                             f"curves, relative; limit 1e-9); NaN horizons the same {same_nan}")
    print(f"[analyze] fig4_snapshot_data (Models 4 and 3, horizons {got['ks']}, {tuple(u.shape)}): {ms:.3f} ms on "
          f"the card; card and CPU apart by {maps_apart:.1e} of max (float32 error maps, limit 1e-6) and "
          f"{curves_apart:.1e} relative (nRMSE curves, limit 1e-9) ({card})")
    print("[analyze] for scale: pdx's own TPU records are 9.2 s warm headline and 3.97 s instrumented "
          "(docs/RESULTS.md:386), the reference's numbers, not this port's")
    _analyze_small_card_vs_cpu(dev)


TRANSPORT_STAGES = ("ship_normalize_resize", "pair_flows", "discover_lasso_sweep", "host_readback")
TRANSPORT_ACTIVE_ALPHAS = (1e-6, 1e-5, 1e-4)  # at the small size pdx's alphas zero every term


def _transport_small_card_vs_cpu(dev) -> None:
    """transport on the card against the CPU on 8 frames of 220 x 220 (4x
    downsampled, 2 pyramid levels, as pdx's own test): float64 flows within
    1e-9 px; coefficients within 1e-6 of max|coef| and R2 within 1e-9, at
    pdx's alphas and at alphas that keep terms active (FISTA stops where a
    step falls under 1e-8, so card and CPU may stop an iteration apart)."""
    import numpy as np
    import torch

    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines import transport as tp

    U = make_stack(T=8, H=220, W=220, seed=3)
    cfg = tp.TransportConfig(data_dir="unused", max_images=8, flow_levels=2, write_artifacts=False)
    flows = []
    for d in (dev, "cpu"):
        images = torch.as_tensor(U, device=d).to(torch.float64)
        flows.append([f.cpu() for f in tp._pair_flows(cfg, tp._normalized_pairs_input(cfg, images / images.max())[1])])
    flow_apart = max(float((a - b).abs().max()) for a, b in zip(*flows))
    if not flow_apart < 1e-9:
        raise AssertionError(f"transport pair flows: card and CPU apart by {flow_apart:.1e} px (limit 1e-9)")
    for alphas in (cfg.alphas, TRANSPORT_ACTIVE_ALPHAS):
        one = dataclasses.replace(cfg, alphas=alphas)
        on_card, on_cpu = (tp.run(one, U_raw=U, device=d)["results"] for d in (dev, "cpu"))
        scale = max(max(np.abs(r["coefficients"]).max() for r in on_cpu.values()), 1e-300)
        apart = max(np.abs(on_card[a]["coefficients"] - on_cpu[a]["coefficients"]).max() for a in on_cpu) / scale
        r2_apart = max(abs(on_card[a]["r2"] - on_cpu[a]["r2"]) for a in on_cpu)
        if not (apart < 1e-6 and r2_apart < 1e-9):
            raise AssertionError(f"transport alphas {alphas}: card and CPU apart by {apart:.1e} of max|coef| "
                                 f"(limit 1e-6), R2 by {r2_apart:.1e} (limit 1e-9)")
        active = [len(r["active_terms"]) for r in on_card.values()]
        print(f"[small] transport {U.shape} alphas {alphas}: flows apart by {flow_apart:.1e} px (limit 1e-9), "
              f"coefficients by {apart:.1e} of max|coef| (limit 1e-6), R2 by {r2_apart:.1e} (limit 1e-9); "
              f"active terms {active}")


def _transport_phase(full, dev, card: str, counters: dict, tally) -> None:
    """Phase 7: the transport pipeline at the real dataset's shape (51 x
    1024 x 1280 uint16, default configuration: 50 pair flows at 256 x 320,
    a 13-term library of 50 x 256 x 320 rows, FISTA over three alphas), its
    stages, FISTA's iterations, and the card against the CPU; the timed
    runs' flow-kernel launches go to ``tally``."""
    import numpy as np
    import torch

    from pdx_torch.io_host.images import device_stack
    from pdx_torch.pipelines import transport as tp
    from pdx_torch.solve.lasso import CHECK_EVERY

    label = "transport 51x1024x1280 uint16, default configuration"
    cfg = tp.TransportConfig(data_dir="unused", write_artifacts=False)
    walls, out = _warm_walls(lambda: tp.run(cfg, U_raw=full, device=dev), counters, label, tally=tally,
                             needs=("poly_expansion", "warped_poly_expansion", "flow_update"))
    for a, r in out["results"].items():
        if not (np.isfinite(r["coefficients"]).all() and math.isfinite(r["r2"])):
            raise AssertionError(f"{label}: alpha {a} gives coefficients {r['coefficients']}, R2 {r['r2']}")
    fits = "; ".join(f"alpha {a}: R2 {r['r2']:.6f}, {len(r['active_terms'])}/13 active" for a, r in out["results"].items())
    print(f"[transport] {label}: warm wall {_wall_text(walls)}, {out['n_samples']} samples, mean flow speed "
          f"{out['mean_flow_speed']:.6f} px/frame; {fits} ({card})")
    _stage_lines("transport", lambda t: tp.run(cfg, U_raw=full, timer=t, device=dev), TRANSPORT_STAGES, card)

    # the library and Lasso sweep alone, on this run's flows: FISTA's iterations per alpha and its host
    # syncs, at pdx's alphas and at alphas that keep terms active (there FISTA iterates)
    images = device_stack(full, torch.float64, device=dev)
    imgs_ds, imgs_n = tp._normalized_pairs_input(cfg, images / images.max())
    fu, fv = tp._pair_flows(cfg, imgs_n)
    kw = dict(dt=cfg.dt, dx=cfg.dx, dy=cfg.dy, spatial_smooth=cfg.spatial_smooth)
    for alpha_list in (cfg.alphas, TRANSPORT_ACTIVE_ALPHAS):
        alphas = torch.as_tensor(alpha_list, dtype=torch.float64, device=dev)
        res = tp._discover(imgs_ds, fu, fv, alphas, **kw)
        n_iter, syncs, active = res[-2].tolist(), res[-1], (res[0].abs() > 1e-10).sum(dim=1).tolist()
        ms = _host_ms(lambda: tp._discover(imgs_ds, fu, fv, alphas, **kw), 3)
        print(f"[transport] alphas {alpha_list}: FISTA iterations {n_iter} (max_iter 5000), active terms {active}; "
              f"library, Gram and sweep {ms:.3f} ms (median of 3), {syncs} host syncs in the sweep (one for the step "
              f"size, one a stop check after iterations 1, 2, 4, ... then every {CHECK_EVERY}) ({card})")
    print("[transport] for scale: pdx's own TPU record is 1.27 s warm (docs/RESULTS.md:387), the reference's "
          "number, not this port's")
    _transport_small_card_vs_cpu(dev)


PATCH_SINDY_STAGES = ("denoise", "extract_patches", "registration", "discovery")
IR_STAGES = ("denoise_normalize", "farneback_chain", "dis_chain", "quality_before", "quality_farneback", "quality_dis",
             "fit")
SINDY_SMALL = dict(data_dir="unused", patch_size=48, overlap=16, skip_boundary=3, subsample=2, min_patches=2,
                   write_artifacts=False)


def _patch_motion(S) -> float:
    """Residual motion of (P, T, h, w) patch sequences: RMS of frame-to-previous differences."""
    import torch

    return float(torch.sqrt(torch.mean((S[:, 1:] - S[:, :-1]) ** 2)))


def _sindy_gates(label: str, out: dict, positive: bool) -> None:
    """30 patches (the 5 x 6 grid of 256 px patches), finite coefficients,
    an average quality in (0, 1] (``positive``) or [0, 1]. A quality is
    max(0, R2) x registration quality: where a registration removes the
    stack's drift, u_t is left at the noise's level and R2 may be <= 0 in
    every patch: the compose schedule gives 0 on this stack, as pdx does on
    the CPU, and is gated on the residual motion it removes instead."""
    import numpy as np

    if out["n_patches"] != 30 or not (np.isfinite(out["coeffs"]).all() and np.isfinite(out["patch_coeffs"]).all()):
        raise AssertionError(f"{label}: {out['n_patches']} patches, coefficients {out['coeffs']}")
    if not (0 < out["avg_quality"] <= 1 if positive else 0 <= out["avg_quality"] <= 1):
        raise AssertionError(f"{label}: average quality {out['avg_quality']} outside {'(0' if positive else '[0'}, 1]")


def _sindy_small_card_vs_cpu(dev) -> None:
    """patch_sindy on the card against the CPU on 6 frames of 96 x 96, every
    schedule, at the CPU tests' limits: ensemble coefficients within 1e-10
    (no flow) or 1e-5 (float32 flows) of max|coef|, each patch's within 1e-9
    or 3e-5 (the constant term is round-off on both sides: below 1e-8), the
    average quality within 1e-10 or 2e-5; the batched ECC's registered
    patches within 1e-10 of max|value| with the same iterations a patch."""
    import numpy as np
    import torch

    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines import patch_sindy as ps
    from pdx_torch.register.ecc import register_sequence_info

    U = make_stack(T=6, H=96, W=96, seed=1) / 65535.0
    flow = dict(registration_method="optical_flow")
    for label, kw, no_flow in (
        ("none", {}, True), ("ecc", dict(registration_method="ecc"), True),
        ("chain", dict(flow, flow_compose=False), False),
        ("compose flow_downsample=1", dict(flow, flow_compose=True, flow_downsample=1), False),
        ("compose flow_downsample=2", dict(flow, flow_compose=True, flow_downsample=2, patch_size=64, overlap=32), False),
        ("frame scope", dict(flow, flow_scope="frame"), False),
    ):
        cfg = ps.PatchSindyConfig(**{**SINDY_SMALL, **kw})
        a, b = (ps.run(cfg, U_raw=U, device=d) for d in (dev, "cpu"))
        scale = np.abs(b["patch_coeffs"]).max()
        ens_tol, patch_tol, q_tol = (1e-10, 1e-9, 1e-10) if no_flow else (1e-5, 3e-5, 2e-5)
        ens = np.abs(a["coeffs"][1:] - b["coeffs"][1:]).max() / scale
        per = np.abs(a["patch_coeffs"][:, 1:] - b["patch_coeffs"][:, 1:]).max() / scale
        const = max(np.abs(a["patch_coeffs"][:, 0]).max(), np.abs(b["patch_coeffs"][:, 0]).max()) / scale
        dq = abs(a["avg_quality"] - b["avg_quality"])
        if not (ens < ens_tol and per < patch_tol and const < 1e-8 and dq < q_tol):
            raise AssertionError(f"patch_sindy {label}: card and CPU apart by {ens:.1e} (ensemble, limit {ens_tol:g}), "
                                 f"{per:.1e} (patches, limit {patch_tol:g}) of max|coef|, constant term {const:.1e}, "
                                 f"quality {dq:.1e} (limit {q_tol:g})")
        print(f"[small] patch_sindy {label} {U.shape}: card and CPU apart by {ens:.1e} (ensemble, limit {ens_tol:g}) and "
              f"{per:.1e} (patches, limit {patch_tol:g}) of max|coef|, quality by {dq:.1e} (limit {q_tol:g})")
    seqs = ps.extract_patch_sequences(torch.as_tensor(U), 48, 32)[0]
    on_card, on_cpu = (register_sequence_info(seqs.to(d), gauss_sigma=1.0) for d in (dev, "cpu"))
    apart = float((on_card[0].cpu() - on_cpu[0]).abs().max() / on_cpu[0].abs().max())
    if not (apart < 1e-10 and torch.equal(on_card[2].cpu(), on_cpu[2])):
        raise AssertionError(f"batched ECC: card and CPU apart by {apart:.1e} (limit 1e-10), iterations "
                             f"{on_card[2].tolist()} vs {on_cpu[2].tolist()}")
    print(f"[small] batched ECC {tuple(seqs.shape)}: registered patches apart by {apart:.1e} of max (limit 1e-10), "
          f"the same iterations a patch and step {on_cpu[2].tolist()}")


def _patch_sindy_phase(f255, dev, card: str, counters: dict) -> None:
    """Phase 8: patch_sindy at the real dataset's shape (``f255``: the
    51 x 1024 x 1280 frames read as 8-bit and scaled by 1/255, read-only):
    the default configuration (no registration), the per-patch optical flow
    (compose path, flows at 64 x 64), ECC, and frame scope; then the card
    against the CPU."""
    import torch

    from pdx_torch.ops.filters import gaussian_filter_reflect, savgol_time
    from pdx_torch.pipelines import patch_sindy as ps
    from pdx_torch.register.ecc import CHECK_EVERY, register_sequence_info

    label = "patch_sindy 51x1024x1280 u8/255, default configuration"
    cfg = ps.PatchSindyConfig(data_dir="unused", write_artifacts=False)
    walls, out = _warm_walls(lambda: ps.run(cfg, U_raw=f255, device=dev), counters, label)
    _sindy_gates(label, out, positive=False)
    print(f"[patch_sindy] {label}: warm wall {_wall_text(walls)}, {out['n_patches']} patches, average quality "
          f"{out['avg_quality']:.6f}, coefficients {[round(float(c), 6) for c in out['coeffs']]} ({card})")
    _stage_lines(label, lambda t: ps.run(cfg, U_raw=f255, device=dev, timer=t), PATCH_SINDY_STAGES, card)
    for what, kw, positive in (
        ("optical_flow per patch (compose, flows at 64 x 64)", dict(registration_method="optical_flow"), False),
        ("ecc", dict(registration_method="ecc"), True),
        ("optical_flow frame scope", dict(registration_method="optical_flow", flow_scope="frame"), True),
    ):
        one = dataclasses.replace(cfg, **kw)
        w, o = _warm_walls(lambda: ps.run(one, U_raw=f255, device=dev), counters, f"patch_sindy {what}", reps=1)
        _sindy_gates(f"patch_sindy {what}", o, positive)
        print(f"[patch_sindy] {what}: warm wall {w[0]:.4f} s (one run), average quality {o['avg_quality']:.6f} "
              f"(std {o['quality_std']:.6f}) ({card})")
        _stage_lines(f"patch_sindy {what}", lambda t: ps.run(one, U_raw=f255, device=dev, timer=t),
                     PATCH_SINDY_STAGES, card, reps=1)
    # the per-patch schedules alone: the residual motion the compose path removes (its gate), ECC's
    # (printed: a patch whose ECC fails at a step passes that frame through unwarped, a jump), and ECC's
    # iterations (every patch of a step runs until the slowest stops)
    U = savgol_time(gaussian_filter_reflect(torch.as_tensor(f255, device=dev), cfg.spatial_sigma), 3, 2)
    seqs = ps.extract_patch_sequences(U, 256, 192)[0]
    composed = ps.register_patches(dataclasses.replace(cfg, registration_method="optical_flow"), seqs)[0]
    ecc_reg, ccs, iters, syncs = register_sequence_info(seqs, motion="euclidean", gauss_sigma=1.0)
    motion = [_patch_motion(x) for x in (seqs, composed, ecc_reg)]
    if not motion[1] < motion[0]:
        raise AssertionError(f"patch_sindy: the compose path did not lower the patches' residual motion: {motion}")
    per_patch = [torch.sqrt(torch.mean((x[:, 1:] - x[:, :-1]) ** 2, dim=(1, 2, 3))) for x in (seqs, ecc_reg)]
    lowered = int((per_patch[1] < per_patch[0]).sum())
    it = iters.cpu()
    print(f"[patch_sindy] residual motion of the 30 patches {motion[0]:.6e} unregistered, {motion[1]:.6e} composed, "
          f"{motion[2]:.6e} by ECC (lowered in {lowered} of 30 patches); ECC iterations a patch and step: mean "
          f"{float(it.double().mean()):.2f}, max {int(it.max())}; the batch's a step (its slowest patch) sum to {int(it.max(0).values.sum())} over "
          f"{it.shape[1]} steps; {syncs} host stop checks (after iterations 1, 2, 4, ... then every {CHECK_EVERY}); "
          f"cc min {float(ccs.min()):.4f} ({card})")
    _sindy_small_card_vs_cpu(dev)


def _ir_small_card_vs_cpu(dev) -> None:
    """improved_registration on the card against the CPU on 6 frames of
    96 x 96 (Savitzky-Golay window 5): the same method, flow magnitudes
    within 1e-6 relative, improvements within 1e-4 points, coefficients
    within 1e-5 of max|coef| with the same support; DIS flows within 1e-10
    of max|flow| of the CPU's, and bitwise equal between two calls on the
    card."""
    import numpy as np
    import torch

    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines import improved_registration as ir
    from pdx_torch.register.dis import dis_flow

    U = make_stack(T=6, H=96, W=96, seed=1)
    cfg = ir.ImprovedRegistrationConfig(data_dir="unused", max_images=6, skip=10, subsample=6, savgol_window=5,
                                        savgol_poly=2, write_artifacts=False)
    a, b = (ir.run(cfg, U_raw=U, device=d) for d in (dev, "cpu"))
    mags = max(abs(a[m][k] - b[m][k]) / abs(b[m][k]) for m in ("farneback_metrics", "dis_metrics")
               for k in ("avg_flow_before", "avg_flow_after"))
    pts = max(abs(a[m]["improvement_pct"] - b[m]["improvement_pct"]) for m in ("farneback_metrics", "dis_metrics"))
    coef = np.abs(a["coeffs"] - b["coeffs"]).max() / np.abs(b["coeffs"]).max()
    same = np.array_equal(np.abs(a["coeffs"]) > 1e-5, np.abs(b["coeffs"]) > 1e-5)
    if not (a["selected_method"] == b["selected_method"] and mags < 1e-6 and pts < 1e-4 and coef < 1e-5 and same):
        raise AssertionError(f"improved_registration: card {a['selected_method']} vs CPU {b['selected_method']}; "
                             f"magnitudes apart by {mags:.1e} (limit 1e-6), improvements by {pts:.1e} points (1e-4), "
                             f"coefficients by {coef:.1e} of max|coef| (1e-5), same support {same}")
    print(f"[small] improved_registration {U.shape}: both select {a['selected_method']}; flow magnitudes apart by "
          f"{mags:.1e} relative (limit 1e-6), improvements by {pts:.1e} points (1e-4), coefficients by {coef:.1e} of "
          f"max|coef| (1e-5), same support")
    F = torch.as_tensor(U / 65535.0)
    first, again, on_cpu = dis_flow(F[0].to(dev), F[3].to(dev)), dis_flow(F[0].to(dev), F[3].to(dev)), dis_flow(F[0], F[3])
    bitwise = all(torch.equal(x, y) for x, y in zip(first, again))
    apart = max(float((x.cpu() - z).abs().max() / z.abs().max()) for x, z in zip(first, on_cpu))
    if not (bitwise and apart < 1e-10):
        raise AssertionError(f"dis_flow on the card: repeats bitwise {bitwise}; apart from the CPU by {apart:.1e}")
    print(f"[small] dis_flow {tuple(F.shape[1:])}: two calls on the card bitwise equal; card and CPU apart by "
          f"{apart:.1e} of max|flow| (limit 1e-10)")


def _improved_registration_phase(full, dev, card: str, counters: dict, tally) -> None:
    """Phase 9: improved_registration at the real dataset's shape (``full``:
    the 51 x 1024 x 1280 uint16 stack read as float64), default
    configuration; then the card against the CPU. The timed runs'
    flow-kernel launches go to ``tally``."""
    import numpy as np

    from pdx_torch.pipelines import improved_registration as ir

    label = "improved_registration 51x1024x1280 uint16, default configuration"
    cfg = ir.ImprovedRegistrationConfig(data_dir="unused", write_artifacts=False)
    needs = tuple(FLOW_KERNELS)
    walls, out = _warm_walls(lambda: ir.run(cfg, U_raw=full, device=dev), counters, label, reps=1, tally=tally,
                             needs=needs)
    if walls[0] < 10.0:  # a median of 3 where a run is short enough
        walls += _warm_walls(lambda: ir.run(cfg, U_raw=full, device=dev), counters, label, reps=2, warm=False,
                             tally=tally, needs=needs)[0]
    metrics = [out[m][k] for m in ("farneback_metrics", "dis_metrics") for k in out[m]]
    if not (np.isfinite(out["coeffs"]).all() and len(out["coeffs"]) == 13 and math.isfinite(out["r2"])
            and all(math.isfinite(v) for v in metrics)):
        raise AssertionError(f"{label}: coefficients {out['coeffs']}, R2 {out['r2']}, metrics {metrics}")
    if out["working_shape"] != (49, 80, 101) or out["selected_method"] not in ("DIS", "Farneback"):
        raise AssertionError(f"{label}: working shape {out['working_shape']}, method {out['selected_method']}")
    fb, dis = out["farneback_metrics"], out["dis_metrics"]
    print(f"[improved_registration] {label}: warm wall {_wall_text(walls)}; Farnebäck {fb['avg_flow_before']:.6f} -> "
          f"{fb['avg_flow_after']:.6f} px ({fb['improvement_pct']:.4f}%), DIS -> {dis['avg_flow_after']:.6f} px "
          f"({dis['improvement_pct']:.4f}%); selected {out['selected_method']}, working stack {out['working_shape']}, "
          f"R2 {out['r2']:.6f}; {out['equation']} ({card})")
    stages = _stage_lines("improved_registration", lambda t: ir.run(cfg, U_raw=full, device=dev, timer=t), IR_STAGES,
                          card, reps=1)
    print(f"[stage] improved_registration: Farnebäck chain {1e3 * stages['farneback_chain'] / 50:.3f} ms a flow (50 "
          f"flows of 1024 x 1280 frames, each computed at 512 x 640), DIS chain {1e3 * stages['dis_chain'] / 50:.3f} ms "
          f"a step, quality sweeps {1e3 * stages['quality_before']:.3f} ms each (50 float64 pairs at 1024 x 1280) "
          f"({card})")
    _ir_small_card_vs_cpu(dev)


COMP_STAGES = ("simulate_clean", "corruption_suite", "preprocess", "dmd", "ridge_family", "huber", "ransac",
               "weak_form", "ensemble")
# M01_baseline's error on N0_clean at the default (full) size, from pdx on the CPU in float64 (run with pdx
# when this phase was written): the card's must be the same to 1e-6 percentage points
PDX_M01_CLEAN_ERROR = 6.096730154104554
# round-off lotteries of the reference, held to finite coefficients only: M15 on the noise-free regimes (F7),
# M04's TV iteration everywhere (F8)
F7_CELLS = {("M15_sparse_dmd", n) for n in ("N0_clean", "N3_blur", "N4_drift")}
F8_METHOD = "M04_tv"
COMP_SMALL = dict(n_seconds=0.25, noises=("N2_noise", "N3_blur", "N7_all"), write_artifacts=False)


def _comprehensive_gates(label: str, out: dict) -> None:
    """No method failed (a CUDA error must not pass as a bad method), 8
    regimes x 21 methods, finite coefficients (M15 on N0/N3/N4 may be
    non-finite, as pdx's there), M01 on N0_clean at pdx's error."""
    failed = [(n, m, r["error_msg"]) for n, d in out["results"].items() for m, r in d.items() if "error_msg" in r]
    if failed:
        raise AssertionError(f"{label}: {len(failed)} methods failed: {failed[:4]}")
    if len(out["results"]) != 8 or any(len(d) != 21 for d in out["results"].values()):
        raise AssertionError(f"{label}: {len(out['results'])} regimes, {[len(d) for d in out['results'].values()]}")
    bad = [(n, m) for n, d in out["results"].items() for m, r in d.items()
           if (m, n) not in F7_CELLS and not all(math.isfinite(c) for c in r["coef"])]
    if bad:
        raise AssertionError(f"{label}: non-finite coefficients in {bad}")
    err = out["results"]["N0_clean"]["M01_baseline"]["error"]
    if not abs(err - PDX_M01_CLEAN_ERROR) < 1e-6:
        raise AssertionError(f"{label}: M01 on N0_clean {err!r}% against pdx's {PDX_M01_CLEAN_ERROR!r}% on the CPU")


def _comprehensive_small_card_vs_cpu(dev) -> None:
    """The method matrix at n_seconds=0.25 on N0_clean, N2_noise, N3_blur
    and N7_all, on the card and on the CPU: every method within 1e-8 of
    max|coef| but the lotteries (M04 everywhere, F8; M15 on N0/N3, F7);
    the same best_overall and best_per_noise."""
    import numpy as np

    from pdx_torch.pipelines import comprehensive as cr

    a, b = (cr.run(cr.ComprehensiveConfig(**COMP_SMALL), d) for d in (dev, "cpu"))
    worst, where = 0.0, None
    for n, d in b["results"].items():
        for m, r in d.items():
            if m == F8_METHOD or (m, n) in F7_CELLS:
                continue
            cb, ca = np.asarray(r["coef"]), np.asarray(a["results"][n][m]["coef"])
            e = float(np.abs(ca - cb).max() / np.abs(cb).max())
            if not e <= worst:
                worst, where = e, f"{n}/{m}"
    same = a["best_overall"] == b["best_overall"] and a["best_per_noise"] == b["best_per_noise"]
    if not (worst < 1e-8 and same):
        raise AssertionError(f"comprehensive: card and CPU apart by {worst:.1e} of max|coef| at {where} (limit 1e-8); "
                             f"best {a['best_overall']} / {b['best_overall']}, per regime {a['best_per_noise']} / "
                             f"{b['best_per_noise']}")
    print(f"[small] comprehensive n_seconds=0.25, 4 regimes x 21 methods: card and CPU apart by at most {worst:.1e} "
          f"of max|coef| ({where}; limit 1e-8; M04 everywhere and M15 on N0/N3 left out, F8 / F7); the same best "
          f"method ({b['best_overall']}) and best per regime")


def _comprehensive_phase(dev, card: str, counters: dict) -> None:
    """Phase 10: the comprehensive method matrix at its default size (21
    methods x 8 regimes, 200 frames of 64 x 64 float64 from 10,000 Euler
    steps), writing benchmark_results.json to a temporary directory: warm
    wall (median of 3), [stage] lines, the DMD's host copies a regime; then
    the card against the CPU at n_seconds=0.25."""
    import tempfile
    from pathlib import Path

    from pdx_torch.pipelines import comprehensive as cr
    from pdx_torch.solve import dmd

    label = "comprehensive 21 methods x 8 regimes, 200 x 64 x 64 float64, default configuration"
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cr.ComprehensiveConfig(output_dir=tmp)
        walls, out = _warm_walls(lambda: cr.run(cfg, dev), counters, label)
        art = json.loads((Path(tmp) / "benchmark_results.json").read_text())
    _comprehensive_gates(label, out)
    if set(art) != set(out) or art["best_overall"] != out["best_overall"]:
        raise AssertionError(f"{label}: benchmark_results.json holds {sorted(art)}, best {art.get('best_overall')}")
    lottery = {f"{n}/{m}": out["results"][n][m]["error"] for m, n in sorted(F7_CELLS)}
    print(f"[comprehensive] {label}: warm wall {_wall_text(walls)}; best overall {out['best_overall']}, best per regime "
          f"{out['best_per_noise']}; M01 on N0_clean {out['results']['N0_clean']['M01_baseline']['error']!r}% (pdx on "
          f"the CPU {PDX_M01_CLEAN_ERROR!r}%); M15 on the noise-free regimes (F7) {lottery}; placement "
          f"{sorted(set(out['placement'].values()))}; benchmark_results.json written ({card})")
    cfg = cr.ComprehensiveConfig(write_artifacts=False)
    syncs = dmd.HOST_SYNCS.count
    stages = _stage_lines("comprehensive", lambda t: cr.run(cfg, dev, timer=t), COMP_STAGES, card, reps=1)
    per_regime = (dmd.HOST_SYNCS.count - syncs) / 8
    print(f"[stage] comprehensive: simulate_clean {1e6 * stages['simulate_clean'] / 10_000:.3f} us an Euler step "
          f"(10,000 eager steps); the DMD calls {1e3 * stages['dmd'] / 8:.3f} ms a regime (11 SVD projections, "
          f"{per_regime:.0f} device-to-host copies a regime); the batched ridge family "
          f"{1e3 * stages['ridge_family'] / 8:.3f} ms a regime (14 methods, one (14, n + 3, 3) QR) ({card})")
    _comprehensive_small_card_vs_cpu(dev)


S1D_CASES = [dict(scenario=s, derivative=d, regressor=r)
             for s in ("clean", "noisy", "shifted", "varying_ic")
             for d in ("spectral", "finite") for r in ("lasso", "stridge", "lstsq")]
S1D_CASES += [dict(scenario="noisy", denoise=dn, regressor="stridge") for dn in ("spectral", "gaussian", "savgol")]
S1D_CASES += [dict(scenario="shifted", register=True, register_method=m, regressor=r)
              for m in ("crosscorr", "phasecorr") for r in ("stridge", "lasso")]
S1D_STAGES = ("simulate", "preprocess", "library", "fit")
# the worst relative error of clean STRidge at the default size, from pdx on the CPU in float64 (run with pdx
# when this phase was written); the flow is chaotic over 2000 steps, so the card's run (or the port's on the
# CPU: 0.46590%) lands near it, not on it: the gate allows 10% more
PDX_S1D_CLEAN_STRIDGE_WORST = 0.46654244087340757


def _sindy1d_phase(dev, card: str, counters: dict) -> None:
    """Phase 11: sindy1d at its default size (KS-1D, N = 200, 2000 ETD
    steps): every scenario, derivative, denoiser and regressor once, and
    ensemble_over_ics; warm walls (median of 3) and [stage] lines of four
    configurations, simulate_ks1d and varying_ic_data alone; gates: finite
    coefficients, clean STRidge at pdx's error, registration helping the
    shifted data; then the card against the CPU at n_steps=400, every case."""
    import numpy as np
    import torch

    from pdx_torch.pipelines import sindy1d as s1
    from pdx_torch.sim import ks1d

    worst = {}
    for kw in S1D_CASES:
        cfg = s1.Sindy1dConfig(**kw)
        walls, out = _warm_walls(lambda: s1.run(cfg, dev), counters, f"sindy1d {kw}", reps=1)
        if not (np.isfinite(out["coeffs"]).all() and math.isfinite(out["r2"])):
            raise AssertionError(f"sindy1d {kw}: coefficients {out['coeffs']}, R2 {out['r2']}")
        worst[tuple(kw.items())] = float(out["rel_err_pct"].max())
        print(f"[sindy1d] {kw}: {walls[0]:.4f} s, coefficients {[round(float(c), 6) for c in out['coeffs']]}, worst "
              f"relative error {worst[tuple(kw.items())]:.4f}%, R2 {out['r2']:.6f}, F1 {out['f1_support']:.3f}, MAD "
              f"noise {out['noise_mad_estimate']:.4e} ({card})")
    clean = worst[(("scenario", "clean"), ("derivative", "spectral"), ("regressor", "stridge"))]
    if not clean < 1.1 * PDX_S1D_CLEAN_STRIDGE_WORST:
        raise AssertionError(f"sindy1d: clean STRidge worst error {clean}% against pdx's {PDX_S1D_CLEAN_STRIDGE_WORST}%")
    shifted = worst[(("scenario", "shifted"), ("derivative", "spectral"), ("regressor", "stridge"))]
    registered = worst[(("scenario", "shifted"), ("register", True), ("register_method", "crosscorr"),
                        ("regressor", "stridge"))]
    if not registered < shifted:
        raise AssertionError(f"sindy1d: registration did not help the shifted data: {registered}% vs {shifted}%")
    ens = s1.ensemble_over_ics(s1.Sindy1dConfig(), device=dev)
    if not np.isfinite(ens["all"]).all():
        raise AssertionError(f"sindy1d ensemble_over_ics: {ens['all']}")
    print(f"[sindy1d] clean STRidge worst error {clean:.5f}% (pdx on the CPU {PDX_S1D_CLEAN_STRIDGE_WORST:.5f}%); shifted "
          f"{shifted:.2f}% -> {registered:.5f}% registered; ensemble_over_ics median "
          f"{[round(float(c), 6) for c in ens['median']]}, std {[round(float(c), 6) for c in ens['std']]} ({card})")
    for kw in (dict(), dict(scenario="noisy", denoise="savgol", regressor="stridge"),
               dict(scenario="shifted", register=True, regressor="stridge"), dict(scenario="varying_ic", regressor="stridge")):
        cfg = s1.Sindy1dConfig(**kw)
        walls, _ = _warm_walls(lambda: s1.run(cfg, dev), counters, f"sindy1d {kw}")
        print(f"[sindy1d] {kw or 'default configuration'}: warm wall {_wall_text(walls)} ({card})")
        _stage_lines(f"sindy1d {kw or 'default'}", lambda t: s1.run(cfg, dev, timer=t), S1D_STAGES, card)
    sim = ks1d.Ks1dConfig()
    for what, fn in (("simulate_ks1d", lambda: ks1d.simulate_ks1d(sim, device=dev)),
                     ("varying_ic_data", lambda: ks1d.varying_ic_data(sim, device=dev))):
        walls, _ = _warm_walls(fn, counters, what)
        print(f"[stage] sindy1d {what} alone (2000 ETD steps, N = 200{', 2001 ICs as one batch' if 'vary' in what else ''}): "
              f"{_wall_text(walls)}, {1e6 * statistics.median(walls) / 2000:.3f} us a step ({card})")
    worst_apart, where = 0.0, None
    for kw in S1D_CASES:
        a, b = (s1.run(s1.Sindy1dConfig(n_steps=400, **kw), d) for d in (dev, "cpu"))
        e = float(np.abs(a["coeffs"] - b["coeffs"]).max() / np.abs(b["coeffs"]).max())
        if not (e < 1e-9 and a["f1_support"] == b["f1_support"]):
            raise AssertionError(f"sindy1d {kw} n_steps=400: card {a['coeffs']} vs CPU {b['coeffs']} ({e:.1e} of "
                                 f"max|coef|, limit 1e-9), F1 {a['f1_support']} / {b['f1_support']}")
        if not e <= worst_apart:
            worst_apart, where = e, kw
    print(f"[small] sindy1d n_steps=400, {len(S1D_CASES)} configurations: card and CPU apart by at most "
          f"{worst_apart:.1e} of max|coef| ({where}; limit 1e-9), the same F1 support scores")


def write_tiff(path, frame) -> None:
    """One uncompressed, single-strip, little-endian grayscale TIFF of an
    (H, W) uint8 or uint16 frame: the baseline layout lab cameras write and
    ``pdx_torch.io_host.images._fast_tiff_gray`` decodes (no PIL or cv2
    needed)."""
    import struct

    import numpy as np

    frame = np.ascontiguousarray(frame)
    if frame.ndim != 2 or frame.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"an (H, W) uint8 or uint16 frame, got {frame.shape} {frame.dtype}")
    h, w = frame.shape
    data = frame.astype(frame.dtype.newbyteorder("<"), copy=False).tobytes()
    SHORT, LONG = 3, 4
    tags = [(256, LONG, w), (257, LONG, h), (258, SHORT, 8 * frame.itemsize), (259, SHORT, 1), (262, SHORT, 1),
            (273, LONG, 0), (277, SHORT, 1), (278, LONG, h), (279, LONG, len(data)), (284, SHORT, 1)]
    offset = 8 + 2 + 12 * len(tags) + 4  # header, IFD, then the strip
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", tag, typ, 1, offset if tag == 273 else value) for tag, typ, value in tags)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8) + ifd + struct.pack("<I", 0) + data)


def write_tiff_stack(folder, U) -> None:
    """Frames of U as folder/frame_000.tif, frame_001.tif, ... (sorted names)."""
    from pathlib import Path

    Path(folder).mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(U):
        write_tiff(Path(folder) / f"frame_{i:03d}.tif", frame)


FIGURE_STAGES = ("figures_minimal", "slide3", "method_slide", "comparative_figures", "finalclass_figures",
                 "presentation_figures", "figures_refresh")
# what run_all must leave in its output root: the analyze contract, and after the heavy steps the patch
# ensemble's CSV and report and the registration, patch_sindy and transport outputs
FAST_ARTIFACTS = ("slides/best_model.json", "slides/models_comparison.json", "slides/best_model_baseline.json")
HEAVY_ARTIFACTS = ("patch_pde/PATCH_PDE_COEFFS.csv", "patch_pde/PATCH_PDE_REPORT.txt",
                   "patch_pde/patch_pde_summary.json", "registration/registration_study.json",
                   "patch_sindy/patch_sindy_results.json", "transport/transport_results.json")
COEFF_KEYS = ("coeffs", "coefficients", "agg_coeffs")


def _coefficients(node) -> list[float]:
    """Every number held under a coefficient key anywhere in a JSON payload."""
    import numpy as np

    if isinstance(node, dict):
        out = []
        for k, v in node.items():
            out += [float(c) for c in np.ravel(v)] if k in COEFF_KEYS else _coefficients(v)
        return out
    if isinstance(node, list):
        return [c for v in node for c in _coefficients(v)]
    return []


def _run_all_gates(label: str, status: dict, root, has_mpl: bool, skip_heavy: bool = False) -> int:
    """Statuses, the artifact contract and finite coefficients; returns how
    many coefficients were checked."""
    import csv
    from pathlib import Path

    from pdx_torch.pipelines.run_all import SKIPPED, list_artifacts

    for stage, st in status.items():
        want = "ok" if has_mpl or stage not in FIGURE_STAGES else SKIPPED
        if st != want:
            raise AssertionError(f"{label}: stage {stage} reads {st!r}, expected {want!r} (matplotlib "
                                 f"{'installed' if has_mpl else 'missing'})")
    arts = set(list_artifacts(root))
    contract = FAST_ARTIFACTS + (() if skip_heavy else HEAVY_ARTIFACTS)
    missing = [a for a in contract if a not in arts]
    if missing:
        raise AssertionError(f"{label}: artifacts {missing} missing from {sorted(arts)}")
    coeffs = []
    for a in contract:
        path = Path(root) / a
        if a.endswith(".json"):
            coeffs += _coefficients(json.loads(path.read_text()))
        elif a.endswith(".csv"):
            with path.open() as f:
                coeffs += [float(v) for row in csv.DictReader(f) for k, v in row.items() if k != "term"]
    bad = [c for c in coeffs if not math.isfinite(c)]
    if bad or not coeffs:
        raise AssertionError(f"{label}: {len(bad)} of {len(coeffs)} coefficients not finite")
    return len(coeffs)


def _busy_share(fn) -> tuple[float, float, int, float]:
    """(host wall in s, device busy share of it, device events, seconds to
    read the trace) of one call of fn under torch.profiler (CUDA activity
    only), as tools/torch_patch_profile.py reckons it: one stream, so the
    device events overlap nothing and their summed time is the busy time.
    The events are read from the profiler's kineto results as they are:
    building its event tree for a run's ~350k events took 56 s."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in events) / 1e9
    return wall, busy / wall, len(events), time.perf_counter() - t0


def _run_all_small_card_vs_cpu(dev, card: str, has_mpl: bool) -> None:
    """run_all(skip_heavy=True) on the card and on the CPU on 16 TIFFs of
    220 x 220 (the size of pdx's own run_all test, skip 10, subsample 6):
    the same statuses and selected model, best-model coefficients within
    1e-5 of max|coef| (the registration-on limit: float32 Farnebäck flows)."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines.run_all import RunAllConfig, run

    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "tiffs"
        write_tiff_stack(data, make_stack(T=16, H=220, W=220))
        best, status = {}, {}
        for d in (dev, "cpu"):
            root = Path(tmp) / str(d)
            status[str(d)] = run(RunAllConfig(data_dir=str(data), output_root=str(root), max_images=16,
                                              skip_heavy=True, skip=10, subsample=6), d)
            _run_all_gates(f"run_all small on {d}", status[str(d)], root, has_mpl, skip_heavy=True)
            best[str(d)] = json.loads((root / "slides" / "best_model.json").read_text())
    a, b = best[str(dev)], best["cpu"]
    ca, cb = np.asarray(a["coeffs"]), np.asarray(b["coeffs"])
    apart = float(np.abs(ca - cb).max() / np.abs(cb).max()) if ca.shape == cb.shape else math.inf
    if not (status[str(dev)] == status["cpu"] and a["name"] == b["name"] and apart < 1e-5):
        raise AssertionError(f"run_all small: card {status[str(dev)]} {a['name']} {ca} vs CPU {status['cpu']} "
                             f"{b['name']} {cb} ({apart:.1e} of max|coef|, limit 1e-5)")
    print(f"[small] run_all skip_heavy 16 x 220 x 220 TIFFs: the same statuses {sorted(set(status['cpu'].values()))} "
          f"and selected model ({a['name']}); best-model coefficients apart by {apart:.1e} of max|coef| (limit 1e-5) "
          f"({card})")


def _run_all_phase(data_dir, dev, card: str, counters: dict) -> None:
    """Phase 12: the CLI's list-resolutions and doctor as subprocesses, then
    run_all at the real dataset's shape from the TIFFs in ``data_dir`` (51
    uncompressed uint16 frames of 1024 x 1280): one cold run (no stack in
    the process, an empty disk cache), two warm ones and one traced for the
    busy share; the cold path's parts alone; presentation_flow_data at the
    real shape; then [small], the card against the CPU."""
    import importlib.util
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from pdx_torch.io_host import images
    from pdx_torch.pipelines.run_all import RunAllConfig, list_artifacts, run
    from pdx_torch.report.comparative import presentation_flow_data
    from pdx_torch.utils.profiling import StageTimer

    root = Path(__file__).resolve().parent
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    cli = [sys.executable, "-m", "pdx_torch"]
    res = subprocess.run(cli + ["list-resolutions", "--data-dir", str(data_dir)], cwd=root, capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0 or res.stdout.strip() != "1024 x 1280: 51 files":
        raise AssertionError(f"list-resolutions: rc {res.returncode}, {res.stdout!r} {res.stderr[-2000:]}")
    print(f"[run_all] python -m pdx_torch list-resolutions: {res.stdout.strip()!r}, rc 0 ({card})")
    res = subprocess.run(cli + ["doctor"], cwd=root, capture_output=True, text=True, timeout=600)
    if res.returncode != 0 or "kernels: 5 of 5 loaded" not in res.stdout or f"card 0: {card}" not in res.stdout:
        raise AssertionError(f"doctor: rc {res.returncode}\n{res.stdout}\n{res.stderr[-2000:]}")
    print("[run_all] python -m pdx_torch doctor: rc 0 | " + " | ".join(res.stdout.strip().splitlines()) + f" ({card})")

    label = "run_all 51 x 1024 x 1280 uint16 TIFFs, default configuration"
    with tempfile.TemporaryDirectory() as tmp:
        out_root = Path(tmp) / "outputs"
        cfg = RunAllConfig(data_dir=str(data_dir), output_root=str(out_root))
        os.environ["XDG_CACHE_HOME"] = str(Path(tmp) / "cache")  # the disk cache of decoded stacks: empty
        images.clear_stack_memcache()
        walls = []
        for what in ("cold", "warm", "warm"):
            base = _launch_totals(counters)
            timer = StageTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            status = run(cfg, dev, timer)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            images.flush_stack_cache_writes()
            moved = _launches_since(counters, base)
            if any(moved.values()):
                raise AssertionError(f"{label}: this path launches none of K1-K4, yet {moved}")
            n_coeffs = _run_all_gates(label, status, out_root, has_mpl)
            stages = ", ".join(f"{k} {status[k]} {v:.4f} s" for k, v in timer.stages.items())
            print(f"[run_all] {label} {what}: wall {walls[-1]:.4f} s; stages {stages}; {n_coeffs} coefficients "
                  f"finite ({card})")
        n_arts = len(list_artifacts(out_root))
        traced, busy, n_events, read = _busy_share(lambda: run(cfg, dev))
        print(f"[run_all] {label}: cold wall {walls[0]:.4f} s, warm walls {walls[1]:.4f}, {walls[2]:.4f} s; one warm "
              f"run traced: {traced:.4f} s, the device {100 * busy:.1f}% busy ({n_events} device events, the trace "
              f"read in {read:.1f} s); {n_arts} artifacts; statuses {status} ({card})")

        # the cold path alone: decode, the disk cache's hit, the upload
        cache = Path(tmp) / "cold_path"
        t0 = time.perf_counter()
        U = images.load_images(data_dir, cache=False)
        decode = time.perf_counter() - t0
        images.load_images(data_dir, cache_dir=cache)
        images.flush_stack_cache_writes()
        images.clear_stack_memcache()
        t0 = time.perf_counter()
        hit = np.asarray(images.load_images(data_dir, cache_dir=cache)).sum()  # the mmap read in full
        from_disk = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = torch.as_tensor(U).to(dev).to(torch.float64)
        torch.cuda.synchronize()
        upload = time.perf_counter() - t0
        if not hit == U.sum():
            raise AssertionError("the disk cache returned another stack")
        print(f"[run_all] cold path alone: decode of {U.shape[0]} TIFFs ({U.shape[0] * U[0].size * 2 / 1e6:.1f} MB of "
              f"uint16 pixels) {decode:.4f} s; disk-cache hit read in full {from_disk:.4f} s; upload of the float32 "
              f"stack ({U.nbytes / 1e6:.1f} MB) and cast to float64 on the card {upload:.4f} s ({card})")
        del on_card

        U5 = images.load_images(data_dir, max_images=5)
        U5 = U5 / (U5.max() + 1e-12)
        flow = presentation_flow_data(U5, dev)
        before, after = float(flow["before"].mean()), float(flow["after"].mean())
        if not (all(np.isfinite(v).all() for v in flow.values()) and flow["fx"].shape == (512, 640)
                and after < before):
            raise AssertionError(f"presentation_flow_data: shapes {[v.shape for v in flow.values()]}, mean |diff| "
                                 f"{before} -> {after}")
        print(f"[run_all] presentation_flow_data 3 frames at 512 x 640: mean |diff| {before:.6f} -> {after:.6f} after "
              f"registration; max |flow| {float(np.abs(np.stack([flow['fx'], flow['fy']])).max()):.4f} px ({card})")
        os.environ.pop("XDG_CACHE_HOME")
    _run_all_small_card_vs_cpu(dev, card, has_mpl)


def _on_off(label: str, run, counters: dict, card: str) -> tuple[dict, dict]:
    """``run(mode)`` with the mesh "off" once (a warm-up), then off and on in
    turns three times, each call timed on the host clock and ended by a
    synchronize, every launch count read before and after them: prints both warm
    walls (median of 3) and returns the last (off, on) results."""
    import torch

    run("off")
    walls, out = {"off": [], "on": []}, {}
    base = _launch_totals(counters)
    for _ in range(3):
        for mode in ("off", "on"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[mode] = run(mode)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
    moved = _launches_since(counters, base)
    if any(moved.values()):
        raise AssertionError(f"{label}: this path launches none of K1-K4, yet {moved}")
    off, on = (statistics.median(walls[m]) for m in ("off", "on"))
    print(f"[mesh] {label}: warm wall off {_wall_text(walls['off'])}, on {_wall_text(walls['on'])}; on - off "
          f"{on - off:+.4f} s ({100 * (on - off) / off:+.1f}%; recorded, not claimed) ({card})")
    return out["off"], out["on"]


def _held(label: str, on, off, rtol: float, atol: float, card: str) -> None:
    """Coefficients with the mesh on against off, within (rtol, atol)."""
    import numpy as np

    on, off = np.asarray(on, dtype=float), np.asarray(off, dtype=float)
    np.testing.assert_allclose(on, off, rtol=rtol, atol=atol, err_msg=label)
    print(f"[mesh] {label}: coefficients on against off apart by at most {np.abs(on - off).max():.3e} "
          f"(rtol {rtol:g}, atol {atol:g}) ({card})")


def _mesh_phase(full, dev, card: str, counters: dict) -> None:
    """Phase 13: the multi-device mesh (``pdx_torch.shard``) at full size.
    The mesh holds every card when there are more than one, else 4 virtual
    shards of ``dev``. With the mesh on and off, warm walls in turns (median
    of 3) and the coefficients against each other, of: ks2d_bench at its
    default size, float64, solver "gram" without the grid (the standard fit
    takes the sample-sharded Gram); the patch ensemble on ``full`` (51 x
    1024 x 1280 uint16) with registration off (the patch axis is split; the
    chain, which is not, is phase 5's); patch_sindy without registration on
    the same stack read as 8-bit / 255 (the patch axis split); comprehensive
    at the card-against-CPU size of phase 10 (regimes round-robin over the
    slots, the ridge family split over them; "off" is multi_device=False);
    then dryrun_multichip over the mesh. Gates: the limits of
    tests/test_torch_shard.py, n_shard_devices equal to the mesh's size with
    the mesh on and 1 off, the regimes over min(regimes, slots) slots."""
    import numpy as np
    import torch

    from pdx_torch.pipelines import comprehensive as cr
    from pdx_torch.pipelines import ks2d_bench as kb
    from pdx_torch.pipelines import patch_discovery as pd
    from pdx_torch.pipelines import patch_sindy as ps
    from pdx_torch.shard.dryrun import dryrun_mesh, dryrun_multichip

    t_phase = time.perf_counter()
    n = torch.cuda.device_count() if torch.cuda.device_count() > 1 else 4
    mesh = dryrun_mesh(n, dev)  # every card, or 4 virtual shards of the one card
    print(f"[mesh] {n} slots on {len(set(mesh.devices))} distinct card(s): "
          f"{[mesh.slot_name(i) for i in range(n)]} ({card})")

    label = "ks2d_bench 100x100, 2000 steps, float64, solver gram, no grid"
    off, on = _on_off(label, lambda m: kb.run(kb.Ks2dBenchConfig(solver="gram", mesh=m), dev, mesh), counters, card)
    _held(label, on["coeffs"], off["coeffs"], 1e-9, 1e-12, card)
    worst = max(v["rel_err_pct"] for v in on["gt_errors"].values())
    if not worst < 1.0:
        raise AssertionError(f"{label}: recovery degraded with the mesh on: {on['gt_errors']}")

    label = "patch ensemble 51x1024x1280 uint16, registration off"
    cfg = pd.PatchDiscoveryConfig(data_dir="unused", registration=False, write_artifacts=False)
    off, on = _on_off(label, lambda m: pd.run(dataclasses.replace(cfg, mesh=m), U_raw=full, device=dev, mesh=mesh),
                      counters, card)
    _held(label, on["patch_coeffs"], off["patch_coeffs"], 1e-10, 1e-13, card)
    if (on["n_shard_devices"], off["n_shard_devices"]) != (n, 1):
        raise AssertionError(f"{label}: n_shard_devices {on['n_shard_devices']} on, {off['n_shard_devices']} off")
    print(f"[mesh] {label}: {on['n_patches']} patches, n_shard_devices {on['n_shard_devices']} on, "
          f"{off['n_shard_devices']} off ({card})")

    label = "patch_sindy 51x1024x1280 u8/255, no registration"
    f255 = (full >> 8).astype(np.uint8) / 255.0
    f255.setflags(write=False)
    cfg = ps.PatchSindyConfig(data_dir="unused", write_artifacts=False)
    off, on = _on_off(label, lambda m: ps.run(dataclasses.replace(cfg, mesh=m), U_raw=f255, device=dev, mesh=mesh),
                      counters, card)
    _held(label, on["patch_coeffs"], off["patch_coeffs"], 1e-7, 1e-9, card)
    _held(label + ", ensemble", on["coeffs"], off["coeffs"], 1e-7, 1e-9, card)
    if (on["n_shard_devices"], off["n_shard_devices"]) != (n, 1):
        raise AssertionError(f"{label}: n_shard_devices {on['n_shard_devices']} on, {off['n_shard_devices']} off")
    print(f"[mesh] {label}: {on['n_patches']} patches, n_shard_devices {on['n_shard_devices']} on, "
          f"{off['n_shard_devices']} off ({card})")
    del f255

    label = "comprehensive n_seconds=0.25, 4 regimes x 21 methods"
    off, on = _on_off(label, lambda m: cr.run(cr.ComprehensiveConfig(**COMP_SMALL, multi_device=m == "on"), dev,
                                              mesh=mesh), counters, card)
    cells = [(reg, m) for reg in off["results"] for m in off["results"][reg]
             if m != F8_METHOD and (m, reg) not in F7_CELLS]
    for reg, m in cells:
        c_off = np.asarray(off["results"][reg][m]["coef"])
        held = np.abs(np.asarray(on["results"][reg][m]["coef"]) - c_off).max() <= 1e-8 * np.abs(c_off).max()
        if not held or "error_msg" in on["results"][reg][m]:
            raise AssertionError(f"{label}: {reg}/{m} on {on['results'][reg][m]} against off {off['results'][reg][m]}")
    apart = max(np.abs(np.asarray(on["results"][r][m]["coef"]) - np.asarray(off["results"][r][m]["coef"])).max()
                for r, m in cells)
    slots = set(on["placement"].values())
    if len(slots) != min(len(on["placement"]), n) or set(off["placement"].values()) != {str(dev)}:
        raise AssertionError(f"{label}: placement on {on['placement']}, off {off['placement']}")
    print(f"[mesh] {label}: every method on against off apart by at most {apart:.3e} (limit 1e-8 of max|coef|; "
          f"M04 and M15 on N0/N3 left out, F8 / F7); placement on {on['placement']} ({card})")

    t0 = time.perf_counter()
    summary = dryrun_multichip(n, dev)
    print(f"[mesh] dryrun_multichip({n}) {time.perf_counter() - t0:.2f} s: {summary} ({card})")
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s ({card})")


def main() -> int:
    import os

    # grow the allocator's segments in place rather than caching many fixed ones: less memory held for
    # nothing between phases, on a card other processes may share
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[memory] at start: {free / GIB:.2f} of {total / GIB:.2f} GiB free; compute processes: "
          f"{_other_processes()}")

    # 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s (sources {_build.source_hash()})")
    _print_occupancy(_build.library(), kg, kb, dev, card)

    _phase_memory("build", dev)

    # 2. kernels vs plain versions on the card
    _await_card("the kernels", dev)
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
            counter="fused_ks_gram.launches", blockwise=False, main=[TRUE], ragged=[TRUE],
        ),
        "fused_ks_gram_terms": dict(
            wrapper=lambda U, Ut, names: kg.fused_ks_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names),
            plain=lambda U, Ut, names: kg._terms_reference(U, Ut, 0.5, 0.5, names),
            source="pdx_torch/csrc/fused_gram_terms.cu",
            replaces="pdx/ops/pallas/fused_gram.py:177",
            counter="fused_ks_gram_terms.launches", blockwise=False, main=[RICH, ADV], ragged=[NO_ADV, ADV],
        ),
        "fused_blockwise_gram": dict(
            wrapper=lambda U, Ut, names: kb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw3),
            plain=lambda U, Ut, names: kb.fused_blockwise_gram_reference(U, Ut, 0.5, 0.5, **kw3),
            source="pdx_torch/csrc/fused_blockwise.cu",
            replaces="pdx/ops/pallas/fused_blockwise.py:272",
            counter="fused_blockwise_gram.launches", blockwise=True, main=[TRUE], ragged=[TRUE],
        ),
        "fused_blockwise_gram_terms": dict(
            wrapper=lambda U, Ut, names: kb.fused_blockwise_gram_terms(U, Ut, dx=0.5, dy=0.5, names=names, **kw3),
            plain=lambda U, Ut, names: kb.fused_blockwise_gram_terms_reference(U, Ut, 0.5, 0.5, names=names, **kw3),
            source="pdx_torch/csrc/fused_blockwise_terms.cu",
            replaces="pdx/ops/pallas/fused_blockwise.py:179",
            counter="fused_blockwise_gram_terms.launches", blockwise=True, main=[RICH], ragged=[NO_ADV, ADV],
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
    _phase_memory("the kernels", dev)

    # 2b. the Farnebäck flow's kernels vs their plain versions, at the main paths' shapes
    _await_card("the flow kernels", dev)
    flow_results = _flow_kernels(dev, card)
    _phase_memory("the flow kernels", dev)

    # 3. the main paths at full size; launch counts read before and after each run
    _await_card("the KS-2D paths", dev)
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

    counters = {n: s["counter"] for n, s in specs.items()}
    launches = {name: 0 for name in specs}
    for label, (kw, needs, gate, p) in configs.items():
        launch_base = _launch_totals(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(Ks2dBenchConfig(**base, **kw), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = _launches_since(counters, launch_base)
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
    _phase_memory("the KS-2D paths", dev)

    # 4. the card against the CPU on a small input
    _await_card("the KS-2D card against the CPU", dev)
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
    _phase_memory("the KS-2D card against the CPU", dev)

    # 5-7. the real-image pipelines, on one stack of the real dataset's shape
    from tools.make_synth_stack import make_stack

    t0 = time.perf_counter()
    full = make_stack(T=51, H=1024, W=1280)
    full.setflags(write=False)  # a read-only stack is shipped to the card once (io_host.images.device_stack)
    print(f"[patch] made the 51 x 1024 x 1280 uint16 stack on the host in {time.perf_counter() - t0:.2f} s")
    _await_card("[patch]", dev)
    flow_launches = collections.Counter()  # the flow kernels' launches in the main paths' timed runs
    _patch_phase(full, dev, card, counters, flow_launches)
    _phase_memory("[patch]", dev)
    full_u8 = (full >> 8).astype(np.uint8)  # what load_images(mode="grayscale_u8") makes of 16-bit frames
    full_u8.setflags(write=False)
    _await_card("[analyze]", dev)
    _analyze_phase(full_u8, dev, card, counters)
    _phase_memory("[analyze]", dev)
    del full_u8
    _await_card("[transport]", dev)
    _transport_phase(full, dev, card, counters, flow_launches)
    _phase_memory("[transport]", dev)
    f255 = (full >> 8).astype(np.uint8) / 255.0  # what patch_sindy makes of 8-bit TIFFs
    f255.setflags(write=False)
    _await_card("[patch_sindy]", dev)
    _patch_sindy_phase(f255, dev, card, counters)
    _phase_memory("[patch_sindy]", dev)
    del f255
    _await_card("[improved_registration]", dev)
    _improved_registration_phase(full, dev, card, counters, flow_launches)
    _phase_memory("[improved_registration]", dev)
    for name in FLOW_KERNELS:
        flow_results[name]["launches"] = flow_launches[name]
        if flow_launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the main paths")
    print(f"[kernel] the flow kernels' launches in the timed runs of the patch, transport and improved_registration "
          f"paths: {dict(flow_launches)} ({card})")
    import tempfile

    tiffs = tempfile.TemporaryDirectory()  # phase 12 reads the stack from disk
    t0 = time.perf_counter()
    write_tiff_stack(tiffs.name, full)
    print(f"[run_all] wrote the stack as 51 uncompressed uint16 TIFFs in {time.perf_counter() - t0:.2f} s ({card})")

    # 10-11. the comprehensive method matrix and sindy1d (no kernel on either path)
    _await_card("[comprehensive]", dev)
    _comprehensive_phase(dev, card, counters)
    _phase_memory("[comprehensive]", dev)
    _await_card("[sindy1d]", dev)
    _sindy1d_phase(dev, card, counters)
    _phase_memory("[sindy1d]", dev)

    # 12. run_all and the CLI, from TIFFs on disk (no kernel on the path)
    _await_card("[run_all]", dev)
    _run_all_phase(tiffs.name, dev, card, counters)
    _phase_memory("[run_all]", dev)
    tiffs.cleanup()

    # 13. the multi-device mesh, with it on and off (no kernel on these paths)
    _await_card("[mesh]", dev)
    _mesh_phase(full, dev, card, counters)
    _phase_memory("[mesh]", dev)
    del full

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": specs[name]["source"],
         "replaces": specs[name]["replaces"], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        for name, r in results.items()
    ] + [
        {"name": name, "route": "cuda", "source": "pdx_torch/csrc/farneback.cu", "replaces": None,
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        for name, r in flow_results.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
