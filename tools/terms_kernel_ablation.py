#!/usr/bin/env python3
"""Where K1-K4 spend their time on the card: time each kernel with parts removed.

    python tools/terms_kernel_ablation.py            # on a machine with a CUDA card and nvcc
    python tools/terms_kernel_ablation.py --sweep    # K1/K3 at other launch shapes instead

Each variant is the kernel's source with one or more statements replaced
(the replacements are below; a variant fails loudly if its statement is no
longer in the source). Every variant is compiled by nvcc (sm_90a, one
process per variant, in parallel) into ``build/ablation/`` and timed
through its C entry point at the main path's (1999, 100, 100) float32
input, 3 x 8 x 8 blocks for K3 and K4: CUDA-event median of 15 launches
after one warm-up. A variant without a part computes wrong statistics; only its time
is of interest. The difference between the full kernel and a variant is the
time that part costs where it does not overlap the rest. ``--sweep`` times
the unchanged K1 and K3 (float32 and float64 input) on every copy route the
input allows, at band heights and thread counts other than the wrappers'
plans.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "pdx_torch" / "csrc"
OUT = ROOT / "build" / "ablation"
K1, K3 = "fused_gram.cu", "fused_blockwise.cu"
K2, K4 = "fused_gram_terms.cu", "fused_blockwise_terms.cu"
ADV = ("lap", "bih", "gradsq", "ux", "uy")

# statements removed or replaced, by the part they stand for
K2_GRAM = [
    ("gram_chunk<kTwo, 0>(wb, lc, k, acc);", ""),
    ("gram_chunk<kTwo, 1>(wb, lc, k + 1, acc);", ""),
]
K2_BATCHES = [(
    "for (int b0 = warp * 32; b0 < npt; b0 += step) {",
    "for (int b0 = npt + warp * 32; b0 < npt; b0 += step) {",
)]
RING = [("ring_laplacian(su, TH, TW, d, sl);", "")]
K4_POINTS = [("for (int q = g; q < nv; q += G) {", "for (int q = g + nv; q < nv; q += G) {")]
K2_LOADS = [("if (more) pipe.issue(U + (t + 1) * frame, nullptr, cur ^ 1);", "")]
K4_LOADS = [("if (more) pipe.issue(U + (t + 1) * frame, Ut + (t + 1) * frame, cur ^ 1);", "")]
K4_NO_WAIT = [('asm volatile("cp.async.wait_group 0;\\n" ::: "memory");', "")]
K4_NO_UT_COPY = [("if (fs.vh > 0) {\n      const In* src0", "if (fs.vh < 0) {\n      const In* src0")]
K4_BLOCK_END = [(
    "const bool block_done = ++nf == bt || !more;",
    "const bool block_done = (++nf == bt || !more) && T < 0;",
)]

BAND_RING = [("band_laplacian(su, th, W, d, sl);", "")]
# a wait can go only together with the copies it waits for: a stage's
# barrier must not be armed again before its last copy has been waited for
BAND_NO_WAIT = [("mbar_wait(bar + b, parity);", "")]
BAND_LOADS = BAND_NO_WAIT + [
    ("if (more) pipe.issue(U + (t + 1) * frame, Ut + (t + 1) * frame, cur ^ 1);", ""),
]
K1_POINTS = [("for_my_cells(n_strips, W, [&](int q, int c) {", "for_my_cells(0, W, [&](int q, int c) {")]
K1_STATS = [(  # one conversion and one add a sample keep the stencil alive
    "accumulate(acc, lap, bih, gsq, to_f32(ut[i]));",
    "acc[0] += (double)(lap + bih + gsq + to_f32(ut[i]));",
)]
K3_POINTS = K4_POINTS + [("band_strip_terms(su, sl, W, rx0, rx0 + vbx,", "band_strip_terms(su, sl, W, rx0, rx0,")]
K3_BLOCK_END = [("if (++nf == bt || t + 1 == t_end) {", "if ((++nf == bt || t + 1 == t_end) && T < 0) {")]

VARIANTS = {
    "K1": (K1, 3, []),
    "K1, no copies after the first frame (and no waits)": (K1, 3, BAND_LOADS),
    "K1, no statistics (one add a sample)": (K1, 3, K1_STATS),
    "K1, no points (frame pipeline and ring only)": (K1, 3, K1_POINTS),
    "K1, no ring": (K1, 3, BAND_RING),
    "K1, frame pipeline only": (K1, 3, K1_POINTS + BAND_RING),
    "K3": (K3, 3, []),
    "K3, no copies after the first frame (and no waits)": (K3, 3, BAND_LOADS),
    "K3, no block-end (reductions, means, statistics)": (K3, 3, K3_BLOCK_END),
    "K3, no point loop": (K3, 3, K3_POINTS),
    "K3, no ring": (K3, 3, BAND_RING),
    "K3, frame pipeline only": (K3, 3, K3_POINTS + BAND_RING + K3_BLOCK_END),
    "K2 p=9": (K2, 9, []),
    "K2 p=9, no Gram (mma and its loads)": (K2, 9, K2_GRAM),
    "K2 p=5": (K2, 5, []),
    "K2 p=5, no Gram (mma and its loads)": (K2, 5, K2_GRAM),
    "K2 p=5, no loads after the first frame": (K2, 5, K2_LOADS),
    "K2 p=5, no point batches (frame pipeline and ring only)": (K2, 5, K2_BATCHES),
    "K2 p=5, frame pipeline only": (K2, 5, K2_BATCHES + RING),
    "K4 p=9": (K4, 9, []),
    "K4 p=9, no loads after the first frame": (K4, 9, K4_LOADS),
    "K4 p=9, copies never waited for": (K4, 9, K4_NO_WAIT),
    "K4 p=9, no u_t copies": (K4, 9, K4_NO_UT_COPY),
    "K4 p=9, no block-end (reductions, means, Gram)": (K4, 9, K4_BLOCK_END),
    "K4 p=9, no point loop": (K4, 9, K4_POINTS),
    "K4 p=9, no ring": (K4, 9, RING),
    "K4 p=9, frame pipeline only": (K4, 9, K4_POINTS + RING + K4_BLOCK_END),
}


def _build() -> dict[str, Path]:
    from pdx_torch.ops.kernels._build import NVCC_FLAGS, _nvcc

    # every variant's sources first, so that a stale statement stops the
    # tool before any compiler runs
    sources = {}
    for name, (source, _, subs) in VARIANTS.items():
        files = {f.name: f.read_text() for f in CSRC.glob("*.cuh")}
        files[source] = (CSRC / source).read_text()
        for old, new in subs:
            hits = [f for f, text in files.items() if old in text]
            if not hits:
                raise SystemExit(f"{name}: statement not found in {source} or its headers: {old}")
            for f in hits:
                files[f] = files[f].replace(old, new)
        sources[name] = (source, files)
    libs, procs = {}, []
    for i, (name, (source, files)) in enumerate(sources.items()):
        vdir = OUT / f"v{i}"  # the kernel and its headers, edited
        vdir.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (vdir / f).write_text(text)
        libs[name] = OUT / f"v{i}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(libs[name]), str(vdir / source)]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed\n{out}")
    if failed:
        raise SystemExit("\n".join(failed))
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("terms_kernel_ablation.py: no CUDA card visible")
    from pdx_torch.ops.kernels import fused_blockwise as kb
    from pdx_torch.ops.kernels import fused_gram as kg
    from pdx_torch.ops.kernels._build import _SIGNATURES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    T, H, W = shape = (1999, 100, 100)
    U = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    Ut = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    stencil = kg._stencil_args(0.5, 0.5)

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(15):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def bind(lib):
        for fn, (restype, argtypes) in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        return lib

    def band_launch(lib, source, Uk, Utk, f64, TH_or_kb, threads=None, route=kg._ROUTE_BULK):
        """(launch, registers, CTAs per SM, text) of K1 at bands of TH rows and
        `threads` threads, or of K3 at bands of kb block-rows, frames staged
        by `route`."""
        regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        out = torch.empty(14, dtype=torch.float64, device=dev)
        if source == K1:
            TH, n_bands = TH_or_kb, -(-H // TH_or_kb)
            rc = lib.pdx_fused_ks_gram_occupancy(TH, W, threads, f64, route, ctypes.byref(regs), ctypes.byref(ctas))
            fpc, n_chunks = kg._long_chunks(T, n_bands, n_sm * max(1, ctas.value))
            part = torch.empty((n_bands * n_chunks, 14), dtype=torch.float64, device=dev)

            def launch():
                return lib.pdx_fused_ks_gram(
                    Uk.data_ptr(), Utk.data_ptr(), f64, route, T, H, W, TH, threads, fpc, n_bands, n_chunks,
                    *stencil, part.data_ptr(), out.data_ptr(), stream,
                )
            text = f"{kg.ROUTE_NAMES[route]}, bands of {TH} rows, {threads} threads, {n_bands} x {n_chunks} CTAs of {fpc} frames"
        else:
            kbr, G = TH_or_kb, kb._group_threads(8, 8)
            n_bands = -(-(-(-H // 8)) // kbr)
            rc = lib.pdx_fused_blockwise_occupancy(
                W, 8, 8, kbr, G, f64, route, ctypes.byref(regs), ctypes.byref(ctas))
            tpc, n_chunks = kg._long_chunks(-(-T // 3), n_bands, n_sm * max(1, ctas.value))
            part = torch.empty((n_bands * n_chunks, 14), dtype=torch.float64, device=dev)

            def launch():
                return lib.pdx_fused_blockwise_gram(
                    Uk.data_ptr(), Utk.data_ptr(), f64, route, T, H, W, 3, 8, 8, kbr, G, tpc, n_bands,
                    n_chunks, *stencil, part.data_ptr(), out.data_ptr(), stream,
                )
            text = (f"{kg.ROUTE_NAMES[route]}, bands of {kbr} block-rows, {-(-kbr * -(-W // 8) * G // 32) * 32} threads, "
                    f"{n_bands} x {n_chunks} CTAs of {tpc} temporal blocks")
        if rc != 0:
            raise SystemExit(f"occupancy query failed with CUDA error {rc}")
        return launch, regs.value, ctas.value, text

    def report(label, launch, regs, ctas, strict=True):
        rc = launch()
        torch.cuda.synchronize()
        if rc != 0 and strict:
            raise SystemExit(f"{label}: launch failed with CUDA error {rc}")
        if rc != 0:  # a sweep may ask for more threads than the registers allow
            print(f"[ablation] {label}: launch refused with CUDA error {rc} ({card})")
            return
        print(f"[ablation] {label}: {median_ms(launch):.4f} ms ({regs} registers, {ctas} CTAs per SM) ({card})")

    if "--sweep" in sys.argv[1:]:
        from pdx_torch.ops.kernels._build import library

        lib = library()
        U64, Ut64 = U.double(), Ut.double()
        limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        for f64, (Uk, Utk) in enumerate([(U, Ut), (U64, Ut64)]):
            kind = "float64" if f64 else "float32"
            for route in (kg._ROUTE_BULK, kg._ROUTE_ELEMENTWISE) + ((kg._ROUTE_ROUNDED,) if f64 else ()):
                staged64 = int(f64 and route != kg._ROUTE_ROUNDED)
                for TH in (100, 50, 25):
                    for threads in (256, 512, 768) if route == kg._ROUTE_BULK else (512,):
                        if lib.pdx_band_smem_bytes(TH, W, staged64) <= limit:
                            launch, regs, ctas, text = band_launch(lib, K1, Uk, Utk, f64, TH, threads, route)
                            report(f"K1 {kind}, {text}", launch, regs, ctas, strict=False)
                for kbr in (1, 2, 3, 5, 7):
                    if lib.pdx_fused_blockwise_smem_bytes(W, 8, 8, kbr, kb._group_threads(8, 8), staged64) <= limit:
                        launch, regs, ctas, text = band_launch(lib, K3, Uk, Utk, f64, kbr, None, route)
                        report(f"K3 {kind}, {text}", launch, regs, ctas, strict=False)
        return 0

    libs = _build()
    for name, (source, p, _) in VARIANTS.items():
        lib = bind(ctypes.CDLL(str(libs[name])))
        if source in (K1, K3):
            if source == K1:
                _, TH, threads, *_ = kg._gram_launch(T, H, W, 0, kg._ROUTE_BULK, dev)
                launch, regs, ctas, _ = band_launch(lib, K1, U, Ut, 0, TH, threads)
            else:
                _, kbr, *_ = kb._blockwise_launch(T, H, W, 3, 8, 8, 0, kg._ROUTE_BULK, dev)
                launch, regs, ctas, _ = band_launch(lib, K3, U, Ut, 0, kbr)
            report(name, launch, regs, ctas)
            continue
        names = kg.RICH_TERM_NAMES if p == 9 else ADV
        codes = kg._codes_arg(names)
        n_stats = p * (p + 1) // 2 + 2 * p + 2
        regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
        if source == K2:
            TH, TW, fpc, ntx, nty, ntz = kg._terms_launch(T, H, W, 0, dev)
            # the occupancy query also raises the variant's shared-memory limit
            lib.pdx_fused_ks_gram_terms_occupancy(TH, TW, 0, p, ctypes.byref(regs), ctypes.byref(ctas))
            part = torch.empty((ntx * nty * ntz, n_stats), dtype=torch.float64, device=dev)
            out = torch.empty(n_stats, dtype=torch.float64, device=dev)

            def launch():
                return lib.pdx_fused_ks_gram_terms(
                    U.data_ptr(), Ut.data_ptr(), 0, T, H, W, TH, TW, fpc, ntx, nty, ntz, *stencil,
                    codes, p, part.data_ptr(), out.data_ptr(), stream,
                )
        else:
            kbx, kby, G, tpc, ntx, nty, ntz = kb._blockwise_terms_launch(T, H, W, 3, 8, 8, 0, dev)
            lib.pdx_fused_blockwise_terms_occupancy(kbx, kby, 8, 8, G, 0, ctypes.byref(regs), ctypes.byref(ctas))
            part = torch.empty((ntx * nty * ntz, n_stats), dtype=torch.float64, device=dev)
            out = torch.empty(n_stats, dtype=torch.float64, device=dev)

            def launch():
                return lib.pdx_fused_blockwise_gram_terms(
                    U.data_ptr(), Ut.data_ptr(), 0, T, H, W, 3, 8, 8, kbx, kby, G, tpc, ntx, nty, ntz,
                    *stencil, codes, p, part.data_ptr(), out.data_ptr(), stream,
                )

        report(name, launch, regs.value, ctas.value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
