"""Time the Farnebäck flow's window kernels (``ops/kernels/flow_windows``)
on the card at the benchmark cells' shapes, beside their plain versions and
their byte bounds, and check each against its plain version.

    python tools/flow_windows_bench.py [--out outputs/flow_windows_bench.json]

Shapes: the quality sweep's chunk (6 float64 pairs of 1024x1280, poly_n 5,
box window 15), ``transport``'s batch (50 float64 pairs of 256x320, the
same), the patch chain's and the study's chain's flow grids (one float32
pair of 256x320 and of 512x640, poly_n 7, Gaussian window 25) and the 11-tap flow smoothing of the DIS chain (float64
2x1024x1280) and the patch chain (float32 2x512x640). Times are CUDA-event
medians of 20 calls after 3 warm ones; a bound is each input plane read
once and each output plane written once at 3.35 TB/s. A gap is the
largest difference from the plain result on the card, over its largest
magnitude; for the float32 flows the plain flow's gap between the card and
the CPU stands beside it (the same frames: what the summation order alone
moves).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM = 3.35e12


def _median_ms(fn, reps=20) -> float:
    import torch

    for _ in range(3):
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="outputs/flow_windows_bench.json")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flow_windows_bench.py: no CUDA card visible")
    from pdx_torch.ops.kernels import flow_windows as fw
    from pdx_torch.register import farneback as fb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(name, shape, dtype, kernel_fn, plain_fn, nbytes, check=None):
        t_k = _median_ms(kernel_fn)
        t_p = _median_ms(plain_fn, reps=5) if plain_fn is not None else None
        bound = nbytes / HBM * 1e3
        row = {"kernel": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
               "kernel_ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_share": bound / t_k,
               "gap": check() if check is not None else None}
        rows.append(row)
        print(f"{name:<34}{str(tuple(shape)):<22}{row['dtype']:<9}kernel {t_k:9.4f} ms  plain "
              f"{t_p if t_p is None else round(t_p, 4)!s:>9} ms  bound {bound:8.4f} ms ({100 * bound / t_k:5.1f}%)"
              f"  gap {row['gap']!s}", flush=True)

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max())

    cases = [  # (label, B, H, W, dtype, poly_n, poly_sigma, winsize, gaussian)
        ("sweep", 6, 1024, 1280, torch.float64, 5, 1.2, 15, False),
        ("transport", 50, 256, 320, torch.float64, 5, 1.2, 15, False),
        ("chain", 1, 256, 320, torch.float32, 7, 1.5, 25, True),
        ("study_chain", 1, 512, 640, torch.float32, 7, 1.5, 25, True),
    ]
    for label, B, H, W, dtype, pn, ps, win, gauss in cases:
        shape = (B, H, W)
        f1 = torch.rand(shape, dtype=dtype, device=dev, generator=g)
        f2 = torch.roll(f1, (1, 2), (-2, -1)) + 0.01 * torch.rand(shape, dtype=dtype, device=dev, generator=g)
        item, px = f1.element_size(), B * H * W
        e1p, e2p = fw.poly_expansion_reference(f1, pn, ps), fw.poly_expansion_reference(f2, pn, ps)
        record(f"poly_expansion.{label}", shape, dtype, lambda: fw.poly_expansion(f1, pn, ps),
               lambda: fw.poly_expansion_reference(f1, pn, ps), 6 * item * px,
               lambda: gap(fw.poly_expansion(f1, pn, ps), e1p[:5]))
        flow = torch.randn((2,) + shape, dtype=dtype, device=dev, generator=g)
        record(f"warped_poly_expansion.{label}", shape, dtype, lambda: fw.warped_poly_expansion(f2, flow, pn, ps),
               lambda: fw.warped_poly_expansion_reference(f2, flow, pn, ps), 8 * item * px,
               lambda: gap(fw.warped_poly_expansion(f2, flow, pn, ps),
                           fw.warped_poly_expansion_reference(f2, flow, pn, ps)[:5]))
        record(f"flow_update.{label}", shape, dtype, lambda: fw.flow_update(e1p, e2p, flow, win, gauss),
               lambda: fw.flow_update_reference(e1p, e2p, flow, win, gauss), 14 * item * px,
               lambda: gap(fw.flow_update(e1p, e2p, flow, win, gauss),
                           fw.flow_update_reference(e1p, e2p, flow, win, gauss)))
        kw = dict(pyr_scale=0.5, levels=3, winsize=win, iterations=3, poly_n=pn, poly_sigma=ps, gaussian_win=gauss)
        if label.endswith("chain"):
            kw.update(levels=5, iterations=5, refine=1)

        def plain_flow():
            saved = fw.poly_expansion, fw.warped_poly_expansion, fw.flow_update, fw.window_blur
            fw.poly_expansion = lambda f, n, s: fw.poly_expansion_reference(f, n, s)[:5]
            fw.warped_poly_expansion = lambda f, fl, n, s: fw.warped_poly_expansion_reference(f, fl, n, s)[:5]
            fw.flow_update, fw.window_blur = fw.flow_update_reference, fw.window_blur_reference
            try:
                return torch.stack(fb.farneback_flow(f1, f2, **kw))
            finally:
                fw.poly_expansion, fw.warped_poly_expansion, fw.flow_update, fw.window_blur = saved

        want = plain_flow()
        record(f"farneback_flow.{label}", shape, dtype, lambda: fb.farneback_flow(f1, f2, **kw), plain_flow, 0,
               lambda: gap(torch.stack(fb.farneback_flow(f1, f2, **kw)), want))
        if dtype == torch.float32:  # the plain flow on the CPU: how far summation order alone moves it
            on_cpu = torch.stack(fb.farneback_flow(f1.cpu(), f2.cpu(), **kw))
            rows[-1]["plain_cpu_gap"] = gap(want.cpu(), on_cpu)
            print(f"{'':<34}the plain flow on the card against the plain flow on the CPU: gap "
                  f"{rows[-1]['plain_cpu_gap']}", flush=True)
        del e1p, e2p, flow, f1, f2, want
        torch.cuda.empty_cache()

    for label, shape, dtype in (("dis_smooth", (2, 1024, 1280), torch.float64),
                                ("chain_smooth", (2, 512, 640), torch.float32)):
        f = torch.randn(shape, dtype=dtype, device=dev, generator=g)
        want = fw.window_blur_reference(f, 11, 2.0, True)
        record(f"window_blur.{label}", shape, dtype, lambda: fw.window_blur(f, 11, 2.0, True),
               lambda: fw.window_blur_reference(f, 11, 2.0, True), 2 * f.element_size() * f.numel(),
               lambda: gap(fw.window_blur(f, 11, 2.0, True), want))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "at": time.strftime("%Y-%m-%dT%H:%M:%S"), "rows": rows}, indent=1))
    print(f"card: {card}; wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
