"""Time the DIS flow's per-level kernels (``ops/kernels/dis_patches``) on
the card at the registration study's shapes, beside their plain versions
and their byte bound, and check each against its plain version.

    python tools/dis_patches_bench.py [--out outputs/dis_patches_bench.json]

Shapes: the study's four pyramid levels (float64 1024x1280 down to
128x160; 8-pixel patches at stride 4, 8 iterations) and the finest in
float32; then the whole flow and one chain step (flow, smoothing, warp) at
1024x1280 float64, on the kernels and on the plain passes. Times are
CUDA-event medians of 20 calls after 3 warm ones (5 for the plain passes);
a step's wall is the host clock over 20 steps ended by a synchronize. A
level's bound is its six planes (ref, mov and the initial flow read, the
flow written) once at 3.35 TB/s. A gap is the largest difference of the
densified flow from the plain one on the card, over the plain flow's
largest magnitude.
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
LEVELS = [(1024, 1280), (512, 640), (256, 320), (128, 160)]


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


def _frames(H, W, dtype, dev, seed=0):
    """A smooth textured frame in [0, 1], the frame moved by a sub-pixel
    drift and a sine warp, and a smooth initial flow of up to ~1 pixel."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    k = rng.uniform(0.03, 0.12, size=(4, 2))
    p = rng.uniform(0, 2 * np.pi, size=4)

    def img(yy, xx):
        return sum(np.sin(k[i, 0] * yy + k[i, 1] * xx + p[i]) for i in range(4)) / 8 + 0.5

    a, b = img(y, x), img(y - 1.3 - 0.5 * np.sin(x / 37), x + 0.7)
    flow = np.stack([np.sin(x / 53 + 1) * np.cos(y / 41), 0.8 * np.cos(x / 29) * np.sin(y / 61 + 2)])
    t = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    return t(a), t(b), t(flow[0]), t(flow[1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="outputs/dis_patches_bench.json")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dis_patches_bench.py: no CUDA card visible")
    from pdx_torch.ops.kernels import dis_patches as dp
    from pdx_torch.pipelines import improved_registration as ir
    from pdx_torch.register import dis as rdis

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rows = []

    def gap(got, want):
        return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))

    for (H, W), dtype in [(s, torch.float64) for s in LEVELS] + [(LEVELS[0], torch.float32)]:
        ref, mov, fx, fy = _frames(H, W, dtype, dev)
        vals = dp.dis_inverse_search(ref, mov, fx, fy, 8, 4, 8)
        plain_vals = dp.inverse_search_reference(ref, mov, fx, fy, 8, 4, 8)
        row = {
            "shape": [H, W], "dtype": str(dtype).replace("torch.", ""),
            "search_ms": _median_ms(lambda: dp.dis_inverse_search(ref, mov, fx, fy, 8, 4, 8)),
            "densify_ms": _median_ms(lambda: dp.dis_densify(vals, fx, fy, 8, 4)),
            "plain_search_ms": _median_ms(lambda: dp.inverse_search_reference(ref, mov, fx, fy, 8, 4, 8), reps=5),
            "plain_densify_ms": _median_ms(lambda: dp.densify_reference(plain_vals, fx, fy, 8, 4), reps=5),
            "bound_ms": 6 * H * W * ref.element_size() / HBM * 1e3,
            "gap": gap(dp.dis_densify(vals, fx, fy, 8, 4), dp.densify_reference(plain_vals, fx, fy, 8, 4)),
        }
        row["level_ms"] = row["search_ms"] + row["densify_ms"]
        row["bound_share"] = row["bound_ms"] / row["level_ms"]
        rows.append(row)
        print(f"level {H}x{W} {row['dtype']}: search {row['search_ms']:.4f} ms, densify {row['densify_ms']:.4f} ms "
              f"(plain {row['plain_search_ms']:.4f}, {row['plain_densify_ms']:.4f}); bound {row['bound_ms']:.4f} ms "
              f"({100 * row['bound_share']:.2f}%); gap {row['gap']:.3e}", flush=True)

    ref, mov, _, _ = _frames(1024, 1280, torch.float64, dev, seed=1)
    flows = {"kernels": rdis.dis_flow(ref, mov)}
    whole = {"flow_ms": _median_ms(lambda: rdis.dis_flow(ref, mov)),
             "step_ms": _median_ms(lambda: ir._dis_step(ref, mov, 1.0))}

    def step_wall(n=20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ir._dis_step(ref, mov, 1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    step_wall(3)
    whole["step_wall_ms"] = step_wall()
    try:  # the plain passes on the card
        rdis.dis_inverse_search, rdis.dis_densify = dp.inverse_search_reference, dp.densify_reference
        flows["plain"] = rdis.dis_flow(ref, mov)
        whole["plain_flow_ms"] = _median_ms(lambda: rdis.dis_flow(ref, mov), reps=5)
        whole["plain_step_ms"] = _median_ms(lambda: ir._dis_step(ref, mov, 1.0), reps=5)
        step_wall(3)
        whole["plain_step_wall_ms"] = step_wall()
    finally:
        rdis.dis_inverse_search, rdis.dis_densify = dp.dis_inverse_search, dp.dis_densify
    whole["flow_gap"] = gap(flows["kernels"], flows["plain"])
    whole["flow_bound_ms"] = sum(r["bound_ms"] for r in rows if r["dtype"] == "float64")
    print(json.dumps(whole), flush=True)

    out = {"card": card, "levels": rows, "whole": whole}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
