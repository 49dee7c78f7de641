"""Run KS-2D benchmark configurations through pdx (JAX) and pdx_torch, both on
the CPU, and print each fit and how far the two implementations part.

    python tools/torch_vs_pdx_ks2d.py [--config NAME ...]

The configurations run at the benchmark's full default size (100x100, 2000
Euler steps, float64). The named
configurations all use the grid search, the pallas solver and the blockwise
method; they take one stage of the perturbed chip-smoke configuration away
at a time, so that the stage that costs recovery can be named:

* ``perturbed``: N5 jitter (shift_max 1 px) + 3% noise, stabilised,
  denoised (time window 3, spatial sigma 1), rich library;
* ``perturbed_true``: the same with the true library [lap, bih, gradsq];
* ``perturbed_no_denoise``: without the two denoisers;
* ``noise_rich``: 3% noise (N2) alone, rich library, no stabilisation or
  denoising;
* ``noise_true``: the same with the true library;
* ``shifts_rich``: N1 jitter alone, stabilised, rich library;
* ``shifts_true``: the same with the true library;
* ``shifts_rich_unstabilised``: N1 jitter alone, not stabilised.

One JSON line per run (configuration, implementation, seconds, names,
coefficients, worst ground-truth error in %), then one line per
configuration run by both with the largest coefficient difference relative
to max|coef|. A configuration that stabilises also gets a line comparing the two implementations' phase-correlation shifts
(frame 0 against every other frame, the ``to_first`` estimate) on the
perturbed frames before stabilisation.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PERTURBED = dict(
    perturbation="N5_shifts_noise", shift_mode="jitter", shift_max=1.0, stabilize_shifts=True,
    denoise_time_window=3, denoise_space_sigma=1.0, dictionary="rich",
)
SHIFTS = dict(perturbation="N1_shifts", shift_mode="jitter", shift_max=1.0, stabilize_shifts=True, dictionary="rich")
CONFIGS = {
    "perturbed": PERTURBED,
    "perturbed_true": {**PERTURBED, "dictionary": "true"},
    "perturbed_no_denoise": {**PERTURBED, "denoise_time_window": 0, "denoise_space_sigma": 0.0},
    "noise_rich": dict(perturbation="N2_noise", dictionary="rich"),
    "noise_true": dict(perturbation="N2_noise", dictionary="true"),
    "shifts_rich": SHIFTS,
    "shifts_true": {**SHIFTS, "dictionary": "true"},
    "shifts_rich_unstabilised": {**SHIFTS, "stabilize_shifts": False},
}


def _jax_cpu_x64() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # float64 as the port, as the tests run pdx


def _run_pdx(kw: dict) -> dict:
    _jax_cpu_x64()
    from pdx.pipelines.ks2d_bench import Ks2dBenchConfig, run

    return run(Ks2dBenchConfig(**kw))


def _run_torch(kw: dict) -> dict:
    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig, run

    return run(Ks2dBenchConfig(**kw), "cpu")


def _shift_parity(kw: dict) -> dict:
    """Both implementations' to_first phase-correlation shifts on the same
    perturbed, not yet stabilised frames."""
    _jax_cpu_x64()
    import jax.numpy as jnp

    import pdx.pipelines.ks2d_bench as J
    import pdx_torch.pipelines.ks2d_bench as T
    from pdx.register.phasecorr import phase_correlate as pc_pdx
    from pdx_torch.register.phasecorr import phase_correlate as pc_torch

    kw = {**kw, "stabilize_shifts": False}
    U_pdx = np.asarray(J.prepare_frames(J.Ks2dBenchConfig(**kw))["U"])
    U_torch = T.prepare_frames(T.Ks2dBenchConfig(**kw), "cpu")["U"]
    U0 = jnp.asarray(U_pdx)
    dr_j, dc_j = (np.asarray(a) for a in pc_pdx(jnp.broadcast_to(U0[0], U0[1:].shape), U0[1:]))
    dr_t, dc_t = (a.numpy() for a in pc_torch(U_torch[0], U_torch[1:]))
    d = np.maximum(np.abs(dr_j - dr_t), np.abs(dc_j - dc_t))
    return {
        "input_diff_max": float(np.abs(U_pdx - U_torch.numpy()).max()), "frames": int(d.size),
        "shift_diff_max_px": float(d.max()), "frames_over_0.1px": int((d > 0.1).sum()),
        "frames_over_1e-6px": int((d > 1e-6).sum()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append", choices=sorted(CONFIGS), help="default: perturbed")
    args = ap.parse_args()
    base = dict(grid_search=True, solver="pallas", method="blockwise")
    impls = {"pdx": _run_pdx, "torch": _run_torch}
    for name in args.config or ["perturbed"]:
        coeffs = {}
        for impl, fn in impls.items():
            t0 = time.perf_counter()
            res = fn({**base, **CONFIGS[name]})
            secs = time.perf_counter() - t0
            coeffs[impl] = np.asarray(res["coeffs"], dtype=np.float64)
            worst = max(v["rel_err_pct"] for v in res["gt_errors"].values())
            print(json.dumps({
                "config": name, "impl": impl, "seconds": secs, "names": list(res["names"]),
                "coeffs": coeffs[impl].tolist(), "worst_gt_err_pct": float(worst),
                "gt_errors": {k: float(v["est"]) for k, v in res["gt_errors"].items()},
            }), flush=True)
        diff = np.abs(coeffs["pdx"] - coeffs["torch"]).max() / np.abs(coeffs["pdx"]).max()
        print(json.dumps({"config": name, "max_coef_diff_rel": float(diff)}), flush=True)
        if CONFIGS[name].get("stabilize_shifts"):
            print(json.dumps({"config": name, **_shift_parity({**base, **CONFIGS[name]})}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
