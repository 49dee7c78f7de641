"""The cells at sizes a CPU test run holds, and a helper that drives one
run of the harness on the CPU and returns its result line."""

from __future__ import annotations

import io
import json

from benchmark import harness

KS = {"Nx": 32, "Ny": 32, "n_seconds": 0.2,
      "pipeline": {"Nx": 32, "Ny": 32, "dt": 0.001, "n_seconds": 0.2, "method": "pointwise", "dictionary": "true",
                   "derivatives": "finite", "grid_search": True, "solver": "pallas", "rollout_steps": 50,
                   "dtype": "float64"}}
_PATCH = {"max_images": 12, "seed": 0, "registration": True, "register_mode": "auto", "register_refine": 1,
          "rt": 2, "rs": 3, "deg": 3, "patch": 11, "overlap": 5, "samples_per_patch": 120, "train_frac": 0.7,
          "alpha": 0.01, "threshold": 1e-05, "stability_freq": 0.6, "model": "full", "downsample": 2,
          "denoise_sigma1": 1.0, "denoise_sigma2": 1.2, "skip": 4, "subsample": 2, "dx": 0.1, "dy": 0.1, "dt": 1.0,
          "dtype": "float64"}
LASER = {"frames": 12, "height": 128, "width": 160, "patch_discovery": _PATCH}
SMALL = {"ks2d.gt_fullfield": KS, "laser.patch_discover": LASER, "laser.transport": LASER}


def run_cell(workload: str, *, seed: int = 3_000_000_019, seconds: float = 0.5, trace: int = 0) -> dict:
    """One run of ``workload`` on the CPU at its small size: the result."""
    out = io.StringIO()
    rc = harness.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                     device="cpu", config_override=SMALL[workload], stream=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
