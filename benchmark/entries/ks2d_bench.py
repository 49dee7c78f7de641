"""Entry ``ks2d_bench``: the KS-2D ground-truth benchmark,
``pdx_torch.pipelines.ks2d_bench.run``, as the CLI's
``ks2d-bench --grid-search --solver pallas`` calls it.

The entry takes no seed for the initial condition (the upstream's fixed
seed, stated in the configuration as ``ic_seed``), so every request is the
same computation; the reference recomputes it from the same seed.
"""

from __future__ import annotations

import numpy as np

from benchmark import stats
from benchmark.reference import ks2d as ref


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from pdx_torch.pipelines.ks2d_bench import Ks2dBenchConfig

    cfg = Ks2dBenchConfig(**config["pipeline"])
    sim_keys = ("Nx", "Ny", "dt", "n_seconds")
    if any(config[k] != getattr(cfg, k) for k in sim_keys):
        raise ValueError("the configuration's sizes and the pipeline's disagree")
    return {"config": config, "cfg": cfg, "device": device, "frames": None}


def _summary(res: dict) -> dict:
    fit, roll = res["fit"], res["rollout"]
    return {"coeffs": np.asarray(res["coeffs"], dtype=np.float64), "r2": float(fit["test_r2"]),
            "rmse": float(fit["test_rmse"]), "n_active": int(fit["n_active"]),
            "rollout": np.array([roll["first"], roll["last"], roll["mean"]], dtype=np.float64)}


def request(state: dict, i: int) -> dict:
    from pdx_torch.pipelines import ks2d_bench

    return _summary(ks2d_bench.run(state["cfg"], state["device"]))


def traced_request(state: dict, i: int, span, keep: bool = False) -> dict:
    """``run`` in its two public stages: the frames, then the grid on them."""
    from pdx_torch.pipelines import ks2d_bench

    cfg = state["cfg"]
    with span("sim"):
        fr = ks2d_bench.prepare_frames(cfg, state["device"])
    with span("fit"):
        res = ks2d_bench._run_fast_pointwise_grid(cfg, fr, np.random.default_rng(0))
    out = _summary(res)
    state["frames"] = fr
    if keep:
        out["field"] = fr["U"].cpu().numpy()
        out["field_rms"] = float(np.sqrt(np.mean(out["field"] ** 2)))
        out["stats"] = _program_stats(fr)
    return out


def _gram_args(fr: dict) -> tuple:
    from pdx_torch.library.pointwise import forward_difference_ut

    U = fr["U_for_features"]
    Ut = forward_difference_ut(fr["U_for_ut"], fr["DT"])
    return U[:-1], Ut, float(fr["dx"]), float(fr["dy"])


def _program_stats(fr: dict) -> dict:
    """The statistics of the public kernel call the grid makes, on the
    frames of this request."""
    from pdx_torch.ops.kernels.fused_gram import fused_ks_gram

    U, Ut, dx, dy = _gram_args(fr)
    s = fused_ks_gram(U, Ut, dx=dx, dy=dy)
    return {"G": s["G"].cpu().numpy(), "b": s["b"].cpu().numpy(), "sx": s["sx"].cpu().numpy(),
            "sy": float(s["sy"]), "syy": float(s["syy"]), "n": float(s["n"])}


def input_key(state: dict, i: int):
    return 0


def reference(state: dict, i: int, dtype) -> dict:
    dev = "cpu" if state["device"] == "cpu" else "cuda"
    out = ref.run(state["config"], dtype, dev)
    out["field"] = out["field"].cpu().numpy()
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = float(np.max(np.abs(want)))
    gap = float(np.max(np.abs(got - want)))
    return gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf"))


def _stats_gap(got: dict, want: dict) -> float:
    """Worst entry of the statistics, each against its own Cauchy-Schwarz
    scale: sqrt(G_ii G_jj), sqrt(G_ii syy), sqrt(G_ii n), sqrt(n syy)."""
    d = np.abs(np.diag(want["G"]))
    n, syy = abs(want["n"]), abs(want["syy"])
    pairs = [(got["G"], want["G"], np.sqrt(np.outer(d, d))), (got["b"], want["b"], np.sqrt(d * syy)),
             (got["sx"], want["sx"], np.sqrt(d * n)), (got["sy"], want["sy"], np.sqrt(n * syy)),
             (got["syy"], want["syy"], syy), (got["n"], want["n"], n)]
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / s)) for a, b, s in pairs)


def compare(got: dict, want: dict) -> dict:
    """The numbers that decide ``correct``; ``field`` and ``stats`` only
    where the traced run kept them."""
    out = {
        "coef_gap": _rel(got["coeffs"], want["coeffs"]),
        "r2_gap": abs(got["r2"] - want["r2"]),
        # the rollout errors against the field's own size
        "rollout_gap": float(np.max(np.abs(got["rollout"] - want["rollout"])))
        / want.get("field_rms", got.get("field_rms", 1.0)),
    }
    if "field" in got and "field" in want:
        out["field_gap"] = _rel(got["field"], want["field"])
    if "stats" in got and "stats" in want:
        out["gram_gap"] = _stats_gap(got["stats"], want["stats"])
    return out


def trace_context(state: dict) -> dict:
    fr = state["frames"]
    args = _gram_args(fr)
    U = fr["U_for_features"]
    from pdx_torch.ops.kernels.fused_gram import fused_ks_gram

    return {
        "steps_per_request": int(round(state["cfg"].n_seconds / state["cfg"].dt)),
        "gram_call": lambda: fused_ks_gram(args[0], args[1], dx=args[2], dy=args[3]),
        "gram_count": stats.ks_gram_count(*U.shape, itemsize=U.element_size()),
    }


def free(state: dict) -> None:
    state["frames"] = None

