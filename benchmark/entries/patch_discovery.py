"""Entry ``patch_discovery``: patch-based PDE discovery on a laser-matter
frame stack, ``pdx_torch.pipelines.patch_discovery.run``.

Requests take the stacks of a pool made from the seed in turn. The stacks
are writable host arrays, so every request ships its stack to the card, as
a loader's array would be shipped.
"""

from __future__ import annotations

import numpy as np

from benchmark.data.stack import stack_pool
from benchmark.reference import patch as ref

METRIC_KEYS = ("rmse", "r2", "nrmse", "mae", "corr")
UNITLESS = (1, 4)  # R^2 and the correlation, compared as they are


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from pdx_torch.pipelines.patch_discovery import PatchDiscoveryConfig

    pool = stack_pool(int(traffic["pool"]), config["frames"], config["height"], config["width"], seed=seed,
                      device=device, dynamics=config["dynamics"])
    cfg = PatchDiscoveryConfig(**config["patch_discovery"], write_artifacts=False)
    return {"config": config, "cfg": cfg, "pool": pool, "device": device}


def _stack(state: dict, i: int) -> np.ndarray:
    return state["pool"][i % len(state["pool"])]


def _summary(out: dict) -> dict:
    m = out["global_test_metrics"]
    return {
        "agg": np.asarray(out["stats"]["coeffs"], dtype=np.float64),
        "keep": np.asarray(out["stats"]["keep"], dtype=bool),
        "patch_coeffs": np.asarray(out["patch_coeffs"], dtype=np.float64),
        "patch_metrics": np.array([[[r[k] for k in METRIC_KEYS] for r in out[f"patch_{s}_metrics"]]
                                   for s in ("train", "test")]),
        "held": np.array([m[k] for k in METRIC_KEYS] + [m["resid_med_abs"], out["one_step_rmse"]]),
    }


def request(state: dict, i: int) -> dict:
    from pdx_torch.pipelines import patch_discovery

    return _summary(patch_discovery.run(state["cfg"], U_raw=_stack(state, i), device=state["device"]))


def traced_request(state: dict, i: int, span, keep: bool = False) -> dict:
    """``run`` in its three public stages."""
    import torch

    from pdx_torch.pipelines import patch_discovery as pd

    cfg = state["cfg"]
    with span("preprocess"):
        head = pd.preprocess_head(cfg, _stack(state, i), torch.device(state["device"]))
    with span("register"):
        reg = pd.register(cfg, head)
    with span("discover"):
        out = _summary(pd.discover(cfg, reg))
    if keep:
        out["head"], out["registered"] = head.cpu().numpy(), reg.cpu().numpy()
    return out


def input_key(state: dict, i: int):
    return i % len(state["pool"])


def fixed(state: dict, want: dict, dtype=None) -> dict:
    """``discover`` on the reference's own registered stack: the program's
    (``dtype`` None) or the reference's in ``dtype``. Compared with the
    reference's result on that stack, it holds the local-poly datasets,
    the patch fits and the held-out evaluation free of the chain's float32
    flow."""
    import torch

    if dtype is None:
        from pdx_torch.pipelines import patch_discovery as pd

        reg = torch.as_tensor(want["registered"], device=state["device"])
        return _summary(pd.discover(state["cfg"], reg))
    reg = torch.as_tensor(want["registered"], device=state["device"]).to(dtype)
    cfg = state["config"]["patch_discovery"]
    out = ref.discover(ref.working(reg, cfg).cpu().numpy(), cfg)
    return {k: out[k] for k in ("agg", "keep", "patch_coeffs", "patch_metrics", "held")}


def reference(state: dict, i: int, dtype) -> dict:
    dev = "cpu" if state["device"] == "cpu" else "cuda"
    out = ref.run(_stack(state, i), state["config"]["patch_discovery"], dtype, dev)
    return {"agg": out["agg"], "keep": out["keep"], "patch_coeffs": out["patch_coeffs"],
            "patch_metrics": out["patch_metrics"], "held": out["held"],
            "head": out["head"].cpu().numpy(), "registered": out["registered"].cpu().numpy()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = float(np.max(np.abs(want)))
    gap = float(np.max(np.abs(got - want)))
    return gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf"))


def metric_gap(got, want, unitless=()) -> float:
    """Worst gap of each metric (the last axis) against its own size; the
    unitless ones (R^2, a correlation), which may be 0, against their size
    or 1, whichever is larger."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    floor = np.zeros(want.shape[-1])
    floor[list(unitless)] = 1.0
    return float(np.max(np.abs(got - want) / (np.maximum(np.abs(want), floor) + 1e-300)))


def _gaps(got: dict, want: dict) -> dict:
    return {
        # the aggregate against the patch coefficients' size: each term is
        # a median of them, so it moves no more than they do, and a term
        # kept by one side alone shows at its size
        "agg_gap": float(np.max(np.abs(got["agg"] - want["agg"]))) / float(np.max(np.abs(want["patch_coeffs"]))),
        "patch_coef_gap": _rel(got["patch_coeffs"], want["patch_coeffs"]),
        "patch_metric_gap": metric_gap(got["patch_metrics"], want["patch_metrics"], UNITLESS),
        "held_gap": metric_gap(got["held"], want["held"], UNITLESS),
    }


def compare(got: dict, want: dict) -> dict:
    out = _gaps(got, want)
    if "fixed" in got:  # the fits on the reference's registered stack
        out.update({f"fixed_{k}": v for k, v in _gaps(got["fixed"], want).items()})
    for k in ("head", "registered"):  # the traced run's first request
        if k in got and k in want:
            out[f"{k}_gap"] = _rel(got[k], want[k])
    return out


def trace_context(state: dict) -> dict:
    return {"flows_per_request": int(state["config"]["frames"]) - 1}


def free(state: dict) -> None:
    pass  # no device state outlives a run
