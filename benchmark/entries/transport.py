"""Entry ``transport``: transport-form PDE discovery on a laser-matter frame
stack, ``pdx_torch.pipelines.transport.run``, on the same pool of
writable stacks as ``patch_discovery``.

On the configuration's stacks the Lasso zeroes every term at every alpha
(each |b_j| < alpha), so the sweep's coefficients are 0 and its intercepts
the target's mean. The traced run's kept request therefore also holds what
the library is built from and what the sweep is given: the pair flows as
``build_transport_library`` receives them, and the centred Gram and b of
the library as ``lasso_fista`` receives it.
"""

from __future__ import annotations

import numpy as np

from benchmark.data.stack import stack_pool
from benchmark.entries.patch_discovery import _rel, metric_gap
from benchmark.reference import transport as ref


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from pdx_torch.pipelines.transport import TransportConfig

    pool = stack_pool(int(traffic["pool"]), config["frames"], config["height"], config["width"], seed=seed,
                      device=device, dynamics=config["dynamics"])
    settings = dict(config["transport"], alphas=tuple(config["transport"]["alphas"]))
    return {"config": config, "cfg": TransportConfig(**settings, write_artifacts=False), "pool": pool,
            "device": device}


def _stack(state: dict, i: int) -> np.ndarray:
    return state["pool"][i % len(state["pool"])]


def _summary(out: dict) -> dict:
    res = [out["results"][float(a)] for a in out["config"]["alphas"]]
    return {
        "coefs": np.array([r["coefficients"] for r in res], dtype=np.float64),
        "intercepts": np.array([r["intercept"] for r in res]),
        "fits": np.array([[r["r2"], r["mse"], r["mae"]] for r in res]),
        "mean_flow_speed": float(out["mean_flow_speed"]),
    }


def request(state: dict, i: int) -> dict:
    from pdx_torch.pipelines import transport

    return _summary(transport.run(state["cfg"], U_raw=_stack(state, i), device=state["device"]))


def _recorded(module, name: str, keep: dict, pick):
    """Put a recorder around ``module.name`` that keeps ``pick(args,
    kwargs)`` in ``keep``; returns the undo."""
    original = getattr(module, name)

    def recorder(*a, **k):
        keep.update(pick(a, k))
        return original(*a, **k)

    setattr(module, name, recorder)
    return lambda: setattr(module, name, original)


def _centred_gram(X, y, mask):
    """The sklearn-centred Gram and b of the rows ``mask`` keeps, as the
    reference forms them."""
    import torch

    m = torch.ones_like(y) if mask is None else mask
    n = torch.sum(m)
    Xc = (X - torch.sum(X * m[:, None], dim=0) / n) * m[:, None]
    yc = (y - torch.sum(y * m) / n) * m
    return (Xc.T @ Xc / n).cpu().numpy(), (Xc.T @ yc / n).cpu().numpy()


def traced_request(state: dict, i: int, span, keep: bool = False) -> dict:
    """``run`` with the port's stage timer; its stages become spans. With
    ``keep``, the pair flows and the library's centred Gram and b that this
    very run used are kept too."""
    from pdx_torch.pipelines import transport
    from pdx_torch.utils.profiling import StageTimer

    timer = StageTimer()
    kept: dict = {}
    undo = []
    if keep:
        undo.append(_recorded(transport, "build_transport_library", kept,
                              lambda a, k: {"u": a[1], "v": a[2]}))
        undo.append(_recorded(transport, "lasso_fista", kept,
                              lambda a, k: {"X": a[0], "y": a[1], "mask": k.get("row_mask")}))
    try:
        with span("request"):
            out = transport.run(state["cfg"], U_raw=_stack(state, i), timer=timer, device=state["device"])
    finally:
        for u in undo:
            u()
    for name, seconds in timer.stages.items():
        span.add(name, seconds)
    res = _summary(out)
    if keep:
        # a run that no longer reaches these calls leaves them missing: compare() reads that as a failure
        if "u" in kept:
            res["flow_u"], res["flow_v"] = kept["u"].cpu().numpy(), kept["v"].cpu().numpy()
        if "X" in kept:
            res["gram"], res["b"] = _centred_gram(kept["X"], kept["y"], kept["mask"])
        res["kept"] = True
    return res


def input_key(state: dict, i: int):
    return i % len(state["pool"])


def reference(state: dict, i: int, dtype) -> dict:
    dev = "cpu" if state["device"] == "cpu" else "cuda"
    return ref.run(_stack(state, i), state["config"]["transport"], dtype, dev)


def compare(got: dict, want: dict) -> dict:
    # the sweep's coefficients and intercepts against the largest of them:
    # where every term is zeroed, the intercepts carry the fit
    scale = max(float(np.max(np.abs(want["coefs"]))), float(np.max(np.abs(want["intercepts"]))))
    gap = max(float(np.max(np.abs(got["coefs"] - want["coefs"]))),
              float(np.max(np.abs(got["intercepts"] - want["intercepts"]))))
    out = {
        "flow_speed_gap": _rel(got["mean_flow_speed"], want["mean_flow_speed"]),
        "sweep_gap": gap / scale,
        "fit_gap": metric_gap(got["fits"], want["fits"], unitless=(0,)),  # (R^2, MSE, MAE)
    }
    if (got.get("kept") or "flow_u" in got) and "flow_u" in want:  # the traced run's kept request
        # each field against its own largest entry: a component swapped,
        # negated or frozen reads at its size
        out["flow_gap"] = max(_rel(got.get("flow_u"), want["flow_u"]), _rel(got.get("flow_v"), want["flow_v"]))
        out["gram_gap"] = _rel(got.get("gram"), want["gram"])
        out["b_gap"] = _rel(got.get("b"), want["b"])
    return out


def trace_context(state: dict) -> dict:
    return {}


def free(state: dict) -> None:
    pass
