"""Entry ``improved_registration``: the registration study (Farnebäck against
DIS, then a 13-term fit on the better one),
``pdx_torch.pipelines.improved_registration.run``, on a pool of writable
stacks from the seed, used in turn, so every request ships its stack.

The traced run calls the study's public stages (``preprocess``,
``register_farneback``, ``register_dis``, ``registration_quality``,
``fit_registered``), and the fixed check the last four of them: a
program without them cannot run this cell, and its set-up exits at once.

The DIS chain is chaotic over the 50 steps of these stacks: a change of
1e-15 in the input moves the program's own last frames by ~0.1 (the chain
drives them far from the input), so the program's DIS stack is not held to
the reference's end to end. It is held to the reference's one-step map
instead: each frame of the chain the program made against the reference's
step from the program's previous frame, and the run's DIS quality against
the reference's sweeps of that same stack. The traced run's first request
keeps its stack; for any other run ``fixed`` makes the program's chain
again from the same input (the program is deterministic, so it is the
run's own, which ``dis_quality_gap`` shows).
"""

from __future__ import annotations

import numpy as np

from benchmark.data.stack import stack_pool
from benchmark.entries.patch_discovery import _rel
from benchmark.reference import registration_study as ref

QUALITY_KEYS = ("avg_flow_before", "avg_flow_after", "improvement_pct")


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from pdx_torch.pipelines import improved_registration as ir

    if not hasattr(ir, "fit_registered"):
        raise SystemExit("benchmark: this pdx_torch has no public stages of the registration study "
                         "(preprocess ... fit_registered), so it cannot run this cell")

    pool = stack_pool(int(traffic["pool"]), config["frames"], config["height"], config["width"], seed=seed,
                      device=device, dynamics=config["dynamics"])
    cfg = ir.ImprovedRegistrationConfig(**config["improved_registration"], write_artifacts=False)
    return {"config": config, "cfg": cfg, "pool": pool, "device": device}


def _stack(state: dict, i: int) -> np.ndarray:
    return state["pool"][i % len(state["pool"])]


def _summary(m_fb: dict, m_dis: dict, method: str, res: dict) -> dict:
    return {"fb": np.array([m_fb[k] for k in QUALITY_KEYS]), "dis": np.array([m_dis[k] for k in QUALITY_KEYS]),
            "method": method, "coefs": np.asarray(res["coeffs"], dtype=np.float64), "r2": float(res["r2"])}


def request(state: dict, i: int) -> dict:
    from pdx_torch.pipelines import improved_registration as ir

    out = ir.run(state["cfg"], U_raw=_stack(state, i), device=state["device"])
    return _summary(out["farneback_metrics"], out["dis_metrics"], out["selected_method"], out)


def traced_request(state: dict, i: int, span, keep: bool = False) -> dict:
    """``run`` in its public stages; with ``keep``, the preprocessed stack
    and both registered stacks too."""
    import torch

    from pdx_torch.pipelines import improved_registration as ir

    cfg = state["cfg"]
    with span("preprocess"):
        U = ir.preprocess(cfg, _stack(state, i), torch.device(state["device"]))
    with span("register"):
        U_fb = ir.register_farneback(cfg, U)
    with span("dis_chain"):
        U_dis = ir.register_dis(cfg, U)
    with span("quality"):
        m_fb, m_dis, method = ir.registration_quality(U, U_fb, U_dis)
    with span("fit"):
        res = ir.fit_registered(cfg, U_dis if method == "DIS" else U_fb)
    out = _summary(m_fb, m_dis, method, res)
    if keep:
        out.update(head=U.cpu().numpy(), fb_registered=U_fb.cpu().numpy(), dis_registered=U_dis.cpu().numpy())
    return out


def input_key(state: dict, i: int):
    return i % len(state["pool"])


def fixed(state: dict, want: dict, dtype=None) -> dict:
    """The later stages on the reference's own intermediates: the three
    quality sweeps and the selection on its preprocessed and registered
    stacks, and the fit on its selected stack; the program's (``dtype``
    None) or the reference's in ``dtype``. The program's also makes its own
    DIS chain from ``want``'s input again (``own_head``, ``own_dis``), for
    ``compare`` to hold step by step."""
    import torch

    head, fb, dis, reg = (torch.as_tensor(want[k], device=state["device"])
                          for k in ("head", "fb_registered", "dis_registered", "registered"))
    if dtype is not None:
        head, fb, dis, reg = (t.to(dtype) for t in (head, fb, dis, reg))
        q_fb, q_dis, method = ref.quality(head, fb, dis)
        return dict(ref.fit(reg, state["config"]["improved_registration"]), fb=q_fb, dis=q_dis, method=method)
    from pdx_torch.pipelines import improved_registration as ir

    cfg = state["cfg"]
    out = _summary(*ir.registration_quality(head, fb, dis), ir.fit_registered(cfg, reg))
    own = ir.preprocess(cfg, _stack(state, want["input"]), torch.device(state["device"]))
    out.update(own_head=own.cpu().numpy(), own_dis=ir.register_dis(cfg, own).cpu().numpy())
    return out


def reference(state: dict, i: int, dtype) -> dict:
    dev = "cpu" if state["device"] == "cpu" else "cuda"
    out = ref.run(_stack(state, i), state["config"]["improved_registration"], dtype, dev)
    out["input"] = input_key(state, i)
    for k in ("head", "fb_registered", "dis_registered"):
        out[k] = out[k].cpu().numpy()
    out["registered"] = out["dis_registered"] if out["method"] == "DIS" else out["fb_registered"]
    return out


def quality_gap(got, want) -> float:
    """The two mean flow magnitudes, each against its own size, and the
    improvement's gap in percentage points over 100 (a share of the whole)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    mags = np.abs(got[:2] - want[:2]) / np.maximum(np.abs(want[:2]), 1e-300)
    return float(max(np.max(mags), abs(got[2] - want[2]) / 100.0))


def _gaps(got: dict, want: dict) -> dict:
    """Against ``want``; not the DIS quality: the chaotic chain's is held on
    the run's own stack (``_own_chain_gaps``)."""
    return {
        "fb_quality_gap": quality_gap(got["fb"], want["fb"]),
        "method_gap": 0.0 if got["method"] == want["method"] else float("inf"),
        "coef_gap": _rel(got["coefs"], want["coefs"]),  # against the largest coefficient
        "r2_gap": abs(float(got["r2"]) - float(want["r2"])),
    }


def _own_chain(got: dict):
    """The preprocessed and DIS-registered stacks of the run ``got`` came
    from: kept by the traced run (or the control's own), else made again by
    ``fixed``; None if neither."""
    if "dis_registered" in got:
        return got["head"], got["dis_registered"]
    if "own_dis" in got.get("fixed", {}):
        return got["fixed"]["own_head"], got["fixed"]["own_dis"]
    return None


def _own_chain_gaps(dis_quality, head, dis) -> dict:
    """The reference's one-step map and sweeps on a chain's own frames, in
    float64: ``dis_step_gap``, every frame i >= 1 against the reference's
    step from frame i-1 onto head i (against the largest frame value), and
    ``dis_quality_gap``, ``dis_quality`` against the reference's sweeps of
    ``head`` and ``dis``."""
    import torch

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    h, d = (torch.as_tensor(np.asarray(a), device=dev).to(torch.float64) for a in (head, dis))
    steps = torch.stack([ref.dis_step(d[i - 1], h[i]) for i in range(1, d.shape[0])])
    before, after = ref.mean_flow(h), ref.mean_flow(d)
    q = [before, after, (before - after) / (before + 1e-12) * 100.0]
    return {"dis_step_gap": _rel(d[1:].cpu().numpy(), steps.cpu().numpy()),
            "dis_quality_gap": quality_gap(dis_quality, q)}


def compare(got: dict, want: dict) -> dict:
    out = _gaps(got, want)
    if "fixed" in got:  # the stages on the reference's intermediates
        out.update({f"fixed_{k}": v for k, v in _gaps(got["fixed"], want).items()})
    own = _own_chain(got)
    if own is not None and "head" in want:  # against the reference (the split compares two runs)
        out.update(_own_chain_gaps(got["dis"], *own))
    for k in ("head", "fb_registered"):  # the traced run's first request
        if k in got and k in want:
            out[f"{k}_gap"] = _rel(got[k], want[k])
    return out


def trace_context(state: dict) -> dict:
    return {"flows_per_request": int(state["config"]["frames"]) - 1}


def free(state: dict) -> None:
    pass  # no device state outlives a run
