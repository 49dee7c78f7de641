"""Faults planted under a cell's timed path, to show that ``correct``
catches them: each swaps one function of the port for a broken one and
returns the function that puts it back.

* ``frozen_state``: a step returns its state unchanged (the Euler step,
  the registration, the pair flows);
* ``half_batch``: half of a batch left out, the rest standing in for it
  (the patch fits, the frame pairs);
* ``altered_answer``: an answer altered where it is produced (a fitted
  coefficient or intercept, by one part in a thousand);
* ``swapped_flow``, ``negated_flow``: the pair flows' two components
  swapped, or the row component negated (the mean flow speed is blind to
  both);
* ``float32_fits``: the patch datasets and fits in float32 on a float64
  working stack.

``TRACED_ONLY`` names the faults that only a traced run's kept request
can see: on the configuration's stacks the Lasso zeroes every term, so
the flows reach an untraced run's answer through the mean speed alone.
"""

from __future__ import annotations

import importlib

import torch


def _swap(module: str, name: str, make):
    mod = importlib.import_module(module)
    original = getattr(mod, name)
    setattr(mod, name, make(original))
    return lambda: setattr(mod, name, original)


def _scaled_last(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t[..., -1] *= 1.001
    return t


FAULTS = {
    "ks2d.gt_fullfield": {
        "frozen_state": ("pdx_torch.sim.ks2d", "ks_rhs", lambda f: lambda u, dx, dy: torch.zeros_like(u)),
        "altered_answer": ("pdx_torch.pipelines.ks2d_bench", "stridge_grid",
                           lambda f: lambda *a, **k: (lambda c, m: (_scaled_last(c), m))(*f(*a, **k))),
    },
    "laser.patch_discover": {
        "frozen_state": ("pdx_torch.pipelines.patch_discovery", "register_sequence_dispatch",
                         lambda f: lambda U, **k: U),
        "half_batch": ("pdx_torch.pipelines.patch_discovery", "all_patch_fits",
                       lambda f: lambda d_tr, d_te, **k: _half_fits(f, d_tr, d_te, **k)),
        "altered_answer": ("pdx_torch.pipelines.patch_discovery", "stridge_from_stats",
                           lambda f: lambda *a, **k: _scaled_result(f(*a, **k))),
        "float32_fits": ("pdx_torch.pipelines.patch_discovery", "working_stack",
                         lambda f: lambda cfg, U: f(cfg, U).float()),
    },
    "laser.transport": {
        "frozen_state": ("pdx_torch.pipelines.transport", "_pair_flows",
                         lambda f: lambda cfg, imgs: (lambda u, v: (torch.zeros_like(u), torch.zeros_like(v)))(
                             *f(cfg, imgs))),
        "half_batch": ("pdx_torch.pipelines.transport", "farneback_flow_pairs",
                       lambda f: lambda U, **k: _half_pairs(f, U, **k)),
        "altered_answer": ("pdx_torch.pipelines.transport", "lasso_fista",
                           lambda f: lambda *a, **k: (lambda w, b, n, s: (w, b * 1.001, n, s))(*f(*a, **k))),
        "swapped_flow": ("pdx_torch.pipelines.transport", "_pair_flows",
                         lambda f: lambda cfg, imgs: tuple(reversed(f(cfg, imgs)))),
        "negated_flow": ("pdx_torch.pipelines.transport", "_pair_flows",
                         lambda f: lambda cfg, imgs: (lambda u, v: (u, -v))(*f(cfg, imgs))),
    },
}
TRACED_ONLY = {("laser.transport", "swapped_flow"), ("laser.transport", "negated_flow")}


def _half_fits(f, d_tr, d_te, **k):
    P = d_tr.shape[0]
    h = (P + 1) // 2
    c, m_tr, m_te = f(d_tr[:h], d_te[:h], **k)
    rep = lambda t: torch.cat([t, t])[:P]  # noqa: E731
    return rep(c), {n: rep(v) for n, v in m_tr.items()}, {n: rep(v) for n, v in m_te.items()}


def _half_pairs(f, U, **k):
    n = U.shape[0] - 1
    h = (n + 1) // 2
    fr, fc = f(U[: h + 1], **k)
    return torch.cat([fr, fr])[:n], torch.cat([fc, fc])[:n]


def _scaled_result(res):
    res.coeffs = _scaled_last(res.coeffs)
    return res


def apply(workload: str, name: str):
    """Plant fault ``name`` of ``workload``; returns the undo."""
    module, attr, make = FAULTS[workload][name]
    return _swap(module, attr, make)
