"""Faults planted under ``laser.improved_registration``'s timed path, to show
that ``correct`` catches them (``benchmark/faults.py``'s form and swap):

* ``frozen_state``: the DIS chain returns its input;
* ``half_chain``: the DIS chain runs the first half of its steps, the later
  frames left unregistered;
* ``unchained``: each DIS step warps onto the previous input frame, not onto
  the previous registered one;
* ``half_batch``: each quality sweep flows half of its pairs, the rest
  standing in for the others;
* ``altered_answer``: the fitted coefficient of largest size times 1.001;
* ``float32_dis``: the DIS flows in float32 on the float64 stack;
* ``swapped_selection``: the other method's stack is fitted.

Readings on the card, one JSON line a seed (``calibrate.py``'s):

    python3 benchmark/faults_registration_study.py --fault <name> --seeds 1,2 [--requests 1]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.faults import _swap  # noqa: E402

WORKLOAD = "laser.improved_registration"
IR = "pdx_torch.pipelines.improved_registration"


def _half_pairs(f, a, b, **k):
    n = a.shape[0]
    h = (n + 1) // 2
    fr, fc = f(a[:h], b[:h], **k)
    return torch.cat([fr, fr])[:n], torch.cat([fc, fc])[:n]


def _half_chain(f, U, **k):
    h = (U.shape[0] + 1) // 2
    return torch.cat([f(U[:h], **k), U[h:]])


def _unchained(f, U, **k):
    return torch.stack([U[0]] + [f(U[i - 1 : i + 1], **k)[1] for i in range(1, U.shape[0])])


def _scaled_largest(c: torch.Tensor) -> torch.Tensor:
    c = c.clone()
    c[torch.argmax(torch.abs(c))] *= 1.001
    return c


def _other_method(m_fb, m_dis, method):
    return m_fb, m_dis, "Farneback" if method == "DIS" else "DIS"


FAULTS = {
    WORKLOAD: {
        "frozen_state": (IR, "register_dis", lambda f: lambda cfg, U: U),
        "half_chain": (IR, "dis_register_sequence", lambda f: lambda U, **k: _half_chain(f, U, **k)),
        "unchained": (IR, "dis_register_sequence", lambda f: lambda U, **k: _unchained(f, U, **k)),
        "half_batch": ("pdx_torch.register.quality", "batched_pair_flows",
                       lambda f: lambda a, b, **k: _half_pairs(f, a, b, **k)),
        "altered_answer": (IR, "fit", lambda f: lambda cfg, X, y: _scaled_largest(f(cfg, X, y))),
        "float32_dis": (IR, "dis_flow",
                        lambda f: lambda a, b, **k: tuple(t.to(a.dtype) for t in f(a.float(), b.float(), **k))),
        "swapped_selection": (IR, "registration_quality", lambda f: lambda *a, **k: _other_method(*f(*a, **k))),
    },
}


def apply(workload: str, name: str):
    """Plant fault ``name`` of ``workload``; returns the undo."""
    module, attr, make = FAULTS[workload][name]
    return _swap(module, attr, make)


def main() -> int:
    from benchmark.calibrate import readings

    p = argparse.ArgumentParser(prog="benchmark/faults_registration_study.py")
    p.add_argument("--fault", required=True, choices=sorted(FAULTS[WORKLOAD]))
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=1)
    a = p.parse_args()
    undo = apply(WORKLOAD, a.fault)
    try:
        for row in readings(WORKLOAD, [int(s) for s in a.seeds.split(",")], a.requests, "program"):
            print(json.dumps(dict(row, mode=f"fault:{a.fault}")), flush=True)
    finally:
        undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
