"""Carry the system's state across from ``pdx`` (numpy in, tensors out).

The system has no weights: its state is the frame stack and the Gram
statistics. These functions take what ``pdx`` returns, after ``np.asarray``
on each array, and hand it to the port, so a test can feed the JAX
package's own trajectory or statistics into ``pdx_torch`` and check the
simulation and the regression apart. Nothing here imports ``pdx``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from pdx_torch.sim.ks2d import Ks2dConfig

_FRAME_KEYS = ("U_clean", "U", "U_for_ut", "U_for_features")


def frames_from_numpy(d: dict[str, Any], device: str | torch.device = "cpu") -> dict[str, Any]:
    """``pdx.pipelines.ks2d_bench.prepare_frames``'s dict -> the port's frames
    dict: frame stacks as tensors (copied, dtype kept), dx/dy/DT as floats, ``sim``
    as the port's :class:`Ks2dConfig`."""
    out: dict[str, Any] = {
        k: torch.tensor(np.asarray(d[k]), device=device) for k in _FRAME_KEYS
    }
    out.update({k: float(d[k]) for k in ("dx", "dy", "DT")})
    out["sim"] = Ks2dConfig(**dataclasses.asdict(d["sim"]))
    return out


def stats_from_numpy(d: dict[str, Any], device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """A ``gram_stats`` dict {G, b, sx, n, syy, sy} of arrays -> tensors."""
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in d.items()}
