"""Carry the system's state across from ``pdx`` (numpy in, tensors out).

The system has no weights: its state is the frame stack, the regression
dataset and the Gram statistics, and for the real-image pipelines the raw,
preprocessed and registered stacks, the flows and the local-poly datasets.
These functions take what ``pdx`` returns, after ``np.asarray`` on each
array, and hand it to the port, so a test can feed the JAX package's own
trajectory, rows, statistics, registered stack or flows into ``pdx_torch``
and check each stage apart. Nothing here imports ``pdx``.
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


def dataset_from_numpy(
    names, X, y, device: str | torch.device = "cpu"
) -> tuple[list[str], torch.Tensor, torch.Tensor]:
    """A regression dataset (``pdx.pipelines.ks2d_bench.build_dataset``'s
    triple, or one half of a train/test split) -> (names, X, y) with the
    arrays as tensors (copied, dtype kept), so both packages regress the
    same rows."""
    return list(names), torch.tensor(np.asarray(X), device=device), torch.tensor(np.asarray(y), device=device)


def stack_from_numpy(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """A frame stack (raw uint16, preprocessed or registered) or a (P, n, 6)
    local-poly dataset -> a tensor (copied, dtype kept)."""
    return torch.tensor(np.asarray(a), device=device)


def flows_from_numpy(fx, fy, device: str | torch.device = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """A flow pair (fx, fy), as ``farneback_flow`` or ``batched_pair_flows``
    return it, -> two tensors (copied, dtype kept)."""
    return stack_from_numpy(fx, device), stack_from_numpy(fy, device)
