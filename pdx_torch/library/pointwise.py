"""Pointwise dataset builder (port of ``pdx/library/pointwise.py``).

Flat indices are drawn on the host with numpy (``rng.choice``, the
reference's draw order), so both packages fit the same rows; the gather runs
on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def forward_difference_ut(U: Tensor, DT: float) -> Tensor:
    """(U[1:] - U[:-1]) / DT — Euler-consistent temporal derivative."""
    return (U[1:] - U[:-1]) / DT


def sample_flat_indices(n_total: int, n_sample: int, rng: np.random.Generator) -> np.ndarray:
    """Host-side no-replacement flat-index sample (reference: rng.choice)."""
    n_sample = int(min(n_sample, n_total))
    return rng.choice(n_total, size=n_sample, replace=False)


def build_pointwise_dataset(
    Ut: Tensor, terms: Tensor, flat_idx: np.ndarray | Tensor
) -> tuple[Tensor, Tensor]:
    """Gather sampled rows: X[(n, p)], y[(n,)] from ``terms`` (p, T, H, W)
    aligned with ``Ut`` (T, H, W)."""
    idx = torch.as_tensor(flat_idx, device=Ut.device)
    y = Ut.reshape(-1)[idx]
    p = terms.shape[0]
    X = terms.reshape(p, -1)[:, idx].T
    return X, y
