"""Holdout splits, temporal and spatial (port of ``pdx/validate/holdout.py``).

Time split: the first ``train_frac`` of the frames, the fraction clipped to
[0.4, 0.9] (analyze_results.py:37,189-194). Spatial splits are boolean
column / row masks (:41,282-299), so everything downstream keeps static
shapes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def split_time(T: int, train_frac: float = 0.7) -> tuple[int, int]:
    """(n_train, n_test) frame counts; train = the first block."""
    train_frac = float(np.clip(train_frac, 0.4, 0.9))
    n_train = int(T * train_frac)
    return n_train, T - n_train


def split_space_left_right(W: int, train_frac: float = 0.7, device: str | torch.device = "cpu") -> tuple[Tensor, Tensor]:
    """Boolean (W,) column masks (train = the left block)."""
    n_train = int(W * float(train_frac))
    cols = torch.arange(W, device=device)
    return cols < n_train, cols >= n_train


def split_space_top_bottom(H: int, train_frac: float = 0.7, device: str | torch.device = "cpu") -> tuple[Tensor, Tensor]:
    """Boolean (H,) row masks (train = the top block)."""
    n_train = int(H * float(train_frac))
    rows = torch.arange(H, device=device)
    return rows < n_train, rows >= n_train


def random_row_split(n: int, train_frac: float, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Random row split (ks2d_stridge_benchmark.py:1639-1643), drawn on the
    host in the reference's order."""
    perm = rng.permutation(n)
    split = int(train_frac * n)
    return perm[:split], perm[split:]
