"""Regression metrics (port of ``pdx/ops/metrics.py:14-23``)."""

from __future__ import annotations

import torch
from torch import Tensor


def rmse(y_true: Tensor, y_pred: Tensor) -> Tensor:
    return torch.sqrt(torch.mean((y_true - y_pred) ** 2))


def r2_score(y_true: Tensor, y_pred: Tensor) -> Tensor:
    """R^2 with the reference's +1e-18 total-sum-of-squares guard."""
    ss_res = torch.sum((y_true - y_pred) ** 2)
    ss_tot = torch.sum((y_true - torch.mean(y_true)) ** 2)
    return 1.0 - ss_res / (ss_tot + 1e-18)
