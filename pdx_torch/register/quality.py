"""Registration quality (port of ``pdx/register/quality.py``).

Parity: compute_registration_metrics
(pde_discovery_improved_registration.py:148-171): the mean optical-flow
magnitude between consecutive frames before and after registration, and the
percent improvement. The flows of all consecutive pairs run as batched
pyramids (``register/farneback.batched_pair_flows``) in the stack's own
dtype, as in ``pdx``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.register.farneback import batched_pair_flows


def mean_flow_magnitude(U: Tensor, **flow_kwargs) -> Tensor:
    """Mean |flow| over all consecutive frame pairs of U (T, H, W).

    The reference's metric uses light Farnebäck parameters (pyr 0.5 /
    levels 3 / win 15 / iters 3 / poly 5 / sigma 1.2, box window);
    ``refine`` stays :func:`farneback_flow`'s default.
    """
    kwargs = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2, gaussian_win=False)
    kwargs.update(flow_kwargs)
    fx, fy = batched_pair_flows(U[:-1], U[1:], flow_static=kwargs)
    return torch.mean(torch.sqrt(fx**2 + fy**2))


def improvement(before: Tensor, after: Tensor) -> dict[str, Tensor]:
    """The reference metric from the two mean flow magnitudes."""
    return {
        "avg_flow_before": before,
        "avg_flow_after": after,
        "improvement_pct": (before - after) / (before + 1e-12) * 100.0,
    }


def registration_improvement(U_before: Tensor, U_after: Tensor, **flow_kwargs) -> dict[str, Tensor]:
    """(avg_before, avg_after, improvement %) — the reference metric."""
    return improvement(mean_flow_magnitude(U_before, **flow_kwargs), mean_flow_magnitude(U_after, **flow_kwargs))
