"""Moving-average denoisers (port of ``pdx/ops/filters.py:28-59``).

``time_smooth_moving_average`` smooths along axis 0 with reflect padding;
``smooth_1d`` along the trailing axis with edge padding. Both sum a window
as a difference of cumulative sums, as ``pdx`` does. The Gaussian, median,
TV and Savitzky-Golay filters of that module come with later slices.
"""

from __future__ import annotations

import torch
from torch import Tensor


def time_smooth_moving_average(U: Tensor, window: int) -> Tensor:
    """Centred moving average along axis 0 with reflect padding (numpy's
    ``mode="reflect"``: the edge frame is not repeated). Odd windows only."""
    window = int(window)
    if window <= 1:
        return U
    if window % 2 == 0:
        raise ValueError("temporal moving-average window must be an odd integer")
    pad = window // 2
    T = U.shape[0]
    # reflected frame index, period 2(T-1): ... 2 1 | 0 1 ... T-1 | T-2 ...
    idx = torch.arange(-pad, T + pad, device=U.device)
    if T > 1:
        idx = torch.remainder(idx, 2 * (T - 1))
        idx = torch.where(idx >= T, 2 * (T - 1) - idx, idx)
    else:
        idx = torch.zeros_like(idx)
    U_pad = U[idx]
    cs = torch.cat([torch.zeros_like(U_pad[:1]), torch.cumsum(U_pad, dim=0)], dim=0)
    return (cs[window:] - cs[:-window]) / float(window)


def smooth_1d(x: Tensor, window: int) -> Tensor:
    """Centred moving average on the trailing axis with edge padding; an
    even window is bumped to the next odd one."""
    w = int(window)
    if w <= 1:
        return x
    if w % 2 == 0:
        w += 1
    pad = w // 2
    n = x.shape[-1]
    idx = torch.clamp(torch.arange(-pad, n + pad, device=x.device), 0, n - 1)
    xp = x[..., idx]
    cs = torch.cat([torch.zeros_like(xp[..., :1]), torch.cumsum(xp, dim=-1)], dim=-1)
    return (cs[..., w:] - cs[..., :-w]) / float(w)
