"""The preprocessing head of the real-image pipelines (port of
``pdx/preprocess.py:30-50``)."""

from __future__ import annotations

from torch import Tensor

from pdx_torch import resolve_dtype
from pdx_torch.ops.filters import gaussian_filter_reflect
from pdx_torch.ops.interp import resize_area


def resize_denoise_normalize(
    U_raw: Tensor, *, out_h: int, out_w: int, sigma: float, eps: float = 0.0,
    dtype_name: str = "float64",
) -> Tensor:
    """INTER_AREA downsample -> cast -> Gaussian denoise -> min-max normalise.

    The downsample runs at the input dtype before the cast, as in ``pdx``:
    for uint8 / uint16 frames the 2x block mean is exact in float32 (sums of
    at most four integers are representable), so the result equals the
    cast-first order while the first pass reads the raw bytes.
    """
    U = resize_area(U_raw, out_h, out_w).to(resolve_dtype(dtype_name))
    U = gaussian_filter_reflect(U, sigma)
    return (U - U.min()) / (U.max() - U.min() + eps)
