"""pdx_torch — the PyTorch / CUDA port of pdx for NVIDIA Hopper (H100).

The package mirrors ``pdx/`` module by module; ``pdx`` (JAX) stays the
reference that every ported function is tested against. Plain tensor code is
PyTorch; the kernels that ``pdx`` wrote in Pallas for the TPU are hand-written
CUDA C++ under ``pdx_torch/csrc/``, bound in ``pdx_torch/ops/kernels/``.

This package never imports jax (``pdx/__init__.py`` does, so nothing of
``pdx`` is imported either).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Sparse-regression recovery is precision-critical (counterpart of the
# ``jax_default_matmul_precision=highest`` pin in pdx/__init__.py): TF32
# keeps ~3 decimal digits and corrupts Gram-matrix coefficient recovery, so
# float32 matmuls and convolutions stay in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The given device, else the CUDA card. Never the CPU unless asked:
    a CUDA device (the default) with no card visible raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card visible; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev


def resolve_dtype(name: str) -> torch.dtype:
    """``"float32"`` / ``"float64"`` (the config spelling) -> torch dtype."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got '{name}'") from None
