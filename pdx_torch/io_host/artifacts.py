"""Result-artifact writers (port of ``pdx/io_host/artifacts.py:19-44,
149-160``): JSON summaries and the patch-discovery coefficient CSV."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _to_builtin(x):
    """numpy / torch scalars and arrays (flattened to lists of floats),
    dicts, lists and tuples -> JSON-serialisable Python values."""
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return [float(v) for v in x.ravel().tolist()]
    if isinstance(x, torch.Tensor):
        return x.item() if x.ndim == 0 else [float(v) for v in x.detach().cpu().reshape(-1).tolist()]
    if isinstance(x, dict):
        return {k: _to_builtin(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_builtin(v) for v in x]
    return x


def write_json(path: str | Path, payload: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", encoding="utf-8") as f:
        json.dump(_to_builtin(payload), f, indent=2)
    return path


def write_patch_csv(path: str | Path, names: list[str], stats: dict) -> Path:
    """PATCH_PDE_COEFFS.csv (patch_based_pde_discovery.py:468-472)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", encoding="utf-8") as f:
        f.write("term,median,q25,q75,nonzero_freq,sign_stability,agg_coeff\n")
        for i, name in enumerate(names):
            f.write(
                f"{name},{stats['median'][i]:.8g},{stats['q25'][i]:.8g},{stats['q75'][i]:.8g},"
                f"{stats['freq'][i]:.3f},{stats['sign_stability'][i]:.3f},{stats['coeffs'][i]:.8g}\n"
            )
    return path
