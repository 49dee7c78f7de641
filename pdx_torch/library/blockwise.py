"""Blockwise-averaged regression dataset (port of ``pdx/library/blockwise.py``).

u_t and every term are averaged over (block_t x block_x x block_y) blocks;
ragged tail blocks are means over their valid cells. This is the plain
reference that kernel K3 (``pdx_torch/csrc/fused_blockwise.cu``) is held to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor


def _block_reduce_sum(A: Tensor, bt: int, bx: int, by: int) -> Tensor:
    """Sum over (bt, bx, by) blocks of the trailing three axes, zero-padding
    ragged tails. Returns (..., nbt, nbx, nby)."""
    T, H, W = A.shape[-3], A.shape[-2], A.shape[-1]
    nbt, nbx, nby = -(-T // bt), -(-H // bx), -(-W // by)
    Ap = F.pad(A, (0, nby * by - W, 0, nbx * bx - H, 0, nbt * bt - T))
    Ar = Ap.reshape(A.shape[:-3] + (nbt, bt, nbx, bx, nby, by))
    return Ar.sum(dim=(-5, -3, -1))


def block_counts(T: int, H: int, W: int, bt: int, bx: int, by: int, dtype, device=None) -> Tensor:
    """Number of valid (unpadded) cells per block — normalizer for ragged tails."""
    ones = torch.ones((T, H, W), dtype=dtype, device=device)
    return _block_reduce_sum(ones, bt, bx, by)


def build_blockwise_dataset(
    Ut: Tensor, terms: Tensor, *, block_t: int, block_x: int, block_y: int
) -> tuple[Tensor, Tensor]:
    """Returns (X[(n_blocks, p)], y[(n_blocks,)]) of block means, blocks
    enumerated t outer, x middle, y inner (the reference's loop nest)."""
    bt, bx, by = int(block_t), int(block_x), int(block_y)
    if bt <= 0 or bx <= 0 or by <= 0:
        raise ValueError("block_t/block_x/block_y must all be positive")
    T, H, W = Ut.shape
    cnt = block_counts(T, H, W, bt, bx, by, Ut.dtype, Ut.device)
    y_blocks = _block_reduce_sum(Ut, bt, bx, by) / cnt
    x_blocks = _block_reduce_sum(terms, bt, bx, by) / cnt  # (p, nbt, nbx, nby)
    p = terms.shape[0]
    X = x_blocks.reshape(p, -1).T
    y = y_blocks.reshape(-1)
    return X, y
