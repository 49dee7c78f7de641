"""K3 and K4 — fused blockwise average + Gram statistics.

Port of ``pdx/ops/pallas/fused_blockwise.py:45-106, 109-253, 256-346``. The
blockwise dataset averages u_t and the KS terms over (block_t x block_x x
block_y) blocks before the regression; kernel K3
(``pdx_torch/csrc/fused_blockwise.cu``) streams U and Ut once and returns the
``gram_stats`` dict of the block-mean rows of [lap, bih, gradsq] without
materialising the term stack or the (n_blocks, 3) design matrix; kernel K4
(``pdx_torch/csrc/fused_blockwise_terms.cu``) does the same for any list of
terms of ``RICH_TERM_NAMES``. Ragged tails on every axis are means over their
valid cells, as in :func:`pdx_torch.library.blockwise.build_blockwise_dataset`.

Fields are float32 from float32-cast inputs; block sums, means and Gram sums
are float64 in the kernels and in :func:`fused_blockwise_gram_reference` /
:func:`fused_blockwise_gram_terms_reference`.
"""

from __future__ import annotations

import torch
from torch import Tensor

from pdx_torch.library.blockwise import build_blockwise_dataset
from pdx_torch.ops.kernels.fused_gram import (
    _check_inputs,
    _check_smem,
    _chunks,
    _codes_arg,
    _f32,
    _ks_terms_2d,
    _stats_from_row,
    _stencil_args,
    _term_codes,
    _term_fields,
    _terms_stats_from_row,
    _tile,
)
from pdx_torch.ops.linalg import gram_stats


def fused_blockwise_gram_reference(
    U: Tensor, Ut: Tensor, dx: float, dy: float, *, block_t: int, block_x: int, block_y: int
) -> dict[str, Tensor]:
    """Plain version of K3: float32 fields, then the float64 blockwise
    builder and ``gram_stats`` (the materialisation the kernel avoids)."""
    lap, bih, gsq = _ks_terms_2d(U.to(torch.float32), dx, dy)
    terms = torch.stack([lap, bih, gsq], dim=0).to(torch.float64)
    X, y = build_blockwise_dataset(
        Ut.to(torch.float32).to(torch.float64), terms,
        block_t=block_t, block_x=block_x, block_y=block_y,
    )
    return gram_stats(X, y)


def _check_blocks(block_t: int, block_x: int, block_y: int) -> tuple[int, int, int]:
    bt, bx, by = int(block_t), int(block_x), int(block_y)
    if bt <= 0 or bx <= 0 or by <= 0:
        raise ValueError("block_t/block_x/block_y must all be positive")
    return bt, bx, by


def fused_blockwise_gram(
    U: Tensor,
    Ut: Tensor,
    *,
    dx: float,
    dy: float,
    block_t: int = 3,
    block_x: int = 8,
    block_y: int = 8,
) -> dict[str, Tensor]:
    """Streaming blockwise Gram statistics for [lap, bih, gradsq].

    On the CPU this is :func:`fused_blockwise_gram_reference`; on a CUDA
    tensor it launches K3 and raises if the block sizes do not fit the card
    or the build or the launch fails. Returns float64 statistics with
    n = nbt * nbx * nby.
    """
    bt, bx, by = _check_blocks(block_t, block_x, block_y)
    _check_inputs(U, Ut)
    if U.device.type == "cpu":
        return fused_blockwise_gram_reference(
            U, Ut, dx, dy, block_t=bt, block_x=bx, block_y=by
        )
    from pdx_torch.ops.kernels._build import library

    lib = library()
    T, H, W = U.shape
    TH, ntx = _tile(H, bx)
    TW, nty = _tile(W, by)
    _check_smem(
        lib.pdx_fused_blockwise_smem_bytes(TH, TW, bx, by), U.device,
        f"fused_blockwise_gram with blocks ({bt}, {bx}, {by})",
    )
    nbt = -(-T // bt)
    tpc, ntz = _chunks(nbt, ntx * nty)
    U32, Ut32 = _f32(U), _f32(Ut)
    partials = torch.empty((ntx * nty * ntz, 14), dtype=torch.float64, device=U.device)
    out = torch.empty(14, dtype=torch.float64, device=U.device)
    with torch.cuda.device(U.device):
        rc = lib.pdx_fused_blockwise_gram(
            U32.data_ptr(), Ut32.data_ptr(), T, H, W, bt, bx, by, TH, TW, tpc,
            ntx, nty, ntz, *_stencil_args(dx, dy), partials.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_blockwise_gram: CUDA launch failed with error {rc}")
    fused_blockwise_gram.launches += 1
    n_blocks = nbt * -(-H // bx) * -(-W // by)
    return _stats_from_row(out, float(n_blocks))


fused_blockwise_gram.launches = 0  # K3 launches in this process


def fused_blockwise_gram_terms_reference(
    U: Tensor, Ut: Tensor, dx: float, dy: float, *, names, block_t: int, block_x: int, block_y: int
) -> dict[str, Tensor]:
    """Plain version of K4: the named float32 fields, then
    ``build_blockwise_dataset`` and ``gram_stats`` in float64."""
    terms = torch.stack(_term_fields(U.to(torch.float32), dx, dy, tuple(names)), dim=0)
    X, y = build_blockwise_dataset(
        Ut.to(torch.float32).to(torch.float64), terms.to(torch.float64),
        block_t=block_t, block_x=block_x, block_y=block_y,
    )
    return gram_stats(X, y)


def fused_blockwise_gram_terms(
    U: Tensor,
    Ut: Tensor,
    *,
    dx: float,
    dy: float,
    names,
    block_t: int = 3,
    block_x: int = 8,
    block_y: int = 8,
) -> dict[str, Tensor]:
    """Streaming blockwise Gram statistics for any list of 1 to 9 terms of
    ``RICH_TERM_NAMES``, in the order given.

    On the CPU this is :func:`fused_blockwise_gram_terms_reference`; on a
    CUDA tensor it launches K4 and raises if the block sizes do not fit the
    card or the build or the launch fails. Returns float64 statistics with
    n = nbt * nbx * nby.
    """
    names = _term_codes(names)
    bt, bx, by = _check_blocks(block_t, block_x, block_y)
    _check_inputs(U, Ut)
    if U.device.type == "cpu":
        return fused_blockwise_gram_terms_reference(
            U, Ut, dx, dy, names=names, block_t=bt, block_x=bx, block_y=by
        )
    from pdx_torch.ops.kernels._build import library

    lib = library()
    T, H, W = U.shape
    p = len(names)
    TH, ntx = _tile(H, bx)
    TW, nty = _tile(W, by)
    _check_smem(
        lib.pdx_fused_blockwise_terms_smem_bytes(TH, TW, bx, by, p), U.device,
        f"fused_blockwise_gram_terms with blocks ({bt}, {bx}, {by})",
    )
    nbt = -(-T // bt)
    tpc, ntz = _chunks(nbt, ntx * nty)
    n_stats = p * (p + 1) // 2 + 2 * p + 2
    U32, Ut32 = _f32(U), _f32(Ut)
    partials = torch.empty((ntx * nty * ntz, n_stats), dtype=torch.float64, device=U.device)
    out = torch.empty(n_stats, dtype=torch.float64, device=U.device)
    with torch.cuda.device(U.device):
        rc = lib.pdx_fused_blockwise_gram_terms(
            U32.data_ptr(), Ut32.data_ptr(), T, H, W, bt, bx, by, TH, TW, tpc,
            ntx, nty, ntz, *_stencil_args(dx, dy), _codes_arg(names), p,
            partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_blockwise_gram_terms: CUDA launch failed with error {rc}")
    fused_blockwise_gram_terms.launches += 1
    n_blocks = nbt * -(-H // bx) * -(-W // by)
    return _terms_stats_from_row(out, p, float(n_blocks))


fused_blockwise_gram_terms.launches = 0  # K4 launches in this process
