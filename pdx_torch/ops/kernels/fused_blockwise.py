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

Fields are float32 from float32-rounded inputs (K4 rounds float64 input on
load); block sums, means and Gram sums
are float64 in the kernels and in :func:`fused_blockwise_gram_reference` /
:func:`fused_blockwise_gram_terms_reference`.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor

from pdx_torch.library.blockwise import build_blockwise_dataset
from pdx_torch.ops.kernels.fused_gram import (
    _check_inputs,
    _check_smem,
    _chunks,
    _codes_arg,
    _f32,
    _kernel_inputs,
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


_K4_THREADS = 256  # most threads a K4 CTA takes
_K4_MAX_PATCH = 4096  # most patch points a K4 tile stages: two float32 CTAs fit an SM


def _blockwise_plan(H: int, W: int, bx: int, by: int) -> tuple[int, int, int, int, int]:
    """K4's launch shape: (kbx, kby, G, n_tiles_x, n_tiles_y). G threads (a
    power of two, at most 32, about 8 points each) share a spatial block; a
    tile is kbx x kby whole blocks with kbx * kby * G <= 256 threads. Among
    the balanced tilings of the nbx x nby blocks, take the one that wastes
    least: the share of block slots that lie in the frame, times the share
    of the rounded-up warps' threads that own a block, times the patch's
    interior share (its 2-cell halo is staged but yields no sample)."""
    G = 1 << min(5, max(0, (bx * by // 8).bit_length() - 1))
    per_cta = max(1, _K4_THREADS // G)
    nbx, nby = -(-H // bx), -(-W // by)

    def balanced(nb: int) -> list[tuple[int, int]]:
        return sorted({(-(-nb // n), n) for n in range(1, nb + 1)})

    best, best_score = (1, 1, nbx, nby), -1.0  # kept only if no tiling fits
    for kbx, ntx in balanced(nbx):
        for kby, nty in balanced(nby):
            nblk = kbx * kby
            if nblk > per_cta or (kbx * bx + 4) * (kby * by + 4) > _K4_MAX_PATCH:
                continue
            threads = -(-nblk * G // 32) * 32
            score = (
                (nbx * nby) / (ntx * kbx * nty * kby)
                * (nblk * G) / threads
                * (kbx * bx * kby * by) / ((kbx * bx + 4) * (kby * by + 4))
            )
            if score > best_score:
                best, best_score = (kbx, kby, ntx, nty), score
    kbx, kby, ntx, nty = best
    return kbx, kby, G, ntx, nty


@functools.cache
def _blockwise_terms_launch(
    T: int, H: int, W: int, bt: int, bx: int, by: int, f64: int, device: torch.device
) -> tuple[int, ...]:
    """K4's launch shape (kbx, kby, G, tblocks_per_cta, n_tiles_x,
    n_tiles_y, n_chunks), checked against the card's shared memory; cached,
    so that a call spends no host time on it once the shape has been seen."""
    from pdx_torch.ops.kernels._build import library

    kbx, kby, G, ntx, nty = _blockwise_plan(H, W, bx, by)
    _check_smem(
        library().pdx_fused_blockwise_terms_smem_bytes(kbx, kby, bx, by, G, f64), device,
        f"fused_blockwise_gram_terms with blocks ({bt}, {bx}, {by})",
    )
    tpc, ntz = _chunks(-(-T // bt), ntx * nty)
    return kbx, kby, G, tpc, ntx, nty, ntz


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
    CUDA tensor it launches K4 (on float64 input directly, else on float32)
    and raises if the block sizes do not fit the card or the build or the
    launch fails. Returns float64 statistics with
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
    Uk, Utk, f64 = _kernel_inputs(U, Ut)
    kbx, kby, G, tpc, ntx, nty, ntz = _blockwise_terms_launch(T, H, W, bt, bx, by, f64, U.device)
    n_stats = p * (p + 1) // 2 + 2 * p + 2
    partials = torch.empty((ntx * nty * ntz, n_stats), dtype=torch.float64, device=U.device)
    out = torch.empty(n_stats, dtype=torch.float64, device=U.device)
    with torch.cuda.device(U.device):
        rc = lib.pdx_fused_blockwise_gram_terms(
            Uk.data_ptr(), Utk.data_ptr(), f64, T, H, W, bt, bx, by, kbx, kby, G, tpc,
            ntx, nty, ntz, *_stencil_args(dx, dy), _codes_arg(names), p,
            partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_blockwise_gram_terms: CUDA launch failed with error {rc}")
    fused_blockwise_gram_terms.launches += 1
    n_blocks = -(-T // bt) * -(-H // bx) * -(-W // by)
    return _terms_stats_from_row(out, p, float(n_blocks))


fused_blockwise_gram_terms.launches = 0  # K4 launches in this process
