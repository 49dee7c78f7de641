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

Fields are float32 from float32-rounded inputs (the kernels round float64
input on load); block sums, means and Gram sums
are float64 in the kernels and in :func:`fused_blockwise_gram_reference` /
:func:`fused_blockwise_gram_terms_reference`.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor

from pdx_torch.library.blockwise import build_blockwise_dataset
from pdx_torch.ops.kernels.fused_gram import (
    _BAND_MAX_THREADS,
    _ROUTE_ROUNDED,
    _SMEM_PER_CTA,
    _SMEM_PER_SM,
    _band_route,
    _band_smem_bytes,
    _check_inputs,
    _check_smem,
    _chunks,
    _codes_arg,
    _kernel_inputs,
    _launch_device,
    _long_chunks,
    _rounded_if_too_large,
    _ks_terms_2d,
    _stats_from_row,
    _stencil_args,
    _term_codes,
    _term_fields,
    _terms_stats_from_row,
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


def _group_threads(bx: int, by: int) -> int:
    """Threads that share a spatial block in K3 and K4: a power of two, at
    most 32, about 8 points each."""
    return 1 << min(5, max(0, (bx * by // 8).bit_length() - 1))


def _blockwise_smem_bytes(W: int, bx: int, by: int, kb: int, G: int, itemsize: int) -> int:
    """Shared memory of a K3 CTA: the band's layout and the 14 float64 sums
    of each of its thread groups."""
    threads = -(-kb * -(-W // by) * G // 32) * 32
    return _band_smem_bytes(kb * bx, W, itemsize, threads // G * 14 * 8)


def _blockwise_band_plan(H: int, W: int, bx: int, by: int, itemsize: int) -> tuple[int, int, int, int]:
    """K3's launch shape: (kb, G, n_bands, threads). A band is kb whole
    block-rows at full frame width; G threads (a power of two, halved until
    one block-row's groups fit a CTA) share a spatial block, so a CTA takes
    kb * nby * G threads rounded up to a warp. kb is the largest of which
    two CTAs stay resident on an SM, so that one's copies and barriers hide
    behind the other's work: by shared memory, and by registers, which the
    kernel's launch bound caps so that ``_BAND_MAX_THREADS`` threads fit,
    in one CTA or two. Where not even one block-row allows two, the largest
    that fits; then the bands are balanced."""
    nbx, nby = -(-H // bx), -(-W // by)
    G = _group_threads(bx, by)
    while G > 1 and nby * G > _BAND_MAX_THREADS:
        G //= 2

    def threads(kb: int) -> int:
        return -(-kb * nby * G // 32) * 32

    smem = {kb: _blockwise_smem_bytes(W, bx, by, kb, G, itemsize) for kb in range(1, nbx + 1)}
    fit = [kb for kb in smem if threads(kb) <= _BAND_MAX_THREADS and smem[kb] <= _SMEM_PER_CTA]
    if not fit:
        raise ValueError(
            f"fused_blockwise_gram with blocks ({bx}, {by}) on a {H} x {W} frame: a band of one block-row "
            f"needs {nby * G} threads (at most {_BAND_MAX_THREADS}) and {smem[1]} B of shared memory per CTA "
            f"(at most {_SMEM_PER_CTA})"
        )
    two = [k for k in fit if 2 * threads(k) <= _BAND_MAX_THREADS and 2 * (smem[k] + 1024) <= _SMEM_PER_SM]
    kb = max(two or fit)
    n_bands = -(-nbx // kb)
    kb = -(-nbx // n_bands)
    return kb, G, n_bands, threads(kb)


def _blockwise_route_plan(H: int, W: int, bx: int, by: int, itemsize: int, route: int) -> tuple[int, ...]:
    """K3's (route, kb, G, n_bands, threads) for input of ``itemsize`` bytes
    whose alignment allows ``route``."""
    return _rounded_if_too_large(
        lambda staged: _blockwise_band_plan(H, W, bx, by, staged), itemsize, route
    )


@functools.cache
def _blockwise_launch(
    T: int, H: int, W: int, bt: int, bx: int, by: int, f64: int, route: int, device: torch.device
) -> tuple[int, ...]:
    """K3's launch shape (route, kb, G, tblocks_per_cta, n_bands, n_chunks)
    for input that ``_band_route`` gives ``route``, checked against the
    card's shared memory; cached, so that a call spends no host time on it
    once the shape has been seen."""
    import ctypes

    from pdx_torch.ops.kernels._build import library

    lib = library()
    route, kb, G, n_bands, _ = _blockwise_route_plan(H, W, bx, by, 8 if f64 else 4, route)
    staged64 = int(f64 and route != _ROUTE_ROUNDED)
    smem = _blockwise_smem_bytes(W, bx, by, kb, G, 8 if staged64 else 4)
    if smem != lib.pdx_fused_blockwise_smem_bytes(W, bx, by, kb, G, staged64):
        raise RuntimeError("fused_blockwise_gram: the planned shared memory differs from the kernel's layout")
    _check_smem(smem, device, f"fused_blockwise_gram with blocks ({bt}, {bx}, {by})")
    regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.pdx_fused_blockwise_occupancy(W, bx, by, kb, G, f64, route, ctypes.byref(regs), ctypes.byref(ctas))
    if rc != 0 or ctas.value < 1:
        raise RuntimeError(f"fused_blockwise_gram: no CTA of this launch shape fits an SM (CUDA error {rc})")
    slots = torch.cuda.get_device_properties(device).multi_processor_count * ctas.value
    tpc, n_chunks = _long_chunks(-(-T // bt), n_bands, slots)
    return route, kb, G, tpc, n_bands, n_chunks


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
    tensor it launches K3 (on float64 input directly, else on float32) and
    raises if a band of one block-row does not fit the card or the build or
    the launch fails. Returns float64 statistics with n = nbt * nbx * nby.
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
    Uk, Utk, f64 = _kernel_inputs(U, Ut)
    aligned = _band_route(W, Uk.element_size(), Uk.data_ptr(), Utk.data_ptr())
    route, kb, G, tpc, n_bands, n_chunks = _blockwise_launch(T, H, W, bt, bx, by, f64, aligned, U.device)
    rows = torch.empty((n_bands * n_chunks + 1, 14), dtype=torch.float64, device=U.device)
    out = rows[0]  # the statistics; the CTAs' partial rows follow
    with _launch_device(U.device):
        rc = lib.pdx_fused_blockwise_gram(
            Uk.data_ptr(), Utk.data_ptr(), f64, route, T, H, W, bt, bx, by, kb, G, tpc,
            n_bands, n_chunks, *_stencil_args(dx, dy), rows[1:].data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_blockwise_gram: CUDA launch failed with error {rc}")
    fused_blockwise_gram.launches += 1
    n_blocks = -(-T // bt) * -(-H // bx) * -(-W // by)
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
    G = _group_threads(bx, by)
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
