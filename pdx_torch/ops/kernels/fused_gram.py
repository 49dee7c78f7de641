"""K1 and K2 — fused KS dictionary + Gram statistics over the full field.

Port of ``pdx/ops/pallas/fused_gram.py:39-69, 115-147, 177-344``. The
pointwise KS pipeline's memory traffic is dominated by materialising the term
stack before one GEMM. Kernel K1 (``pdx_torch/csrc/fused_gram.cu``) reads U
and Ut once, computes the periodic stencil terms [lap, bih, |grad u|^2] on
chip, and returns the ``gram_stats`` dict {G, b, sx, n, syy, sy} of the true
library; kernel K2 (``pdx_torch/csrc/fused_gram_terms.cu``) does the same for
any list of terms of the rich vocabulary ``RICH_TERM_NAMES``.

Fields are computed in float32 from float32-rounded inputs, as the TPU
kernels do (the kernels read float64 input directly and round each value on
load, which gives the value ``.to(torch.float32)`` gives); sums are float64
in the kernels and in their plain versions
:func:`fused_ks_gram_reference` and :func:`_terms_reference`, so the
statistics come back as float64.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import Tensor

from pdx_torch.ops.linalg import gram_stats

RICH_TERM_NAMES = ("one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap")

_MAX_TILE = 64  # widest tile side in points (unless one block is wider)
_TERMS_MAX_TILE = 50  # K2's tile side: a (tile + 4)^2 patch, double-buffered
_TARGET_CTAS = 1024  # ~8 resident 256-thread CTAs on each of 132 SMs

# K1 and K3 stage row bands at full frame width (csrc/band_common.cuh)
_SMEM_PER_CTA = 232448  # 227 KB: the most shared memory one CTA may take on the H100
_SMEM_PER_SM = 233472  # 228 KB an SM, of which each resident CTA reserves 1 KB
_BAND_MAX_THREADS = 768  # kBandMaxThreads
_BAND_MAX_RUNS = 8  # kMaxRuns
_K1_THREADS = 512  # threads of a K1 CTA
# how K1 and K3 stage a frame (kElementwise, kBulk, kRounded)
_ROUTE_ELEMENTWISE, _ROUTE_BULK, _ROUTE_ROUNDED = 0, 1, 2
ROUTE_NAMES = ("element-wise copies", "bulk copies", "float64 rounded in flight")


def _ks_terms_2d(u: Tensor, dx: float, dy: float) -> tuple[Tensor, Tensor, Tensor]:
    """lap, bih, |grad u|^2 with periodic rolls on the trailing two axes."""
    lap = (
        (torch.roll(u, -1, -2) - 2 * u + torch.roll(u, 1, -2)) / (dx * dx)
        + (torch.roll(u, -1, -1) - 2 * u + torch.roll(u, 1, -1)) / (dy * dy)
    )
    bih = (
        (torch.roll(lap, -1, -2) - 2 * lap + torch.roll(lap, 1, -2)) / (dx * dx)
        + (torch.roll(lap, -1, -1) - 2 * lap + torch.roll(lap, 1, -1)) / (dy * dy)
    )
    gx = (torch.roll(u, -1, -2) - torch.roll(u, 1, -2)) / (2 * dx)
    gy = (torch.roll(u, -1, -1) - torch.roll(u, 1, -1)) / (2 * dy)
    return lap, bih, gx * gx + gy * gy


def _term_fields(u: Tensor, dx: float, dy: float, names: tuple[str, ...]) -> list[Tensor]:
    """The named periodic-stencil term fields of the rich KS vocabulary
    (``RICH_TERM_NAMES``); shared intermediates are built once."""
    need = set(names)
    ux = uy = lap = bih = None
    if need & {"ux", "uy", "gradsq"}:
        ux = (torch.roll(u, -1, -2) - torch.roll(u, 1, -2)) / (2 * dx)
        uy = (torch.roll(u, -1, -1) - torch.roll(u, 1, -1)) / (2 * dy)
    if need & {"lap", "bih", "u_lap"}:
        lap = (
            (torch.roll(u, -1, -2) - 2 * u + torch.roll(u, 1, -2)) / (dx * dx)
            + (torch.roll(u, -1, -1) - 2 * u + torch.roll(u, 1, -1)) / (dy * dy)
        )
    if "bih" in need:
        bih = (
            (torch.roll(lap, -1, -2) - 2 * lap + torch.roll(lap, 1, -2)) / (dx * dx)
            + (torch.roll(lap, -1, -1) - 2 * lap + torch.roll(lap, 1, -1)) / (dy * dy)
        )
    built = {
        "one": lambda: torch.ones_like(u),
        "u": lambda: u,
        "u2": lambda: u * u,
        "ux": lambda: ux,
        "uy": lambda: uy,
        "lap": lambda: lap,
        "bih": lambda: bih,
        "gradsq": lambda: ux * ux + uy * uy,
        "u_lap": lambda: u * lap,
    }
    return [built[n]() for n in names]


def fused_ks_gram_reference(U: Tensor, Ut: Tensor, dx: float, dy: float) -> dict[str, Tensor]:
    """Plain version of K1: materialise the three fields (float32), then
    float64 ``gram_stats`` — the term stack the kernel avoids."""
    lap, bih, gsq = _ks_terms_2d(U.to(torch.float32), dx, dy)
    X = torch.stack([lap.reshape(-1), bih.reshape(-1), gsq.reshape(-1)], dim=-1)
    y = Ut.to(torch.float32).reshape(-1)
    return gram_stats(X.to(torch.float64), y.to(torch.float64))


# --- helpers shared with K2-K4 ----------------------------------------------


def _check_inputs(U: Tensor, Ut: Tensor) -> None:
    """Both (T, H, W), equal shapes, one device, float32 or float64."""
    if U.ndim != 3 or U.shape != Ut.shape or min(U.shape) < 1:
        raise ValueError(f"U and Ut must be equal non-empty (T, H, W); got {tuple(U.shape)}, {tuple(Ut.shape)}")
    if U.device != Ut.device:
        raise ValueError(f"U and Ut must share a device; got {U.device}, {Ut.device}")
    for t in (U, Ut):
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"U and Ut must be float32 or float64; got {t.dtype}")
    if U.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {U.device}")


def _kernel_inputs(U: Tensor, Ut: Tensor) -> tuple[Tensor, Tensor, int]:
    """The kernels' inputs: U and Ut contiguous in one type, float64 if both
    are (the kernels round it on load), else float32; and the f64 flag."""
    dtype = U.dtype if U.dtype == Ut.dtype else torch.float32
    return U.to(dtype).contiguous(), Ut.to(dtype).contiguous(), int(dtype == torch.float64)


def _tile(n: int, unit: int, max_tile: int = _MAX_TILE) -> tuple[int, int]:
    """(tile, n_tiles) along one axis of n points: a tile is a whole number
    of ``unit``-point blocks, at most ``max_tile`` points unless one block
    is wider, and the tiles are balanced (100 -> two tiles of 50)."""
    nb = -(-n // unit)
    n_tiles = -(-nb // max(1, max_tile // unit))
    per = -(-nb // n_tiles)
    return per * unit, -(-nb // per)


def _chunks(n_items: int, n_tiles: int) -> tuple[int, int]:
    """(items_per_cta, n_chunks): split frames (or temporal blocks) so that
    tiles x chunks is about ``_TARGET_CTAS``."""
    want = max(1, min(n_items, _TARGET_CTAS // n_tiles))
    per = -(-n_items // want)
    return per, -(-n_items // per)


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def _band_smem_bytes(TH: int, W: int, itemsize: int, extra: int = 0) -> int:
    """Shared memory of a K1/K3 CTA whose band is TH rows of W columns:
    ``band_layout`` of ``csrc/band_common.cuh`` — two stages of the
    (TH + 4) x W patch and the TH x W band of u_t in the staged type
    (``itemsize`` bytes: the input's, or 4 on the rounded route), staged
    float64's rounded patch, the (TH + 2) x W Laplacian ring, the row
    offsets (or the run table), the epilogue's buffer, a barrier a stage
    and ``extra`` bytes of the kernel's own."""
    patch, band, ring = (TH + 4) * W, TH * W, (TH + 2) * W
    off = 2 * (_align16(patch * itemsize) + _align16(band * itemsize))
    off = _align16(off + (patch * 4 if itemsize == 8 else 0))
    off = _align16(off + ring * 4)
    off = _align16(off + max(TH + 4, 3 * _BAND_MAX_RUNS + 1) * 4)
    off = _align16(off + (_BAND_MAX_THREADS // 32) * 14 * 8)
    return _align16(off + 16) + _align16(extra)


def _band_route(W: int, itemsize: int, *pointers: int) -> int:
    """``_ROUTE_BULK`` when a frame's band can be staged by bulk asynchronous
    copies (every row and both base pointers 16-byte aligned), else
    ``_ROUTE_ELEMENTWISE``. A choice by shape and address, made before the
    launch; no route gives way to another or to the plain version."""
    return int((W * itemsize) % 16 == 0 and all(p % 16 == 0 for p in pointers))


def _rounded_if_too_large(plan, itemsize: int, route: int):
    """(route, *plan(staged itemsize)): the copy route ``route`` with the
    input staged as it is, or, where ``plan`` finds no band of float64 that
    fits shared memory, ``_ROUTE_ROUNDED``, whose stages hold float32: every
    frame and block shape that runs on float32 input runs on float64."""
    try:
        return (route, *plan(itemsize))
    except ValueError:
        if itemsize != 8:
            raise
    return (_ROUTE_ROUNDED, *plan(4))


def _band_rows(H: int, W: int, itemsize: int) -> tuple[int, int]:
    """K1's bands: (rows per band, n_bands), the fewest balanced bands whose
    shared memory fits a CTA (the whole frame where it fits)."""
    for n in range(1, H + 1):
        TH = -(-H // n)
        if _band_smem_bytes(TH, W, itemsize) <= _SMEM_PER_CTA:
            return TH, -(-H // TH)
    raise ValueError(
        f"fused_ks_gram: one row of a frame {W} wide needs {_band_smem_bytes(1, W, itemsize)} B of "
        f"shared memory per CTA; the card allows {_SMEM_PER_CTA}"
    )


def _long_chunks(n_items: int, n_bands: int, slots: int) -> tuple[int, int]:
    """(items_per_cta, n_chunks) for few, long CTAs: about one CTA for each
    of the card's ``slots`` resident CTAs, each walking a run of frames (or
    temporal blocks)."""
    want = max(1, min(n_items, slots // n_bands))
    per = -(-n_items // want)
    return per, -(-n_items // per)


def _check_smem(nbytes: int, device: torch.device, what: str) -> None:
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if nbytes > limit:
        raise ValueError(f"{what} needs {nbytes} B of shared memory per CTA; the card allows {limit}")


def _stencil_args(dx: float, dy: float) -> tuple[float, float, float, float]:
    """dx*dx, dy*dy, 2*dx, 2*dy — ctypes rounds each to float32, the value
    the plain float32 version divides by."""
    return dx * dx, dy * dy, 2 * dx, 2 * dy


@functools.cache
def _true_gram_index(device: torch.device) -> Tensor:
    """(3, 3) positions of the Gram entries in a K1/K3 row, kept on the
    device so that unpacking a row copies nothing from the host."""
    return torch.tensor([[0, 1, 2], [1, 3, 4], [2, 4, 5]], device=device)


def _launch_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (nothing to
    enter when it already is)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stats_from_row(out: Tensor, n: float) -> dict[str, Tensor]:
    """The kernels' 14 statistics (G00 G01 G02 G11 G12 G22 b0 b1 b2 sx0 sx1
    sx2 sy syy) as a ``gram_stats`` dict."""
    return {
        "G": out[_true_gram_index(out.device)],
        "b": out[6:9],
        "sx": out[9:12],
        "n": torch.full((), n, dtype=out.dtype, device=out.device),
        "syy": out[13],
        "sy": out[12],
    }


def _term_codes(names) -> tuple[str, ...]:
    """Check a term list against the kernels' vocabulary (1 to 9 names of
    ``RICH_TERM_NAMES``); returns it as a tuple."""
    names = tuple(names)
    bad = [n for n in names if n not in RICH_TERM_NAMES]
    if bad or not 1 <= len(names) <= len(RICH_TERM_NAMES):
        raise ValueError(
            f"names must be 1 to {len(RICH_TERM_NAMES)} of {RICH_TERM_NAMES}; got {names}"
        )
    return names


@functools.cache
def _codes_arg(names: tuple[str, ...]):
    """The term list as the C entry points take it: an int array of
    indices into ``RICH_TERM_NAMES`` (cached: the C side only reads it)."""
    import ctypes

    return (ctypes.c_int * len(names))(*(RICH_TERM_NAMES.index(n) for n in names))


@functools.cache
def _gram_index(p: int, device: torch.device) -> Tensor:
    """(p, p) positions of the Gram entries in a K2/K4 row, kept on the
    device so that unpacking a row copies nothing from the host."""
    tri = torch.zeros((p, p), dtype=torch.long)
    iu = torch.triu_indices(p, p)
    tri[iu[0], iu[1]] = torch.arange(iu.shape[1])
    return torch.maximum(tri, tri.T).to(device)


def _terms_stats_from_row(out: Tensor, p: int, n: float) -> dict[str, Tensor]:
    """The p(p+1)/2 + 2p + 2 statistics of K2/K4 (Gram upper triangle
    row-major, b, sx, sy, syy: the order of pdx's ``_kernel_terms``) as a
    ``gram_stats`` dict."""
    ntri = p * (p + 1) // 2
    return {
        "G": out[_gram_index(p, out.device)],
        "b": out[ntri : ntri + p],
        "sx": out[ntri + p : ntri + 2 * p],
        "n": torch.full((), n, dtype=out.dtype, device=out.device),
        "syy": out[ntri + 2 * p + 1],
        "sy": out[ntri + 2 * p],
    }


def _terms_reference(U: Tensor, Ut: Tensor, dx: float, dy: float, names) -> dict[str, Tensor]:
    """Plain version of K2: materialise the named fields (float32), then
    float64 ``gram_stats`` — the term stack the kernel avoids."""
    fields = _term_fields(U.to(torch.float32), dx, dy, tuple(names))
    X = torch.stack([f.reshape(-1) for f in fields], dim=-1)
    y = Ut.to(torch.float32).reshape(-1)
    return gram_stats(X.to(torch.float64), y.to(torch.float64))


@functools.cache
def _terms_launch(T: int, H: int, W: int, f64: int, device: torch.device) -> tuple[int, ...]:
    """K2's launch shape (TH, TW, frames_per_cta, n_tiles_x, n_tiles_y,
    n_chunks), checked against the card's shared memory; cached, so that a
    call spends no host time on it once the shape has been seen."""
    from pdx_torch.ops.kernels._build import library

    TH, ntx = _tile(H, 1, _TERMS_MAX_TILE)
    TW, nty = _tile(W, 1, _TERMS_MAX_TILE)
    _check_smem(library().pdx_fused_ks_gram_terms_smem_bytes(TH, TW, f64), device, "fused_ks_gram_terms")
    fpc, ntz = _chunks(T, ntx * nty)
    return TH, TW, fpc, ntx, nty, ntz


def fused_ks_gram_terms(
    U: Tensor, Ut: Tensor, *, dx: float, dy: float, names=RICH_TERM_NAMES
) -> dict[str, Tensor]:
    """Streaming dictionary + Gram statistics for any list of 1 to 9 terms
    of ``RICH_TERM_NAMES`` (default: the rich 9-term KS library), in the
    order given.

    On the CPU this is :func:`_terms_reference`; on a CUDA tensor it
    launches K2 (on float64 input directly, else on float32) and raises if
    the build or the launch fails. Returns float64 statistics, n = T * H * W.
    """
    names = _term_codes(names)
    _check_inputs(U, Ut)
    if U.device.type == "cpu":
        return _terms_reference(U, Ut, dx, dy, names)
    from pdx_torch.ops.kernels._build import library

    lib = library()
    T, H, W = U.shape
    p = len(names)
    Uk, Utk, f64 = _kernel_inputs(U, Ut)
    TH, TW, fpc, ntx, nty, ntz = _terms_launch(T, H, W, f64, U.device)
    n_stats = p * (p + 1) // 2 + 2 * p + 2
    partials = torch.empty((ntx * nty * ntz, n_stats), dtype=torch.float64, device=U.device)
    out = torch.empty(n_stats, dtype=torch.float64, device=U.device)
    with torch.cuda.device(U.device):
        rc = lib.pdx_fused_ks_gram_terms(
            Uk.data_ptr(), Utk.data_ptr(), f64, T, H, W, TH, TW, fpc, ntx, nty, ntz,
            *_stencil_args(dx, dy), _codes_arg(names), p, partials.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_ks_gram_terms: CUDA launch failed with error {rc}")
    fused_ks_gram_terms.launches += 1
    return _terms_stats_from_row(out, p, float(T * H * W))


fused_ks_gram_terms.launches = 0  # K2 launches in this process


def _gram_band_plan(H: int, W: int, itemsize: int, route: int) -> tuple[int, int, int]:
    """K1's (route, rows per band, n_bands) for input of ``itemsize`` bytes
    whose alignment allows ``route``."""
    return _rounded_if_too_large(lambda staged: _band_rows(H, W, staged), itemsize, route)


@functools.cache
def _gram_launch(T: int, H: int, W: int, f64: int, route: int, device: torch.device) -> tuple[int, ...]:
    """K1's launch shape (route, TH, threads, frames_per_cta, n_bands,
    n_chunks) for input that ``_band_route`` gives ``route``, checked
    against the card's shared memory; cached, so that a call spends no host
    time on it once the shape has been seen."""
    import ctypes

    from pdx_torch.ops.kernels._build import library

    lib = library()
    route, TH, n_bands = _gram_band_plan(H, W, 8 if f64 else 4, route)
    staged64 = int(f64 and route != _ROUTE_ROUNDED)
    smem = _band_smem_bytes(TH, W, 8 if staged64 else 4)
    if smem != lib.pdx_band_smem_bytes(TH, W, staged64):
        raise RuntimeError("fused_ks_gram: the planned shared memory differs from the kernel's layout")
    _check_smem(smem, device, "fused_ks_gram")
    regs, ctas = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.pdx_fused_ks_gram_occupancy(TH, W, _K1_THREADS, f64, route, ctypes.byref(regs), ctypes.byref(ctas))
    if rc != 0 or ctas.value < 1:
        raise RuntimeError(f"fused_ks_gram: no CTA of this launch shape fits an SM (CUDA error {rc})")
    slots = torch.cuda.get_device_properties(device).multi_processor_count * ctas.value
    fpc, n_chunks = _long_chunks(T, n_bands, slots)
    return route, TH, _K1_THREADS, fpc, n_bands, n_chunks


def fused_ks_gram(U: Tensor, Ut: Tensor, *, dx: float, dy: float) -> dict[str, Tensor]:
    """Streaming dictionary + Gram statistics for [lap, bih, gradsq].

    U and Ut are aligned (T, H, W) stacks (any T, H, W). On the CPU this is
    :func:`fused_ks_gram_reference`; on a CUDA tensor it launches K1 (on
    float64 input directly, else on float32) and raises if the build or the
    launch fails. Returns float64 statistics.
    """
    _check_inputs(U, Ut)
    if U.device.type == "cpu":
        return fused_ks_gram_reference(U, Ut, dx, dy)
    from pdx_torch.ops.kernels._build import library

    lib = library()
    T, H, W = U.shape
    # partials and any copies may be released before the kernel ends: the
    # caching allocator reuses them only for work queued later on this stream
    Uk, Utk, f64 = _kernel_inputs(U, Ut)
    aligned = _band_route(W, Uk.element_size(), Uk.data_ptr(), Utk.data_ptr())
    route, TH, threads, fpc, n_bands, n_chunks = _gram_launch(T, H, W, f64, aligned, U.device)
    rows = torch.empty((n_bands * n_chunks + 1, 14), dtype=torch.float64, device=U.device)
    out = rows[0]  # the statistics; the CTAs' partial rows follow
    with _launch_device(U.device):
        rc = lib.pdx_fused_ks_gram(
            Uk.data_ptr(), Utk.data_ptr(), f64, route, T, H, W, TH, threads, fpc, n_bands, n_chunks,
            *_stencil_args(dx, dy), rows[1:].data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_ks_gram: CUDA launch failed with error {rc}")
    fused_ks_gram.launches += 1
    return _stats_from_row(out, float(T * H * W))


fused_ks_gram.launches = 0  # K1 launches in this process
