"""Host-memory allocation helpers (port of ``pdx/utils/hostmem.py``).

On hosts that charge heavily for first-touch page faults, filling a freshly
allocated multi-hundred-MB numpy block costs seconds before any real work;
``pdx`` measured a (51, 1024, 1280) float32 fill drop from 12.8 s to 0.17 s
once the buffer is advised to use transparent huge pages before its first
touch. Host staging buffers on a hot path (image stacks) come from
:func:`huge_empty` instead of bare ``np.empty``.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

_MADV_HUGEPAGE = 14
_libc = None
if sys.platform.startswith("linux"):
    try:
        _libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:  # pragma: no cover - exotic libc layouts
        _libc = None


def madvise_hugepages(arr: np.ndarray) -> np.ndarray:
    """Best-effort ``madvise(MADV_HUGEPAGE)`` on an array's buffer.

    Call immediately after allocation, before first touch: the advice
    changes how the kernel populates the pages at fault time. No-op (and
    harmless) off Linux, on failure, or for arrays under one 2 MB page.
    """
    if _libc is None or arr.nbytes < (1 << 21):
        return arr
    try:
        addr = arr.__array_interface__["data"][0]
        off = addr % 4096
        _libc.madvise(
            ctypes.c_void_p(addr - off),
            ctypes.c_size_t(arr.nbytes + off),
            _MADV_HUGEPAGE,
        )
    except Exception:  # advisory only: the array is valid either way
        pass
    return arr


def huge_empty(shape, dtype) -> np.ndarray:
    """``np.empty`` whose pages fault in as huge pages (see module doc)."""
    return madvise_hugepages(np.empty(shape, dtype))
