"""Build and bind the port's CUDA kernels (``pdx_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every ``.cu`` file of ``pdx_torch/csrc/``
for ``sm_90a`` into one shared library with a plain C interface, under
``build/pdx_torch/<hash>/`` at the repository root, and ctypes loads it. The
hash covers the sources, the headers and the compiler flags, so an edit
rebuilds. Only the sources in the checkout and the CUDA toolkit are used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "pdx_torch"
_LIB_NAME = "libpdx_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "pdx_fused_ks_gram": (_I, [_P, _P] + [_I] * 9 + [_F] * 4 + [_P, _P, _P]),
    "pdx_fused_ks_gram_smem_bytes": (_LL, [_I, _I]),
    "pdx_fused_blockwise_gram": (_I, [_P, _P] + [_I] * 12 + [_F] * 4 + [_P, _P, _P]),
    "pdx_fused_blockwise_smem_bytes": (_LL, [_I, _I, _I, _I]),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build pdx_torch/csrc)")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if not cached."""
    out_dir = _BUILD / source_hash()
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
