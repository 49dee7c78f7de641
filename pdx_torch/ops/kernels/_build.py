"""Build and bind the port's CUDA kernels (``pdx_torch/csrc/*.cu``).

At first use, ``nvcc`` compiles every ``.cu`` file of ``pdx_torch/csrc/``
for ``sm_90a`` (one compiler process per source, all started together) and
links the objects into one shared library with a plain C interface, under
``build/pdx_torch/<hash>/`` at the repository root; ctypes loads it. The
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "pdx_fused_ks_gram": (_I, [_P, _P] + [_I] * 10 + [_F] * 4 + [_P, _P, _P]),
    "pdx_band_smem_bytes": (_LL, [_I] * 3),
    "pdx_fused_ks_gram_occupancy": (_I, [_I] * 5 + [_PI, _PI]),
    "pdx_fused_blockwise_gram": (_I, [_P, _P] + [_I] * 13 + [_F] * 4 + [_P, _P, _P]),
    "pdx_fused_blockwise_smem_bytes": (_LL, [_I] * 6),
    "pdx_fused_blockwise_occupancy": (_I, [_I] * 7 + [_PI, _PI]),
    "pdx_fused_ks_gram_terms": (_I, [_P, _P, _I] + [_I] * 9 + [_F] * 4 + [_P, _I, _P, _P, _P]),
    "pdx_fused_ks_gram_terms_smem_bytes": (_LL, [_I, _I, _I]),
    "pdx_fused_ks_gram_terms_occupancy": (_I, [_I] * 4 + [_PI, _PI]),
    "pdx_fused_blockwise_gram_terms": (_I, [_P, _P, _I] + [_I] * 13 + [_F] * 4 + [_P, _I, _P, _P, _P]),
    "pdx_fused_blockwise_terms_smem_bytes": (_LL, [_I] * 6),
    "pdx_fused_blockwise_terms_occupancy": (_I, [_I] * 6 + [_PI, _PI]),
    "pdx_flow_windows": (_I, [_I, _I] + [_P] * 5 + [_I] * 7 + [_P]),
    "pdx_flow_windows_smem_bytes": (_LL, [_I] * 3),
    "pdx_flow_windows_occupancy": (_I, [_I] * 3 + [_PI, _PI]),
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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if not cached."""
    out_dir = _BUILD / source_hash()
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in _sources()]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)
        ])
        tmp = out_dir / f"{_LIB_NAME}.{tag}.tmp"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
