"""Host-side image ingestion (port of ``pdx/io_host/images.py``).

Loads a sorted ``*.tif`` stack (at most ``max_images`` frames) as a
(T, H, W) array: uncompressed grayscale TIFFs through a minimal raw decoder,
anything else through cv2 or PIL, and a ``.npy`` stack when the folder holds
no TIFF. Decoded stacks are cached on disk and in the process; a stack
shipped to the card is cached too (:func:`device_stack`).

Unlike ``pdx``, no environment variable steers the caches: ``load_images``
takes ``cache`` and ``cache_dir`` arguments.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np
import torch

from pdx_torch.utils.hostmem import huge_empty

try:  # host-side decode backends, best-effort
    import cv2  # type: ignore
except Exception:  # pragma: no cover
    cv2 = None

try:
    from PIL import Image  # type: ignore
except Exception:  # pragma: no cover
    Image = None


def _fast_tiff_gray(path: Path) -> np.ndarray | None:
    """Minimal raw decoder for the TIFF layout lab cameras (and cv2/PIL
    writers) emit: uncompressed, single-plane grayscale, 8- or 16-bit
    unsigned, strip-organised. Returns None for anything else, so the
    caller falls back to cv2 / PIL. Reading the strip bytes and viewing them
    as an (H, W) array costs milliseconds where a general decoder costs
    tenths of a second a frame."""
    import struct

    try:
        b = path.read_bytes()
        if b[:2] == b"II":
            bo = "<"
        elif b[:2] == b"MM":
            bo = ">"
        else:
            return None
        magic, ifd = struct.unpack_from(bo + "HI", b, 2)
        if magic != 42:
            return None
        (n_tags,) = struct.unpack_from(bo + "H", b, ifd)
        tags: dict[int, tuple[int, int, int]] = {}
        for i in range(n_tags):
            tag, typ, cnt = struct.unpack_from(bo + "HHI", b, ifd + 2 + i * 12)
            tags[tag] = (typ, cnt, ifd + 2 + i * 12 + 8)

        def read_vals(tag: int, default=None) -> list[int] | None:
            if tag not in tags:
                return default
            typ, cnt, field = tags[tag]
            fmt, size = {3: ("H", 2), 4: ("I", 4)}.get(typ, (None, None))
            if fmt is None:
                return None
            # values are left-justified in the 4-byte field; larger arrays
            # live at the offset the field holds
            pos = field if cnt * size <= 4 else struct.unpack_from(bo + "I", b, field)[0]
            return list(struct.unpack_from(bo + fmt * cnt, b, pos))

        def one(tag: int, default=None) -> int | None:
            v = read_vals(tag, None if default is None else [default])
            return None if not v else v[0]

        w, h = one(256), one(257)
        bits = one(258, 8)
        if (
            w is None or h is None
            or one(259, 1) != 1          # uncompressed only
            or one(262, 1) != 1          # BlackIsZero grayscale only
            or one(277, 1) != 1          # single sample/px
            or one(284, 1) != 1          # chunky planar
            or one(339, 1) != 1          # unsigned int samples
            or bits not in (8, 16)
        ):
            return None
        offsets = read_vals(273)
        counts = read_vals(279)
        if not offsets or not counts or len(offsets) != len(counts):
            return None
        nbytes = h * w * (bits // 8)
        if sum(counts) != nbytes:
            return None
        if len(offsets) == 1:
            raw = b[offsets[0] : offsets[0] + nbytes]
        else:
            raw = b"".join(b[o : o + c] for o, c in zip(offsets, counts))
        dt = np.dtype("u2" if bits == 16 else "u1").newbyteorder(bo)
        return np.frombuffer(raw, dtype=dt).reshape(h, w)
    except Exception:
        return None

def write_tiff(path, frame) -> None:
    """One uncompressed, single-strip, little-endian grayscale TIFF of an
    (H, W) uint8 or uint16 frame: the baseline layout lab cameras write and
    :func:`_fast_tiff_gray` decodes (no PIL or cv2 needed)."""
    import struct

    frame = np.ascontiguousarray(frame)
    if frame.ndim != 2 or frame.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"an (H, W) uint8 or uint16 frame, got {frame.shape} {frame.dtype}")
    h, w = frame.shape
    data = frame.astype(frame.dtype.newbyteorder("<"), copy=False).tobytes()
    SHORT, LONG = 3, 4
    tags = [(256, LONG, w), (257, LONG, h), (258, SHORT, 8 * frame.itemsize), (259, SHORT, 1), (262, SHORT, 1),
            (273, LONG, 0), (277, SHORT, 1), (278, LONG, h), (279, LONG, len(data)), (284, SHORT, 1)]
    offset = 8 + 2 + 12 * len(tags) + 4  # header, IFD, then the strip
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", tag, typ, 1, offset if tag == 273 else value) for tag, typ, value in tags)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8) + ifd + struct.pack("<I", 0) + data)


def write_tiff_stack(folder, U) -> None:
    """Frames of U as folder/frame_000.tif, frame_001.tif, ... (sorted names)."""
    Path(folder).mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(U):
        write_tiff(Path(folder) / f"frame_{i:03d}.tif", frame)


def _read_gray(path: Path) -> np.ndarray | None:
    img = _fast_tiff_gray(path)
    if img is not None:
        return img
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if img is None:
            return None
        if img.ndim == 3:
            if img.shape[2] == 4:
                img = cv2.cvtColor(img, cv2.COLOR_BGRA2GRAY)
            else:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img
    if Image is not None:
        with Image.open(path) as im:
            return np.asarray(im.convert("L"))
    raise RuntimeError("no image decode backend available (cv2/PIL)")


# In-process decoded-stack cache, keyed like the disk cache (content key),
# at most a handful of stacks. Entries are published read-only: every later
# hit aliases the same array, so a caller mutating it would corrupt them.
_MEM_CACHE: dict[str, np.ndarray] = {}
_MEM_CACHE_CAP = 4

# Stacks already shipped to a device: (id, dtype, device) -> (array, tensor).
# The entry holds the array itself, so its id cannot be reused while the
# entry lives, and a hit must be that very array (``is``). Only read-only
# arrays are cached: a writable one may change after it was shipped.
_DEVICE_STACK: dict[tuple, tuple[np.ndarray, torch.Tensor]] = {}
_DEVICE_STACK_CAP = 2


def clear_stack_memcache() -> None:
    """Drop the in-process stack caches (host and device), so that a cold
    timing includes the real load and transfer."""
    _MEM_CACHE.clear()
    _DEVICE_STACK.clear()


def device_stack(
    U_raw: np.ndarray, dtype: torch.dtype | None = None, device: str | torch.device = "cpu"
) -> torch.Tensor:
    """``U_raw`` as a tensor on ``device`` (cast to ``dtype`` if given). A
    read-only array shipped before is not shipped again: the cached tensor
    is returned only for the same array object, whose id cannot have been
    reused because the cache holds it."""
    device = torch.device(device)
    key = (id(U_raw), dtype, device)
    hit = _DEVICE_STACK.get(key)
    if hit is not None and hit[0] is U_raw:
        return hit[1]
    with warnings.catch_warnings():  # a read-only array is only read here
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        t = torch.as_tensor(U_raw).to(device)
    if dtype is not None:
        t = t.to(dtype)
    if not U_raw.flags.writeable:
        while len(_DEVICE_STACK) >= _DEVICE_STACK_CAP:
            _DEVICE_STACK.pop(next(iter(_DEVICE_STACK)))
        _DEVICE_STACK[key] = (U_raw, t)
    return t


def _default_cache_dir() -> Path:
    return Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache") / "pdx_torch" / "stacks"


def _cache_key(files: list[Path], mode: str, dtype) -> str:
    """Content key over the exact decode inputs: per-file (name, size,
    mtime_ns) plus decode mode and dtype. A touched or replaced frame
    changes the key, so a stale entry is never returned."""
    h = hashlib.sha1()
    h.update(f"{mode}|{np.dtype(dtype).str}".encode())
    for f in files:
        st = f.stat()
        h.update(f"|{f}|{st.st_size}|{st.st_mtime_ns}".encode())
    return h.hexdigest()


def _cache_load(cache_dir: Path, key: str) -> np.ndarray | None:
    path = cache_dir / f"{key}.npy"
    if not path.exists():
        return None
    try:
        # memory-mapped: the first touch (usually the device transfer)
        # streams it, instead of an eager copy up front
        return np.load(path, mmap_mode="r")
    except Exception:  # truncated or corrupt entry: decode again
        return None


def _cache_store(cache_dir: Path, key: str, stack: np.ndarray) -> None:
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
        # atomic publish: a crash mid-write never leaves a readable
        # half-entry under the final name
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.save(fh, stack)
            os.replace(tmp, cache_dir / f"{key}.npy")
        except BaseException:
            os.unlink(tmp)
            raise
    except Exception:  # the cache is best-effort; the decoded stack is in hand
        pass


_PENDING_STORES: list[threading.Thread] = []


def _store_async(cache_dir: Path, key: str, stack: np.ndarray) -> None:
    t = threading.Thread(target=_cache_store, args=(cache_dir, key, stack), daemon=True)
    t.start()
    _PENDING_STORES.append(t)


def flush_stack_cache_writes(timeout: float | None = None) -> None:
    """Join pending background disk-cache writes."""
    while _PENDING_STORES:
        _PENDING_STORES.pop().join(timeout)


def _mem_publish(key: str, stack: np.ndarray) -> np.ndarray:
    """Insert into the in-process cache (first in, first out) and return
    the entry read-only."""
    stack.setflags(write=False)
    while len(_MEM_CACHE) >= _MEM_CACHE_CAP:
        _MEM_CACHE.pop(next(iter(_MEM_CACHE)))
    _MEM_CACHE[key] = stack
    return stack


def load_images(
    folder: str | Path,
    *,
    max_images: int = 51,
    pattern: str = "*.tif",
    mode: str = "unchanged",  # unchanged | grayscale_u8
    dtype=np.float32,
    cache: bool = True,
    cache_dir: str | Path | None = None,
) -> np.ndarray:
    """Load a sorted image stack as a (T, H, W) array.

    ``mode="grayscale_u8"`` matches cv2's IMREAD_GRAYSCALE (16-bit frames
    lose their low byte); ``"unchanged"`` reads the frames as they are, with
    colour converted to gray.

    An integer ``dtype`` is a transfer-size hint: it is honoured when the
    decoded frames are integers that fit, and float32 is used otherwise.

    ``cache=True`` (default) keeps the decoded stack on disk under
    ``cache_dir`` (default ``$XDG_CACHE_HOME/pdx_torch/stacks``, or
    ``~/.cache/...``), keyed by the file list, sizes, mtimes, mode and dtype,
    and in the process; a hit is returned read-only. ``cache=False`` decodes
    every time and returns a writable array.
    """
    folder = Path(folder)
    files = sorted(folder.glob(pattern))[: int(max_images)]
    if not files:
        npy = sorted(folder.glob("*.npy"))
        if npy:
            U = np.load(npy[0])
            req = np.dtype(dtype)
            if np.issubdtype(req, np.integer) and not np.can_cast(U.dtype, req, "safe"):
                req = np.dtype(np.float32)
            return U[: int(max_images)].astype(req)
        raise FileNotFoundError(f"No {pattern} files found in: {folder}")

    cdir = Path(cache_dir) if cache_dir is not None else _default_cache_dir()
    key = _cache_key(files, mode, dtype) if cache else None
    if key is not None:
        if key in _MEM_CACHE:
            return _MEM_CACHE[key]
        hit = _cache_load(cdir, key)
        if hit is not None:
            if hit.dtype != np.dtype(dtype) and np.can_cast(hit.dtype, np.dtype(dtype), "safe"):
                hit = hit.astype(dtype)
            return _mem_publish(key, hit)

    def read_one(f: Path) -> np.ndarray | None:
        if mode == "grayscale_u8":
            img = _fast_tiff_gray(f)
            if img is not None:
                return (img >> 8).astype(np.uint8) if img.dtype.itemsize == 2 else img
            if cv2 is not None:
                return cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)
        return _read_gray(f)

    # sequential decode, each frame cast-assigned into one preallocated block
    out: np.ndarray | None = None
    kept = 0
    for f in files:
        img = read_one(f)
        if img is None:
            continue
        if out is None:
            store_dtype = np.dtype(dtype)
            if np.issubdtype(store_dtype, np.integer) and not np.can_cast(img.dtype, store_dtype, "safe"):
                store_dtype = np.dtype(np.float32)
            out = huge_empty((len(files),) + img.shape, store_dtype)
        elif np.issubdtype(out.dtype, np.integer) and not np.can_cast(img.dtype, out.dtype, "safe"):
            # a later frame no longer fits the integer block: widen what is stored
            widened = huge_empty(out.shape, np.float32)
            widened[:kept] = out[:kept]
            out = widened
        out[kept] = img
        kept += 1
    if out is None or kept == 0:
        raise RuntimeError("no readable images found in the data directory")
    out = out[:kept]
    if key is not None:
        out = _mem_publish(key, out)
        _store_async(cdir, key, out)  # the caller never waits on the disk
    return out


def list_image_resolutions(folder: str | Path, pattern: str = "*.tif") -> dict[tuple[int, int], int]:
    """Size histogram of an image folder."""
    folder = Path(folder)
    hist: dict[tuple[int, int], int] = {}
    for f in sorted(folder.glob(pattern)):
        img = _read_gray(f)
        if img is None:
            continue
        key = (int(img.shape[0]), int(img.shape[1]))
        hist[key] = hist.get(key, 0) + 1
    return hist
