"""Content-hash render cache for matplotlib figure generators (port of
``pdx/report/render_cache.py``, a copy: host code in both packages).

Figure rendering is pure host work and, on a warm pipeline re-run, its
inputs are byte-identical — the same contract JSON, the same error maps.
This memo keys each figure (set) on a digest of its *data inputs* and, on a
hit, copies the previously rendered file(s) instead of re-drawing (a PNG
copy is ~ms; a 12-savefig FIG4 sweep is seconds).

In-process only, by design: a fresh process re-renders everything, and a
hit can only come from a render this process already produced, so cached
artifacts are always byte-exact for the inputs. When the recorded source
files have been deleted, the entry is dropped and the figures render
normally.
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path
from typing import Callable, Sequence

_memo: dict[str, list[Path]] = {}


def _digest(tag: str, key_parts: Sequence) -> str:
    h = hashlib.blake2b(tag.encode(), digest_size=16)
    for part in key_parts:
        if isinstance(part, bytes):
            b = part
        elif hasattr(part, "tobytes"):  # ndarray and friends
            b = part.tobytes()
        else:
            b = repr(part).encode()
        h.update(hashlib.blake2b(b, digest_size=16).digest())
    return h.hexdigest()


def cached_render(
    tag: str,
    key_parts: Sequence,
    out_paths: Sequence[Path],
    render: Callable[[], None],
) -> list[Path]:
    """Run ``render`` (which must write exactly ``out_paths``) unless an
    identical render already happened this process — then copy its files."""
    out_paths = [Path(p) for p in out_paths]
    digest = _digest(tag, key_parts)
    src = _memo.get(digest)
    if src is not None and all(p.exists() for p in src):
        if [str(p) for p in src] != [str(p) for p in out_paths]:
            for s, d in zip(src, out_paths):
                d.parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(s, d)
        _memo[digest] = out_paths
        return out_paths
    render()
    _memo[digest] = out_paths
    return out_paths


def clear_render_memo() -> None:
    _memo.clear()
