"""Device mesh and sharded Gram reduction (port of ``pdx/shard/mesh.py``).

The workload's parallel axes: samples (data-parallel Gram accumulation
reduced over the mesh), patches, methods and hyperparameter grid points
(independent batched solves split over the mesh), and test functions (the
weak form's projections).

``pdx`` is one controller: ``jit`` follows its inputs' placement and XLA
inserts the ``psum``. The port does the same explicitly, in one process:

* a mesh is an ordered list of devices; a device may appear more than once
  ("virtual shards", the counterpart of the virtual CPU devices ``pdx``'s
  tests run on), so one card or the CPU can hold a mesh of any size;
* a sharded tensor is the list of its per-device chunks of the leading
  axis, in mesh order (:func:`shard_batch`);
* :func:`map_shards` runs a function on each shard on that shard's device
  (on CUDA, each launch queues on its card without waiting for the others);
  :func:`gather_leading` concatenates the results on the mesh's first
  device, in order;
* a reduction moves each shard's partial result to the first device and
  sums the partials in mesh order, with no atomics: the result repeats bit
  for bit.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import Tensor

from pdx_torch import resolve_device
from pdx_torch.ops.linalg import gram_stats


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: its devices in order, and the name of its axis."""

    devices: tuple[torch.device, ...]
    axis_name: str = "data"

    def __len__(self) -> int:
        return len(self.devices)

    def slot_name(self, i: int) -> str:
        """Slot ``i``'s device, and ``#i`` after it where the mesh names that
        device more than once (a virtual shard)."""
        dev = self.devices[i]
        return f"{dev}#{i}" if self.devices.count(dev) > 1 else str(dev)


def _index(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` -> ``cuda:<current>``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_devices: int | None = None, axis_name: str = "data", devices: list | tuple | None = None
) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA card; without one this raises, never the CPU unless asked).
    ``devices`` may name one device more than once: ``make_mesh(devices=
    ["cpu"] * 8)`` is a mesh of 8 virtual shards of the CPU."""
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [_index(resolve_device(d)) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} devices asked for, {len(devs)} available")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs), axis_name)


def default_mesh(device: str | torch.device) -> Mesh:
    """The pipelines' default: on a CUDA device every visible card, that
    device first (so results land on it); on the CPU that one device."""
    dev = _index(resolve_device(device))
    if dev.type != "cuda":
        return make_mesh(devices=[dev])
    return make_mesh(devices=[dev] + [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                                      if i != dev.index])


def shard_batch(x: Tensor, mesh: Mesh) -> list[Tensor]:
    """``x``'s leading axis split into ``len(mesh)`` equal chunks, chunk i on
    the mesh's device i. Raises if the axis does not divide, as placing an
    array with a ``NamedSharding`` does."""
    n = len(mesh)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over {n} devices")
    return [c.to(d) for c, d in zip(torch.chunk(x, n), mesh.devices)]


def maybe_shard_leading(
    arrs: tuple[Tensor, ...], mesh_mode: str = "auto", mesh: Mesh | None = None
) -> tuple[tuple, int]:
    """Shard the common leading (patch / member / grid) axis over the mesh.

    Shards when ``mesh_mode == 'on'``, or ``'auto'`` with more than one
    device in the mesh (default: :func:`make_mesh`); never with fewer than
    two. Pads to a device-count multiple by repeating the final slice:
    callers slice results back to the returned original length, so padding
    never changes results. The no-op returns ``arrs`` itself (no copy).
    Returns (arrays, or lists of their shards; original leading length)."""
    mesh = make_mesh() if mesh is None else mesh
    n_dev = len(mesh)
    P0 = int(arrs[0].shape[0])
    use = mesh_mode == "on" or (mesh_mode == "auto" and n_dev > 1)
    if not use or n_dev < 2:
        return arrs, P0
    pad = (-P0) % n_dev
    out = []
    for a in arrs:
        if pad:
            a = torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
        out.append(shard_batch(a, mesh))
    return tuple(out), P0


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def map_shards(fn: Callable, arrs: tuple, mesh: Mesh) -> list:
    """``fn`` on each shard of ``arrs`` (lists of shards from
    :func:`maybe_shard_leading` or :func:`shard_batch`), on that shard's
    device: the list of per-shard results, in mesh order. Tensors that were
    not sharded (the no-op) give the one result ``[fn(*arrs)]``. A shard
    that raises raises here."""
    if isinstance(arrs[0], Tensor):
        return [fn(*arrs)]
    parts = []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            parts.append(fn(*(a[i] for a in arrs)))
    return parts


def _tree_map(f: Callable, parts: list) -> Any:
    """``f`` over the list of matching leaves of equally structured results
    (tensors, or tuples, lists and dicts of them)."""
    first = parts[0]
    if isinstance(first, Tensor):
        return f(parts)
    if isinstance(first, dict):
        return {k: _tree_map(f, [p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(f, [p[i] for p in parts]) for i in range(len(first)))
    raise TypeError(f"cannot gather a result of type {type(first).__name__}")


def gather_leading(parts: list, mesh: Mesh) -> Any:
    """Per-shard results (from :func:`map_shards`) concatenated along the
    leading axis on the mesh's first device, in mesh order. One part is
    returned as it is."""
    if len(parts) == 1:
        return parts[0]
    dev0 = mesh.devices[0]
    return _tree_map(lambda ts: torch.cat([t.to(dev0) for t in ts]), parts)


def _sum_partials(parts: list, mesh: Mesh) -> Any:
    """Per-shard partial results summed on the mesh's first device, in mesh
    order (the explicit ``psum``; no atomics, repeatable bit for bit)."""
    dev0 = mesh.devices[0]

    def total(ts: list[Tensor]) -> Tensor:
        acc = ts[0].to(dev0)
        for t in ts[1:]:
            acc = acc + t.to(dev0)
        return acc

    return _tree_map(total, parts)


def sharded_gram_stats(
    X: Tensor | list[Tensor], y: Tensor | list[Tensor], mesh: Mesh, weights: Tensor | list[Tensor] | None = None
) -> dict[str, Tensor]:
    """Gram sufficient statistics with the sample axis sharded over the mesh.

    Each shard computes its local :func:`pdx_torch.ops.linalg.gram_stats`
    (X_i^T W_i X_i, X_i^T W_i y_i, ...) on its device; the partials are
    summed on the mesh's first device in mesh order: O(p^2) bytes move.
    ``X``, ``y`` and ``weights`` are tensors (sharded here) or lists of
    their shards. ``weights`` (0/1 rows) lets callers zero-pad to a
    device-count multiple with exact statistics: padding rows contribute
    nothing, the row count ``n`` included."""
    X, y = (shard_batch(a, mesh) if isinstance(a, Tensor) else a for a in (X, y))
    if weights is None:
        weights = [torch.ones(Xl.shape[0], dtype=Xl.dtype, device=Xl.device) for Xl in X]
    elif isinstance(weights, Tensor):
        weights = shard_batch(weights, mesh)
    return _sum_partials(map_shards(gram_stats, (X, y, weights), mesh), mesh)
