"""CUDA graphs of fixed-shape steps, replayed by the host.

A loop whose every step queues hundreds of small kernels waits on one host
core's launch rate. :class:`StepGraph` captures one step, a function of
fixed-shape tensors, as a CUDA graph: a replay copies the inputs into the
graph's own buffers, launches the graph once and leaves the result in the
graph's output buffer. The kernels and their order are the step's own.

A capture keeps what its kernels read. The step's helpers build their
device constants once and keep them in caches (:func:`constant_cache`);
the graph holds its own reference to each constant it was captured with,
so a cache that drops one frees nothing the graph still reads. Counts the
step adds to the tracer while it is captured are held, not counted (the
capture computes nothing), and each replay counts them as a step would.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor

from pdx_torch.utils.profiling import count, held_counts

_keeping: list[dict] = []  # the constants of the captures open now


def constant_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a helper that builds device
    constants: what it returns while a :class:`StepGraph` captures is kept
    by that graph."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            value = cached(*args)
            for kept in _keeping:
                kept[id(value)] = value
            return value

        return get

    return wrap


class StepGraph:
    """``step(*inputs)`` captured once, on the current device, for inputs of
    the shapes and dtypes of ``like``. The step must read the host for shapes
    alone and find its constants cached: run it eagerly once first."""

    def __init__(self, step, *like: Tensor) -> None:
        self.inputs = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in like]
        self.graph = torch.cuda.CUDAGraph()
        self.constants: dict[int, object] = {}
        _keeping.append(self.constants)
        try:
            with held_counts() as self.counts, torch.cuda.graph(self.graph):
                self.output = step(*self.inputs)
        finally:
            _keeping.remove(self.constants)

    def replay(self, *inputs: Tensor) -> Tensor:
        """The step on ``inputs``, on the current stream; the result is the
        graph's output buffer, which the next replay overwrites."""
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        for name, n in self.counts.items():
            count(name, n)
        return self.output
