"""Per-stage wall-clock timer (port of ``pdx/utils/profiling.py:17-76``).

``with timer.stage("name"):`` adds the stage's seconds to ``timer.stages``.
The timer waits for the CUDA card at the end of each stage, so a stage's
time includes the device work it queued, not only its launches. Without a
timer the pipelines use :func:`null_stage`, which waits for nothing.
"""

from __future__ import annotations

import contextlib
import time

import torch


class StageTimer:
    """Accumulates named stage durations, each ended by a device synchronize."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}  # in the order the stages first ran

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{'stage':<28}{'seconds':>10}{'share':>8}"]
        for name, dt in self.stages.items():
            lines.append(f"{name:<28}{dt:>10.4f}{dt / max(total, 1e-12):>8.1%}")
        lines.append(f"{'total':<28}{total:>10.4f}")
        return "\n".join(lines)


_NULL_STAGE = contextlib.nullcontext()


def null_stage(*_args, **_kwargs):
    """Stage no-op for runs without a timer."""
    return _NULL_STAGE
