"""What the port's ``gpu`` tests share: the card, the kernels' launch
counts, and stacks of the real dataset's shape (51 x 1024 x 1280 uint16,
``tools/make_synth_stack.make_stack``), made once a process and only when a
card is present, so that without one the tests skip at once.

Run every ``gpu`` test on the card with
``python -m pytest --noconftest -q -m gpu tests/test_torch_*.py``
(``python3 chip_smoke.py`` does, after building the kernels).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import pytest
import torch

from pdx_torch.utils.profiling import total

# the wrappers of kernels K1-K4, of the Farnebäck flow's windowed passes and of the DIS flow's
# per-level passes; each counts `<wrapper>.launches`
GRAM_KERNELS = ("fused_ks_gram", "fused_ks_gram_terms", "fused_blockwise_gram", "fused_blockwise_gram_terms")
FLOW_KERNELS = ("poly_expansion", "warped_poly_expansion", "flow_update", "window_blur")
DIS_KERNELS = ("dis_inverse_search", "dis_densify")


def card() -> torch.device:
    """The first CUDA card; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def cuda() -> torch.device:
    """:func:`card` as a fixture (a test file imports it by name)."""
    return card()


@functools.cache
def _full_stack() -> np.ndarray:
    from tools.make_synth_stack import make_stack

    U = make_stack(T=51, H=1024, W=1280)
    U.setflags(write=False)  # a read-only stack is shipped to the card once (io_host.images.device_stack)
    return U


def full_stack() -> np.ndarray:
    """The real dataset's shape, 51 x 1024 x 1280 uint16 (read-only)."""
    card()
    return _full_stack()


@functools.cache
def _full_u8() -> np.ndarray:
    U = (_full_stack() >> 8).astype(np.uint8)  # what load_images(mode="grayscale_u8") makes of 16-bit frames
    U.setflags(write=False)
    return U


def full_u8() -> np.ndarray:
    """:func:`full_stack` read as 8-bit grayscale (read-only)."""
    card()
    return _full_u8()


def full_f255() -> np.ndarray:
    """:func:`full_stack` read as 8-bit and scaled by 1/255, as
    patch_sindy's TIFF path reads frames (read-only)."""
    U = full_u8() / 255.0
    U.setflags(write=False)
    return U


@contextlib.contextmanager
def launches(names=GRAM_KERNELS + FLOW_KERNELS, counters=()):
    """A dict filled on exit with each wrapper's launches inside the block,
    and with how far each of ``counters`` (full names) moved."""
    keys = {n: f"{n}.launches" for n in names} | {c: c for c in counters}
    base = {k: total(c) for k, c in keys.items()}
    moved: dict[str, int] = {}
    yield moved
    moved.update({k: total(c) - base[k] for k, c in keys.items()})


def assert_no_gram_kernel(moved: dict) -> None:
    """None of K1-K4 launched (every path but ks2d_bench's kernel solvers)."""
    assert not any(moved[n] for n in GRAM_KERNELS), moved


def assert_flow_kernels(moved: dict, needs=FLOW_KERNELS) -> None:
    """Each of ``needs`` launched: no main path's flow left plain."""
    assert all(moved[n] > 0 for n in needs), moved


def motion(U) -> float:
    """Residual motion of a stack: RMS of frame-to-previous differences
    along the axis before the frames' two."""
    return float(torch.sqrt(torch.mean((U[..., 1:, :, :] - U[..., :-1, :, :]) ** 2)))


def all_finite(values) -> bool:
    return all(math.isfinite(float(v)) for v in values)
