#!/usr/bin/env python3
"""The port's check on one CUDA card (``python3 chip_smoke.py``). Exits
non-zero without a card; waits once, at most 700 s, for the check's peak
memory to be free on the card (another process may hold it); builds the
kernels; runs every ``gpu`` test, ``python -m pytest --noconftest -q -m gpu
tests/test_torch_*.py``, and exits with pytest's code. The last line is
``{"ok": ..., "device": {...}}``. Speed is the benchmark's, not this check's.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_GIB = 20  # the largest test, the registration study at full size, reserves ~18.4 GiB


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA card visible; this check runs only on the GPU")
    deadline = time.monotonic() + 700
    while torch.cuda.mem_get_info(0)[0] < PEAK_GIB * 2**30 and time.monotonic() < deadline:
        time.sleep(5)
    from pdx_torch.ops.kernels import _build

    _build.library()
    root = Path(__file__).resolve().parent
    tests = sorted(str(p.relative_to(root)) for p in (root / "tests").glob("test_torch_*.py"))
    rc = subprocess.call([sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "gpu", *tests], cwd=root)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": rc == 0, "device": device}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
