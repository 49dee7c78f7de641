"""Run one cell of the pdx_torch benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output (see ``benchmark/README.md``); exits non-zero without a
result when no CUDA card is visible.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main() -> int:
    t_start = time.perf_counter() - _process_age_s()
    root = Path(__file__).resolve().parent.parent
    # every build and kernel cache at a fixed path inside the checkout
    cache = root / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(root))
    from benchmark import harness

    return harness.run(sys.argv[1:], process_start=t_start)


if __name__ == "__main__":
    sys.exit(main())
