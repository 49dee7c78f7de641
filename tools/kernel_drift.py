"""Time kernels K1-K4 of two trees of pdx_torch in one call on one card.

    python tools/kernel_drift.py OTHER_ROOT [--rounds 2]

OTHER_ROOT is an unpacked tree of another commit (for example
``git archive <commit> pdx_torch chip_smoke.py | tar -x -C build/other``).
Each round runs the other tree, then this one, then this one, then the
other, each in a fresh process that builds its own kernels (into
``<root>/build/pdx_torch``) and imports that tree's ``pdx_torch`` and
``chip_smoke``. A process times each kernel at (1999, 100, 100) float32
(3x8x8 blocks; K2 with p = 9 and p = 5, K4 with p = 9) through the wrapper
and as a bare launch (the tree's own ``chip_smoke._bare_launch`` on
preallocated buffers), each the median CUDA-event time of 15 calls after a
warm-up (``chip_smoke._time_ms``). Prints one line per process and a
median per tree and kernel, with the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TRUE = ("lap", "bih", "gradsq")
RICH = ("one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap")
ADV = ("lap", "bih", "gradsq", "ux", "uy")


def _time_tree(root: str) -> dict:
    """In this process: build ``root``'s kernels and time them."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from pdx_torch.ops.kernels import _build
    from pdx_torch.ops.kernels import fused_blockwise as kb
    from pdx_torch.ops.kernels import fused_gram as kg

    assert Path(cs.__file__).resolve().parent == Path(root).resolve(), cs.__file__
    lib = _build.library()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    shape, blocks = (1999, 100, 100), (3, 8, 8)
    U = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    Ut = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    kw3 = dict(block_t=3, block_x=8, block_y=8)
    wrappers = {
        ("fused_ks_gram", TRUE): lambda: kg.fused_ks_gram(U, Ut, dx=0.5, dy=0.5),
        ("fused_ks_gram_terms", RICH): lambda: kg.fused_ks_gram_terms(U, Ut, dx=0.5, dy=0.5, names=RICH),
        ("fused_ks_gram_terms", ADV): lambda: kg.fused_ks_gram_terms(U, Ut, dx=0.5, dy=0.5, names=ADV),
        ("fused_blockwise_gram", TRUE): lambda: kb.fused_blockwise_gram(U, Ut, dx=0.5, dy=0.5, **kw3),
        ("fused_blockwise_gram_terms", RICH): lambda: kb.fused_blockwise_gram_terms(
            U, Ut, dx=0.5, dy=0.5, names=RICH, **kw3),
    }
    out = {}
    for (name, names), wrap in wrappers.items():
        bare = cs._bare_launch(name, lib, kg, kb, U, Ut, names, blocks)
        out[f"{name} p={len(names)}"] = {"wrapper_ms": cs._time_ms(wrap), "bare_ms": cs._time_ms(bare)}
    return {"root": root, "sources": _build.source_hash(), "times": out}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--time"]:
        print(json.dumps(_time_tree(argv[1])))
        return 0
    other = str(Path(argv[0]).resolve())
    rounds = int(argv[argv.index("--rounds") + 1]) if "--rounds" in argv else 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    runs = {other: [], str(HERE): []}
    for _ in range(rounds):
        for root in (other, str(HERE), str(HERE), other):
            proc = subprocess.run([sys.executable, __file__, "--time", root], capture_output=True, text=True,
                                  timeout=600, cwd=root)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"timing {root} failed (rc {proc.returncode})")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[root].append(res)
            print(f"[drift] {root} (sources {res['sources']}): " + ", ".join(
                f"{k} wrapper {v['wrapper_ms']:.4f} ms bare {v['bare_ms']:.4f} ms" for k, v in res["times"].items()
            ) + f" ({card})", flush=True)
    for root, rs in runs.items():
        for k in rs[0]["times"]:
            w = statistics.median(r["times"][k]["wrapper_ms"] for r in rs)
            b = statistics.median(r["times"][k]["bare_ms"] for r in rs)
            print(f"[drift] median of {len(rs)} processes, {root}: {k} wrapper {w:.4f} ms, bare {b:.4f} ms ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
