"""Profile the port's real-image pipelines on one CUDA card.

    python tools/torch_patch_profile.py [--pipeline patch|analyze|transport|patch_sindy|improved_registration|
        comprehensive|sindy1d] [--full] [--out DIR]

``patch`` (the default) runs ``pdx_torch.pipelines.patch_discovery.run`` on
``bench.py``'s stack (``make_stack(51, 512, 640)`` as float64, skip 12,
subsample 6; ``--full``: the real dataset's 51 x 1024 x 1280 uint16 with the
default configuration), warms it up, then traces one run and one
registration flow. ``analyze`` and ``transport`` trace one warm run of
their pipeline at the real dataset's shape and default configuration
(``analyze`` reads the frames as 8-bit grayscale, as ``load_images(mode=
"grayscale_u8")`` does); ``transport`` also traces its pair flows and its
library + Lasso sweep alone. ``patch_sindy`` traces one warm run of each
registration schedule (``none``, ``ecc``, ``optical_flow`` per patch on the
compose path, ``optical_flow`` with frame scope) on the real dataset's shape
read as 8-bit and scaled by 1/255; ``improved_registration`` one warm run of
the default configuration on the uint16 stack, and one quality sweep alone.
``comprehensive`` traces ``simulate_clean`` over 1,000 of its Euler steps
(a full run's 10,000 would trace ~350k launches) and one regime's 21
methods (N7_all, default size); ``sindy1d`` one warm run of the default
configuration and one of ``varying_ic`` (default size). Tracing is ``torch.profiler`` (CPU and CUDA activities). Prints, per traced
window: the host wall, the CUDA kernels launched, their summed device time,
the device's busy and idle share of the wall, and the ten costliest
kernels; writes the Chrome trace of the one flow (patch) or of the sweep
(transport) to ``--out`` (default ``outputs/profile/``).
The profiler's own host cost inflates the traced walls. Fails without a
card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _window(label: str, fn, out_dir: Path | None, card: str) -> None:
    """Trace one warm call of fn; write its Chrome trace to out_dir if given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    trace = ""
    if out_dir is not None:
        path = out_dir / f"profile_{label}.json"
        prof.export_chrome_trace(str(path))
        trace = f", trace {path}"
    if not events:
        print(f"[profile] {label}: host wall {wall * 1e3:.3f} ms; device time not measured (no CUDA events) ({card})")
        return
    # one stream: device events (kernels, copies) overlap nothing, so their sum is the busy time
    print(f"[profile] {label}: host wall {wall * 1e3:.3f} ms, {len(events)} device events, device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / 1e6 / wall:.1f}% of the wall (idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f}%){trace} ({card})")
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    for name, ts in top:
        print(f"[profile]   {sum(ts) / 1e3:9.3f} ms in {len(ts):6d} launches: {name[:110]}")


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline", choices=["patch", "analyze", "transport", "patch_sindy", "improved_registration",
                                               "comprehensive", "sindy1d"], default="patch")
    parser.add_argument("--full", action="store_true", help="patch: the real dataset's shape instead of bench.py's stack")
    parser.add_argument("--out", default="outputs/profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_patch_profile.py: no CUDA card visible")
    from tools.make_synth_stack import make_stack

    from pdx_torch.pipelines import patch_discovery as pd
    from pdx_torch.register.farneback import _chain_step_flow

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    if args.pipeline == "comprehensive":
        from pdx_torch.pipelines import comprehensive as cr

        cfg = cr.ComprehensiveConfig(write_artifacts=False)
        _window("comprehensive_simulate_1000_steps",
                lambda: cr.simulate_clean(cr.ComprehensiveConfig(n_seconds=0.1), dev), None, card)
        U = cr.simulate_clean(cfg, dev)
        data = torch.as_tensor(cr.corruption_suite(U.cpu().numpy())["N7_all"]).to(dev)
        dx, dt_frame = cfg.Lx / cfg.Nx, cfg.dt * cfg.save_every
        methods = cr.build_methods(cfg, dx, dt_frame)
        _window("comprehensive_one_regime", lambda: cr._run_methods_batched(cfg, methods, data, dx, dt_frame),
                None, card)
        return 0
    if args.pipeline == "sindy1d":
        from pdx_torch.pipelines import sindy1d as s1

        for label, kw in (("default", {}), ("varying_ic", dict(scenario="varying_ic", regressor="stridge"))):
            cfg = s1.Sindy1dConfig(**kw)
            _window(f"sindy1d_{label}", lambda: s1.run(cfg, dev), None, card)
        return 0
    if args.pipeline == "analyze":
        from pdx_torch.pipelines import analyze as an

        U8 = (make_stack(T=51, H=1024, W=1280) >> 8).astype(np.uint8)
        U8.setflags(write=False)
        cfg = an.AnalyzeConfig(data_dir="unused", write_artifacts=False)
        _window("analyze_run", lambda: an.run(cfg, U_raw=U8, device=dev), None, card)
        return 0
    if args.pipeline == "patch_sindy":
        from pdx_torch.pipelines import patch_sindy as ps

        U = (make_stack(T=51, H=1024, W=1280) >> 8).astype(np.uint8) / 255.0
        U.setflags(write=False)
        for label, kw in (("none", {}), ("ecc", dict(registration_method="ecc")),
                          ("optical_flow", dict(registration_method="optical_flow")),
                          ("frame", dict(registration_method="optical_flow", flow_scope="frame"))):
            cfg = ps.PatchSindyConfig(data_dir="unused", write_artifacts=False, **kw)
            _window(f"patch_sindy_{label}", lambda: ps.run(cfg, U_raw=U, device=dev), None, card)
        return 0
    if args.pipeline == "improved_registration":
        from pdx_torch.io_host.images import device_stack
        from pdx_torch.pipelines import improved_registration as ir
        from pdx_torch.register.quality import mean_flow_magnitude

        U = make_stack(T=51, H=1024, W=1280)
        U.setflags(write=False)
        cfg = ir.ImprovedRegistrationConfig(data_dir="unused", write_artifacts=False)
        _window("improved_registration_run", lambda: ir.run(cfg, U_raw=U, device=dev), None, card)
        U64 = device_stack(U, torch.float64, device=dev)
        _window("improved_registration_quality_sweep", lambda: mean_flow_magnitude(U64), None, card)
        return 0
    if args.pipeline == "transport":
        from pdx_torch.io_host.images import device_stack
        from pdx_torch.pipelines import transport as tp

        U = make_stack(T=51, H=1024, W=1280)
        U.setflags(write=False)
        cfg = tp.TransportConfig(data_dir="unused", write_artifacts=False)
        _window("transport_run", lambda: tp.run(cfg, U_raw=U, device=dev), None, card)
        images = device_stack(U, torch.float64, device=dev)
        imgs_ds, imgs_n = tp._normalized_pairs_input(cfg, images / images.max())
        fu, fv = tp._pair_flows(cfg, imgs_n)
        alphas = torch.as_tensor(cfg.alphas, dtype=torch.float64, device=dev)
        _window("transport_pair_flows", lambda: tp._pair_flows(cfg, imgs_n), None, card)
        _window("transport_discover", lambda: tp._discover(
            imgs_ds, fu, fv, alphas, dt=cfg.dt, dx=cfg.dx, dy=cfg.dy, spatial_smooth=cfg.spatial_smooth), out_dir, card)
        return 0
    if args.full:
        U = make_stack(T=51, H=1024, W=1280)
        cfg = pd.PatchDiscoveryConfig(write_artifacts=False, data_dir="unused")
        label = "full"
    else:
        U = make_stack(T=51, H=512, W=640).astype(np.float64)
        cfg = pd.PatchDiscoveryConfig(write_artifacts=False, data_dir="unused", skip=12, subsample=6)
        label = "bench"
    U.setflags(write=False)
    _window(f"{label}_run", lambda: pd.run(cfg, U_raw=U, device=dev), None, card)  # its trace would be ~100 MB
    U_pre = pd.preprocess_head(cfg, U, dev)
    f32 = torch.float32
    _window(f"{label}_one_flow", lambda: _chain_step_flow(U_pre[0], U_pre[1], f32=f32, flow_ds=2, kw={"refine": 1}),
            out_dir, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
