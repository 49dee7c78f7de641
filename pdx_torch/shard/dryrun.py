"""One sharded discovery step over an n-slot mesh, every parallel axis once
(port of ``__graft_entry__.dryrun_multichip``).

    from pdx_torch.shard.dryrun import dryrun_multichip
    dryrun_multichip(8, "cpu")     # 8 virtual shards of the CPU
    dryrun_multichip(4, "cuda")    # 4 cards if there are, else 4 virtual shards of cuda:0

Axes, at tiny shapes:
  1. the sample-sharded Gram (partials summed on the first device), then
     STRidge;
  2. patch-sharded batched STRidge;
  3. the alpha axis of ``stridge_grid`` split over the mesh;
  4. the production patch ensemble with ``mesh="on"``;
  5. the weak form's test-function projections split over the mesh;
  6. the ``comprehensive`` regime round-robin.
Each raises on a wrong result or a wrong split.
"""

from __future__ import annotations

import numpy as np
import torch

from pdx_torch import resolve_device
from pdx_torch.ops.linalg import gram_stats
from pdx_torch.shard.mesh import Mesh, gather_leading, make_mesh, map_shards, shard_batch, sharded_gram_stats
from pdx_torch.solve.stridge import stridge_from_stats, stridge_grid


def dryrun_mesh(n_devices: int, device: str | torch.device = "cuda") -> Mesh:
    """``n_devices`` distinct cards when ``device`` is CUDA and that many are
    visible, else ``n_devices`` virtual shards of ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return make_mesh(n_devices)
    return make_mesh(devices=[dev] * n_devices)


def _check_split(label: str, parts: list, mesh: Mesh, rows: int) -> None:
    """The result came back as one part a slot, each on its slot's device
    with ``rows`` leading rows: the axis was split, not gathered."""
    if len(parts) != len(mesh):
        raise AssertionError(f"{label}: {len(parts)} part(s) for a {len(mesh)}-slot mesh")
    for part, dev in zip(parts, mesh.devices):
        if part.device != dev or part.shape[0] != rows:
            raise AssertionError(f"{label}: part on {part.device} with {part.shape[0]} rows, "
                                 f"expected {dev} and {rows}")


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> dict:
    """Every sharded axis once over :func:`dryrun_mesh` (``n_devices``,
    ``device``); returns a summary (the mesh, the shards of each axis)."""
    mesh = dryrun_mesh(n_devices, device)
    n = len(mesh)
    dev0 = mesh.devices[0]
    rng = np.random.default_rng(0)
    p = 8
    X = torch.as_tensor(rng.normal(size=(128 * n, p)), dtype=torch.float32, device=dev0)
    true_c = torch.as_tensor(rng.normal(size=p), dtype=torch.float32, device=dev0)
    y = X @ true_c

    # axis 1: data-parallel Gram (partials summed in mesh order) + STRidge
    stats = sharded_gram_stats(shard_batch(X, mesh), shard_batch(y, mesh), mesh)
    coeffs = stridge_from_stats(stats, alpha=1e-6, threshold=1e-8).coeffs.cpu().numpy()
    if not np.all(np.isfinite(coeffs)):
        raise AssertionError(f"axis 1: coefficients not finite: {coeffs}")
    np.testing.assert_allclose(coeffs, true_c.cpu().numpy(), rtol=1e-2, atol=1e-3, err_msg="axis 1")

    # axis 2: patch-sharded batched STRidge
    n_patches = 2 * n
    Xp = torch.as_tensor(rng.normal(size=(n_patches, 256, p)), dtype=torch.float32, device=dev0)
    yp = torch.einsum("bnp,p->bn", Xp, true_c)
    parts = map_shards(
        lambda Xi, yi: stridge_from_stats(gram_stats(Xi, yi), alpha=1e-6, threshold=1e-8).coeffs,
        (shard_batch(Xp, mesh), shard_batch(yp, mesh)), mesh,
    )
    _check_split("axis 2 (patches)", parts, mesh, n_patches // n)
    patch_coeffs = gather_leading(parts, mesh).cpu().numpy()
    if patch_coeffs.shape != (n_patches, p) or not np.all(np.isfinite(patch_coeffs)):
        raise AssertionError(f"axis 2: bad patch coefficients, shape {patch_coeffs.shape}")
    np.testing.assert_allclose(patch_coeffs, np.tile(true_c.cpu().numpy(), (n_patches, 1)),
                               rtol=5e-2, atol=5e-3, err_msg="axis 2")

    # axis 3: the alpha axis of the grid over the replicated statistics
    n_grid = 2 * n
    alphas = torch.logspace(-8, -1, n_grid, dtype=torch.float32, device=dev0)
    thresholds = torch.tensor([1e-8, 1e-3], dtype=torch.float32)

    def grid(a: torch.Tensor) -> torch.Tensor:
        local = {k: v.to(a.device) for k, v in stats.items()}
        return stridge_grid(local, a, thresholds.to(a.device))[0]

    parts = map_shards(grid, (shard_batch(alphas, mesh),), mesh)
    _check_split("axis 3 (alpha grid)", parts, mesh, n_grid // n)
    cg = gather_leading(parts, mesh).cpu().numpy()
    if cg.shape != (n_grid, 2, p) or not np.all(np.isfinite(cg)):
        raise AssertionError(f"axis 3: bad grid coefficients, shape {cg.shape}")

    # axis 4: the production patch ensemble with its patch axis on the mesh
    from numpy.fft import irfft2, rfft2

    from pdx_torch.pipelines.patch_discovery import PatchDiscoveryConfig
    from pdx_torch.pipelines.patch_discovery import run as pd_run

    base = rng.normal(size=(120, 120))
    sm = irfft2(rfft2(base) * rfft2(np.ones((7, 7)) / 49.0, base.shape), base.shape)
    stack = np.stack([np.roll(sm, (t, -t), axis=(0, 1)) for t in range(14)])
    stack = (stack - stack.min()) / (stack.max() - stack.min())
    pd_cfg = PatchDiscoveryConfig(
        data_dir="unused", registration=False, downsample=1, skip=6, subsample=2,
        patch=15, overlap=7, rs=2, rt=1, samples_per_patch=40,
        write_artifacts=False, mesh="on", dtype="float32",
    )
    pd_out = pd_run(pd_cfg, U_raw=stack, device=dev0, mesh=mesh)
    if not np.all(np.isfinite(pd_out["patch_coeffs"])) or pd_out["patch_coeffs"].shape[0] < n // 2:
        raise AssertionError(f"axis 4: bad patch ensemble, {pd_out['patch_coeffs'].shape[0]} patches")
    if pd_out["n_shard_devices"] != n:
        raise AssertionError(f"axis 4: patch axis split over {pd_out['n_shard_devices']} of {n} slots")

    # axis 5: the weak form's projections split by test-function rows
    from pdx_torch.library.weakform import build_weakform_dataset

    T_w, n_grid_w, n_phi = 5, 32, 2 * n
    U_w = torch.as_tensor(rng.normal(size=(T_w, n_grid_w, n_grid_w)) * 0.1, dtype=torch.float32, device=dev0)
    kw = dict(dx=0.5, dy=0.5, dt_frame=1e-2, lx=16.0, ly=16.0, basis="gaussian", n_phi=n_phi, sigma_px=3.0)

    def project(rows: torch.Tensor):
        _names, Xw, yw = build_weakform_dataset(U_w.to(rows.device), phi_rows=rows, **kw)
        # rows are (T-1) frames of P contiguous test functions: the φ axis leads
        return Xw.reshape(T_w - 1, len(rows), -1).transpose(0, 1), yw.reshape(T_w - 1, len(rows)).T

    parts = map_shards(project, (shard_batch(torch.arange(n_phi, device=dev0), mesh),), mesh)
    _check_split("axis 5 (test functions)", [x for x, _ in parts], mesh, n_phi // n)
    Xs, ys = gather_leading(parts, mesh)
    Xw = Xs.transpose(0, 1).reshape((T_w - 1) * n_phi, -1)
    yw = ys.T.reshape(-1)
    wcoef = stridge_from_stats(gram_stats(Xw, yw), alpha=1e-8, threshold=1e-12).coeffs
    if not bool(torch.isfinite(wcoef).all()):
        raise AssertionError("axis 5: weak-form coefficients not finite")
    _n, Xw_rep, yw_rep = build_weakform_dataset(U_w, **kw)
    np.testing.assert_allclose(Xw.cpu().numpy(), Xw_rep.cpu().numpy(), rtol=2e-5, atol=1e-6, err_msg="axis 5 X")
    np.testing.assert_allclose(yw.cpu().numpy(), yw_rep.cpu().numpy(), rtol=2e-5, atol=1e-6, err_msg="axis 5 y")

    # axis 6: the comprehensive benchmark's regime round-robin
    from pdx_torch.pipelines.comprehensive import ComprehensiveConfig
    from pdx_torch.pipelines.comprehensive import run as comp_run

    comp_cfg = ComprehensiveConfig(
        Nx=32, Ny=32, n_seconds=0.05, save_every=25, n_subsample=2000,
        methods=("M01_baseline", "M02_gaussian"), noises=("N2_noise", "N3_blur"),
        dtype="float32", multi_device=True, write_artifacts=False,
    )
    comp_out = comp_run(comp_cfg, device=dev0, mesh=mesh)
    slots = set(comp_out["placement"].values())
    if len(slots) != min(3, n):
        raise AssertionError(f"axis 6: regime round-robin collapsed to {len(slots)} slot(s) on a {n}-slot mesh")
    for reg in ("N0_clean", "N2_noise", "N3_blur"):
        if not np.all(np.isfinite(comp_out["results"][reg]["M01_baseline"]["coef"])):
            raise AssertionError(f"axis 6: M01 on {reg} not finite")

    print(
        f"dryrun_multichip({n_devices}): ok — sharded Gram + patch-sharded STRidge + sharded grid sweep "
        f"+ production patch pipeline + φ-sharded weak form + regime round-robin on "
        f"[{', '.join(mesh.slot_name(i) for i in range(n))}]"
    )
    return {
        "mesh": [mesh.slot_name(i) for i in range(n)],
        "distinct_devices": len(set(mesh.devices)),
        "patch_shards": pd_out["n_shard_devices"],
        "placement": comp_out["placement"],
    }
