"""pdx_torch.pipelines.patch_sindy against pdx.pipelines.patch_sindy, float64,
on 6 frames of 96 x 96 (``make_synthetic_stack``: diffusion and drift of a
smooth random field), every registration schedule. ``pdx`` runs once per
configuration, in a module-scoped fixture.

Tolerances, and why:

* no flow (registration ``none`` and ``ecc``): the ensemble coefficients
  and their spread within 1e-10 of max|coef| (measured ≤ 5e-11). Each
  patch's own coefficients within 1e-9 of max|coef| (measured
  0.85-1.45e-10 over three stacks): the
  standardisation works on the raw Gram (var = G_ii / n - mean^2, as in
  ``pdx``), which cancels ~6 digits for columns such as u whose spread in a
  patch is small against their mean, so a last-bit difference of the Gram's
  summation order moves a patch's fit by ~1e-10;
* through the float32 Farnebäck flows (``optical_flow``: chain with
  ``flow_batch`` on and off, compose with ``flow_downsample`` 1 and 2, frame
  scope): the ensemble coefficients within 1e-5 of max|coef| (measured ≤
  7.5e-6) with the same zero pattern (variance suppression), each patch's
  within 3e-5 (measured ≤ 1.04e-5: the float32 flows move the registered
  patches by ~1e-7, amplified as above);
* the average quality and its spread, absolute: a quality is max(0, R2) x
  registration quality, and near R2 = 0 only an absolute limit means
  anything. Measured ≤ 2e-11 without flows and ≤ 5e-6 with them (compose:
  the quality's flow magnitudes are float32 too): limits 1e-10 and 2e-5;
* the constant term "1": its column has no spread, so its standardised
  coefficient is (X_1^T y - sum(y)) / alpha, two sums of the same numbers
  in another order: round-off in both packages (up to ~2e-9 of max|coef|
  with 8-bit frames). It is held within 1e-8 of max|coef| of zero on both
  sides instead of to each other.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.pipelines import patch_sindy as jps
from pdx_torch import __main__ as tmain
from pdx_torch.pipelines import patch_sindy as tps
from test_torch_patch_discovery import make_synthetic_stack
from torch_card import assert_no_gram_kernel, card, full_f255, launches, motion

BASE = dict(data_dir="unused", patch_size=48, overlap=16, skip_boundary=3, subsample=2, min_patches=2,
            write_artifacts=False)
FLOW = dict(registration_method="optical_flow")
# name: (config, input (tiff | float | u8), no-flow path)
CASES = {
    "none_tiff": (dict(), "tiff", True),
    "ecc": (dict(registration_method="ecc"), "float", True),
    "max_patches_u8": (dict(max_patches=3), "u8", True),
    "chain": (dict(FLOW, flow_compose=False), "float", False),
    "chain_per_patch": (dict(FLOW, flow_compose=False, flow_batch=False), "float", False),
    "compose_ds1": (dict(FLOW, flow_compose=True, flow_downsample=1), "float", False),
    "compose_ds2": (dict(FLOW, flow_compose=True, flow_downsample=2, patch_size=64, overlap=32), "float", False),
    "frame": (dict(FLOW, flow_scope="frame"), "float", False),
}


@pytest.fixture(autouse=True)
def _stack_caches_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("PDX_STACK_CACHE_DIR", str(tmp_path / "pdx_stacks"))


@pytest.fixture(scope="module")
def stack():
    return make_synthetic_stack(T=6, N=96)


@pytest.fixture(scope="module")
def tiff_dir(tmp_path_factory, stack):
    PIL = pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("synth_tiffs_sindy")
    for i, frame in enumerate(stack):
        PIL.fromarray(frame).save(d / f"frame_{i:03d}.tif")
    return d


def _inputs(kind, stack, tiff_dir):
    """(data_dir override, U_raw) for an input kind: the TIFF folder (read
    as 8-bit and scaled by 1/255 by both), the stack as floats in [0, 1],
    or as uint8 frames passed as they are (neither package scales them)."""
    if kind == "tiff":
        return dict(data_dir=str(tiff_dir)), None
    if kind == "u8":
        return {}, (stack >> 8).astype(np.uint8)
    return {}, stack.astype(np.float64) / 65535.0


@pytest.fixture(scope="module")
def pdx_results(stack, tiff_dir, tmp_path_factory):
    cache = tmp_path_factory.mktemp("pdx_cache")
    mp = pytest.MonkeyPatch()
    mp.setenv("PDX_STACK_CACHE_DIR", str(cache))
    try:
        out = {}
        for name, (kw, kind, _) in CASES.items():
            over, U_raw = _inputs(kind, stack, tiff_dir)
            out[name] = jps.run(jps.PatchSindyConfig(**{**BASE, **kw, **over}), U_raw=U_raw)
        return out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", list(CASES))
def test_run_matches_pdx(name, stack, tiff_dir, pdx_results):
    kw, kind, no_flow = CASES[name]
    over, U_raw = _inputs(kind, stack, tiff_dir)
    got = tps.run(tps.PatchSindyConfig(**{**BASE, **kw, **over}), U_raw=U_raw, device="cpu")
    want = pdx_results[name]
    assert set(got) == set(want)
    assert got["config"] == want["config"] and got["term_names"] == want["term_names"]
    assert got["n_patches"] == want["n_patches"] and got["n_shard_devices"] == 1
    C, Cj = got["patch_coeffs"], np.asarray(want["patch_coeffs"])
    scale = np.abs(Cj).max()
    ens_tol, patch_tol, q_tol = (1e-10, 1e-9, 1e-10) if no_flow else (1e-5, 3e-5, 2e-5)
    np.testing.assert_allclose(C[:, 1:], Cj[:, 1:], rtol=0, atol=patch_tol * scale)
    for k in ("coeffs", "coeffs_std"):
        np.testing.assert_allclose(got[k][1:], np.asarray(want[k])[1:], rtol=0, atol=ens_tol * scale)
    np.testing.assert_array_equal(got["coeffs"][1:] == 0, np.asarray(want["coeffs"])[1:] == 0)
    for c0 in (C[:, 0], Cj[:, 0], got["coeffs"][:1], np.asarray(want["coeffs"])[:1]):  # "1": round-off
        assert np.abs(c0).max() < 1e-8 * scale
    np.testing.assert_allclose([got["avg_quality"], got["quality_std"]], [want["avg_quality"], want["quality_std"]],
                               rtol=0, atol=q_tol)
    assert 0 <= got["avg_quality"] <= 1


def test_compose_at_quarter_resolution_matches_pdx():
    """The card's default per-patch schedule, forced on the CPU for both: the
    compose path with flows at 1/4 of a 256 px patch, on 8 frames of
    256 x 256 read as 8-bit / 255. Limits as for the other flow paths; the
    registration removes the stack's drift, the patch's R2 is <= 0, and both
    packages give quality 0."""
    from tools.make_synth_stack import make_stack

    U = (make_stack(T=8, H=256, W=256) >> 8).astype(np.uint8) / 255.0
    kw = dict(data_dir="unused", patch_size=256, overlap=0, min_patches=1, write_artifacts=False,
              registration_method="optical_flow", flow_compose=True, flow_downsample=4)
    got = tps.run(tps.PatchSindyConfig(**kw), U_raw=U, device="cpu")
    want = jps.run(jps.PatchSindyConfig(**kw), U_raw=U)
    Cj = np.asarray(want["patch_coeffs"])
    np.testing.assert_allclose(got["patch_coeffs"][:, 1:], Cj[:, 1:], rtol=0, atol=3e-5 * np.abs(Cj).max())
    assert got["avg_quality"] == want["avg_quality"] == 0.0


def test_patches_and_max_patches_draw(stack):
    """The patches are pdx's, in its order; max_patches keeps pdx's host
    draw (random.seed(0); random.sample)."""
    U = stack.astype(np.float64) / 65535.0
    got, coords = tps.extract_patch_sequences(torch.from_numpy(U), 32, 16)
    want, coords_j = jps.extract_patch_sequences(jnp.asarray(U), 32, 16)
    assert coords == coords_j and len(coords) == 25
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))
    cfg = dict(BASE, patch_size=32, overlap=16, max_patches=7)
    import random

    random.seed(0)
    keep = sorted(random.sample(range(25), 7))
    out = tps.run(tps.PatchSindyConfig(**cfg), U_raw=U, device="cpu")
    assert out["n_patches"] == 7
    full = tps.run(tps.PatchSindyConfig(**dict(cfg, max_patches=None)), U_raw=U, device="cpu")
    np.testing.assert_array_equal(out["patch_coeffs"], full["patch_coeffs"][keep])


def test_discover_patches_matches_pdx(stack):
    """The batched dataset and fits alone, on the same patches and a
    registration quality that is not 1."""
    U = stack.astype(np.float64) / 65535.0
    seqs, _ = tps.extract_patch_sequences(torch.from_numpy(U), 48, 16)
    q = torch.linspace(0.5, 1.0, seqs.shape[0], dtype=torch.float64)
    cfg = tps.PatchSindyConfig(**BASE)
    c, qual = tps.discover_patches(seqs, q, cfg)
    cj, qj = jps._discover_all(jnp.asarray(seqs.numpy()), jnp.asarray(q.numpy()), dt=cfg.dt, dx=cfg.dx, dy=cfg.dy,
                               alpha=cfg.alpha, sb=cfg.skip_boundary, sub=cfg.subsample)
    cj = np.asarray(cj)
    np.testing.assert_allclose(c.numpy()[:, 1:], cj[:, 1:], rtol=0, atol=1e-9 * np.abs(cj).max())
    assert max(np.abs(c.numpy()[:, 0]).max(), np.abs(cj[:, 0]).max()) < 1e-8 * np.abs(cj).max()
    np.testing.assert_allclose(qual.numpy(), np.asarray(qj), rtol=0, atol=1e-10)


def test_auto_policies_read_the_device():
    """flow_compose None: compose on the card, chain on the CPU. flow_ds
    None: on the card the largest of {4, 2} keeping a 64 px flow grid, on
    the CPU 1; an explicit value is honoured down to a 32 px grid (pdx's
    rules, keyed on the device instead of the backend)."""
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert tps._resolve_flow_compose(None, card) and not tps._resolve_flow_compose(None, cpu)
    assert tps._resolve_flow_compose(False, card) is False and tps._resolve_flow_compose(True, cpu) is True
    assert [tps._resolve_flow_ds(None, ps, card) for ps in (256, 200, 128, 96)] == [4, 2, 2, 1]
    assert [tps._resolve_flow_ds(None, ps, cpu) for ps in (256, 96)] == [1, 1]
    for ds, ps in ((2, 64), (4, 64), (8, 128), (4, 256), (3, 48)):
        assert tps._resolve_flow_ds(ds, ps, cpu) == tps._resolve_flow_ds(ds, ps, card) == jps._resolve_flow_ds(ds, ps)


def test_artifacts(stack, tmp_path, pdx_results):
    """patch_sindy_results.json with the keys pdx writes (its result but the
    configuration and the per-patch coefficients), and the figure."""
    U = stack.astype(np.float64) / 65535.0
    cfg = tps.PatchSindyConfig(**dict(BASE, write_artifacts=True, output_dir=str(tmp_path)))
    out = tps.run(cfg, U_raw=U, device="cpu")
    art = json.loads((tmp_path / "patch_sindy_results.json").read_text())
    assert set(art) == set(pdx_results["none_tiff"]) - {"config", "patch_coeffs"}
    assert art["term_names"][6] == "∇²u" and art["n_patches"] == out["n_patches"]
    np.testing.assert_allclose(art["coeffs"], out["coeffs"], rtol=1e-15)
    assert (tmp_path / "patch_based_sindy_results.png").stat().st_size > 10_000


def test_patch_size_clamp_warns():
    U = make_synthetic_stack(T=4, N=40).astype(np.float64) / 65535.0
    cfg = tps.PatchSindyConfig(**dict(BASE, patch_size=64))
    with pytest.warns(UserWarning, match="clamped to 40"):
        out = tps.run(dataclasses.replace(cfg, overlap=16, min_patches=1), U_raw=U, device="cpu")
    assert out["n_patches"] == 1


def test_cli(tiff_dir, tmp_path, capsys):
    rc = tmain.main(["patch-sindy", "--data-dir", str(tiff_dir), "--output-dir", str(tmp_path), "--patch-size", "32",
                     "--overlap", "16", "--registration", "none", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Valid patches: 25" in text and "u_t = " in text
    assert (tmp_path / "patch_sindy_results.json").exists()


# --- the card: patch_sindy at the real dataset's shape, and against the CPU -----------------------------------------


def _full_size_gates(out: dict, positive: bool) -> None:
    """30 patches (the 5 x 6 grid of 256 px patches), finite coefficients,
    an average quality in (0, 1] (``positive``) or [0, 1]. A quality is
    max(0, R2) x registration quality: where a registration removes the
    stack's drift, u_t is left at the noise's level and R2 may be <= 0 in
    every patch: the compose schedule gives 0 on this stack, as pdx does on
    the CPU, and is held to the residual motion it removes instead."""
    assert out["n_patches"] == 30
    assert np.isfinite(out["coeffs"]).all() and np.isfinite(out["patch_coeffs"]).all()
    assert (0 < out["avg_quality"] <= 1) if positive else (0 <= out["avg_quality"] <= 1), out["avg_quality"]


@pytest.mark.gpu
@pytest.mark.parametrize("kw,positive", [
    (dict(), False),  # the default configuration: no registration
    (dict(registration_method="optical_flow"), False),  # per patch: the compose path, flows at 64 x 64
    (dict(registration_method="ecc"), True),  # 30 patches as one batch, 50 host steps
    (dict(registration_method="optical_flow", flow_scope="frame"), True),
], ids=["none", "optical_flow_compose", "ecc", "optical_flow_frame"])
def test_full_size_on_the_card(kw, positive):
    """Each schedule on the real dataset's shape read as 8-bit / 255:
    30 patches, finite coefficients, the average quality in range, none of
    K1-K4 launched."""
    cfg = tps.PatchSindyConfig(data_dir="unused", write_artifacts=False, **kw)
    U = full_f255()  # skips without a card
    with launches() as moved:
        out = tps.run(cfg, U_raw=U, device=card())
    assert_no_gram_kernel(moved)
    _full_size_gates(out, positive)


@pytest.mark.gpu
def test_full_size_compose_lowers_the_residual_motion():
    """The compose path's per-patch registration lowers the residual motion
    of the 30 patch sequences of 256 px."""
    from pdx_torch.ops.filters import gaussian_filter_reflect, savgol_time

    cfg = tps.PatchSindyConfig(data_dir="unused", write_artifacts=False, registration_method="optical_flow")
    U = savgol_time(gaussian_filter_reflect(torch.as_tensor(full_f255(), device=card()), cfg.spatial_sigma), 3, 2)
    seqs = tps.extract_patch_sequences(U, 256, 192)[0]
    assert motion(tps.register_patches(cfg, seqs)[0]) < motion(seqs)


@pytest.mark.gpu
@pytest.mark.parametrize("kw,no_flow", [
    (dict(), True), (dict(registration_method="ecc"), True),
    (dict(FLOW, flow_compose=False), False),
    (dict(FLOW, flow_compose=True, flow_downsample=1), False),
    (dict(FLOW, flow_compose=True, flow_downsample=2, patch_size=64, overlap=32), False),
    (dict(FLOW, flow_scope="frame"), False),
], ids=["none", "ecc", "chain", "compose_ds1", "compose_ds2", "frame"])
def test_card_matches_cpu(kw, no_flow):
    """6 frames of 96 x 96, every schedule, at the limits against pdx:
    ensemble coefficients within 1e-10 (no flow) or 1e-5 (float32 flows) of
    max|coef|, each patch's within 1e-9 or 3e-5 (the constant term is
    round-off on both sides: below 1e-8), the average quality within 1e-10
    or 2e-5."""
    from tools.make_synth_stack import make_stack

    U = make_stack(T=6, H=96, W=96, seed=1) / 65535.0
    cfg = tps.PatchSindyConfig(**{**BASE, **kw})
    a, b = (tps.run(cfg, U_raw=U, device=d) for d in (card(), "cpu"))
    ens_tol, patch_tol, q_tol = (1e-10, 1e-9, 1e-10) if no_flow else (1e-5, 3e-5, 2e-5)
    scale = np.abs(b["patch_coeffs"]).max()
    assert np.abs(a["coeffs"][1:] - b["coeffs"][1:]).max() / scale < ens_tol
    assert np.abs(a["patch_coeffs"][:, 1:] - b["patch_coeffs"][:, 1:]).max() / scale < patch_tol
    assert max(np.abs(a["patch_coeffs"][:, 0]).max(), np.abs(b["patch_coeffs"][:, 0]).max()) / scale < 1e-8
    assert abs(a["avg_quality"] - b["avg_quality"]) < q_tol
