"""pdx_torch.pipelines.patch_discovery against pdx.pipelines.patch_discovery,
float64, on a synthetic TIFF stack (12 frames of 128 x 128 uint16: diffusion
and drift of a smooth random field; the stack of pdx's own real-pipeline
tests at test_register.py's frame sizes).

Tolerances, and why:

* registration off: both fit the same host-drawn rows; derivatives,
  Gram statistics and STRidge solves sum in another order (measured 1e-11
  of max|coef|). Coefficients, ``patch_coeffs`` and the aggregated stats
  within 1e-10 of max|coef|, the support equal; metrics within rtol 1e-9
  plus atol 1e-9 (a patch's test R2 = 1 - ss_res / ss_tot over 30 rows
  moves ~1e-10 with such coefficients);
* registration on: the flows are computed in float32, as in ``pdx``;
  float32 rounding in another summation order moves the registered frames
  by ~3e-7 and the coefficients by ~1e-6 of max|coef| (measured, in every
  registration mode). Coefficients within 1e-5 of max|coef|, the same kept
  support and nonzero frequencies; metrics within rtol 1e-4 plus atol
  2e-4: a patch's R2 over its 30 test rows moves by up to 3.6e-5 (measured,
  compose mode, at R2 = -0.30), and near R2 = 0 only an absolute limit means
  anything.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.pipelines import patch_discovery as jpd
from pdx.preprocess import resize_denoise_normalize as j_rdn
from pdx.register.farneback import register_sequence_dispatch as j_register
from pdx_torch import __main__ as tmain
from pdx_torch.interop import stack_from_numpy
from pdx_torch.pipelines import patch_discovery as tpd
from torch_card import all_finite, assert_flow_kernels, assert_no_gram_kernel, card, full_stack, launches, motion

SMALL = dict(max_images=12, skip=4, subsample=2, patch=11, overlap=5, samples_per_patch=60, rt=1, rs=2, deg=2,
             write_artifacts=False)
METRICS = ("rmse", "r2", "nrmse", "mae", "corr")


def make_synthetic_stack(T=12, N=128, D=2.0, vx=0.3, vy=-0.2, seed=0):
    """Diffusion + drift evolution of a smooth random field (periodic FFT),
    as uint16 frames."""
    rng = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter

    u0 = gaussian_filter(rng.normal(size=(N, N)), 8, mode="wrap")
    u0 = (u0 - u0.min()) / (u0.max() - u0.min())
    kx = 2 * np.pi * np.fft.fftfreq(N)
    KX, KY = np.meshgrid(kx, kx, indexing="ij")
    K2 = KX**2 + KY**2
    F0 = np.fft.fft2(u0)
    frames = []
    for t in range(T):
        phase = np.exp(-D * K2 * t - 1j * (KX * vx + KY * vy) * t)
        frames.append(np.fft.ifft2(F0 * phase).real)
    U = np.stack(frames)
    U = (U - U.min()) / (U.max() - U.min())
    return (U * 60000).astype(np.uint16)


@pytest.fixture(autouse=True)
def _stack_caches_in_tmp(tmp_path, monkeypatch):
    """Both packages' decoded-stack disk caches go to the test's directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("PDX_STACK_CACHE_DIR", str(tmp_path / "pdx_stacks"))


@pytest.fixture(scope="module")
def tiff_dir(tmp_path_factory):
    PIL = pytest.importorskip("PIL.Image")
    d = tmp_path_factory.mktemp("synth_tiffs")
    for i, frame in enumerate(make_synthetic_stack()):
        PIL.fromarray(frame).save(d / f"frame_{i:03d}.tif")
    return d


@pytest.fixture(scope="module")
def stack():
    return make_synthetic_stack()


def _configs(**kw):
    return jpd.PatchDiscoveryConfig(**SMALL, **kw), tpd.PatchDiscoveryConfig(**SMALL, **kw)


def _compare(got, want, coef_tol, metric_rtol, metric_atol):
    assert set(got) == set(want)
    assert got["names"] == want["names"] and got["n_patches"] == want["n_patches"] > 0
    assert got["working_shape"] == tuple(want["working_shape"])
    assert got["config"] == want["config"]
    assert got["n_shard_devices"] == 1
    C, Cj = got["patch_coeffs"], np.asarray(want["patch_coeffs"])
    scale = np.abs(Cj).max()
    np.testing.assert_allclose(C, Cj, rtol=0, atol=coef_tol * scale)
    for k in ("median", "q25", "q75", "coeffs"):
        np.testing.assert_allclose(got["stats"][k], np.asarray(want["stats"][k]), rtol=0, atol=coef_tol * scale)
    for k in ("freq", "sign_stability", "keep"):
        np.testing.assert_array_equal(got["stats"][k], np.asarray(want["stats"][k]))
    for key in ("patch_train_metrics", "patch_test_metrics"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose([g[k] for k in METRICS], [w[k] for k in METRICS], rtol=metric_rtol,
                                       atol=metric_atol)
    keys = sorted(want["global_test_metrics"])
    assert sorted(got["global_test_metrics"]) == keys
    np.testing.assert_allclose([got["global_test_metrics"][k] for k in keys] + [got["one_step_rmse"]],
                               [want["global_test_metrics"][k] for k in keys] + [want["one_step_rmse"]],
                               rtol=metric_rtol, atol=metric_atol)


def test_run_matches_pdx_registration_off(tiff_dir):
    """Loaded from the TIFFs by both packages."""
    cj, ct = _configs(data_dir=str(tiff_dir), registration=False)
    want = jpd.run(cj)
    got = tpd.run(ct, device="cpu")
    _compare(got, want, 1e-10, 1e-9, 1e-9)
    assert got["equation"] == want["equation"]


@pytest.mark.parametrize("mode,compat", [("auto", False), ("compose", False), ("to_first", False), ("chain", True)])
def test_run_matches_pdx_registration_on(stack, mode, compat):
    """The chain (auto), the composed and the to-first pair flows, and the
    reference's inverted warp sign."""
    cj, ct = _configs(data_dir="unused", registration=True, register_mode=mode, reference_compat_warp=compat)
    want = jpd.run(cj, U_raw=stack)
    got = tpd.run(ct, U_raw=stack, device="cpu")
    _compare(got, want, 1e-5, 1e-4, 2e-4)


def test_discover_on_pdx_registered_stack(stack):
    """pdx's own registered stack fed to the port's later stages: discovery
    alone, held to the registration-off limits."""
    cj, ct = _configs(data_dir="unused", registration=True)
    U = j_rdn(jnp.asarray(stack), out_h=64, out_w=64, sigma=cj.denoise_sigma1, eps=1e-12, dtype_name="float64")
    U_reg = np.asarray(j_register(U, mode="auto", refine=1))
    got = tpd.discover(ct, stack_from_numpy(U_reg))
    _compare(got, jpd.run(cj, U_raw=stack), 1e-10, 1e-9, 1e-9)


def test_artifacts(stack, tmp_path):
    """The artifact contract of pdx's real-pipeline test."""
    _, ct = _configs(data_dir="unused", registration=False)
    out = tpd.run(dataclasses.replace(ct, write_artifacts=True, output_dir=str(tmp_path)), U_raw=stack, device="cpu")
    csv = (tmp_path / "PATCH_PDE_COEFFS.csv").read_text()
    assert csv.startswith("term,median,q25,q75,nonzero_freq,sign_stability,agg_coeff")
    assert "lap(u)" in csv and len(csv.splitlines()) == 1 + len(out["names"])
    report = (tmp_path / "PATCH_PDE_REPORT.txt").read_text()
    assert f"Aggregated PDE:\n  {out['equation']}" in report and "Registration: OFF" in report
    summary = json.loads((tmp_path / "patch_pde_summary.json").read_text())
    assert summary["equation"] == out["equation"] and summary["n_patches"] == out["n_patches"]
    assert summary["terms"] == out["names"] and len(summary["agg_coeffs"]) == len(out["names"])
    assert (tmp_path / "PATCH_PDE_SUMMARY.png").stat().st_size > 10_000


def test_cli_device_cpu(tiff_dir, tmp_path, capsys):
    argv = ["patch-discover", "--data-dir", str(tiff_dir), "--output-dir", str(tmp_path), "--max-images", "12",
            "--skip", "4", "--subsample", "2", "--patch", "11", "--overlap", "5", "--samples-per-patch", "60",
            "--rt", "1", "--rs", "2", "--deg", "2", "--model", "model4", "--no-registration", "--device", "cpu"]
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert "Patches fit: 9" in out and "Aggregated PDE: u_t =" in out and "Test: R2=" in out
    assert (tmp_path / "PATCH_PDE_COEFFS.csv").read_text().count("\n") == 1 + len(tpd.MODEL4_TERMS)


def test_run_needs_a_card_unless_cpu(stack):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpd.run(tpd.PatchDiscoveryConfig(**SMALL), U_raw=stack)


def test_patch_grid_and_features():
    for args in ((28, 28, 11, 5), (30, 41, 21, 10), (5, 5, 11, 5), (20, 20, 4, 4)):
        assert tpd.patch_grid(*args) == jpd.patch_grid(*args)
    d = np.random.default_rng(0).normal(size=(2, 7, 6))
    for names in (tpd.FULL_TERMS, tpd.MODEL4_TERMS):
        got = tpd.feature_matrix(torch.from_numpy(d), names)
        want = np.stack([np.asarray(jpd.feature_matrix(jnp.asarray(x), names)) for x in d])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw,match", [(dict(max_images=5, rt=2), "too few frames"),
                                      (dict(patch=61), "Patch grid is empty")])
def test_errors_match_pdx(stack, kw, match):
    cfg = {**SMALL, **kw, "registration": False}
    with pytest.raises(RuntimeError, match=match):
        jpd.run(jpd.PatchDiscoveryConfig(**cfg), U_raw=stack[: cfg["max_images"]])
    with pytest.raises(RuntimeError, match=match):
        tpd.run(tpd.PatchDiscoveryConfig(**cfg), U_raw=stack[: cfg["max_images"]], device="cpu")


# --- the card: the patch ensemble at full size, its artifacts, and against the CPU ---------------------------------


@pytest.fixture(scope="module")
def full_stacks():
    """The real dataset's shape (51 x 1024 x 1280 uint16) with the default
    configuration, and bench.py's stack (51 x 512 x 640 float64, skip 12,
    subsample 6); built once a card is present."""
    from tools.make_synth_stack import make_stack

    real = full_stack()  # skips without a card
    bench = make_stack(T=51, H=512, W=640).astype(np.float64)
    bench.setflags(write=False)
    return {"real_51x1024x1280_u16": (real, dict()),
            "bench_51x512x640_f64": (bench, dict(skip=12, subsample=6))}


@pytest.mark.gpu
@pytest.mark.parametrize("stack_name", ["real_51x1024x1280_u16", "bench_51x512x640_f64"])
def test_full_size_on_the_card(full_stacks, stack_name):
    """Registration in ``auto`` mode (the Farnebäck chain, each flow at half
    resolution): patches fit, finite coefficients and metrics, none of
    K1-K4 launched, every flow kernel launched (the default
    configuration), and registration lowers the residual motion."""
    dev = card()
    U, kw = full_stacks[stack_name]
    cfg = tpd.PatchDiscoveryConfig(data_dir="unused", write_artifacts=False, **kw)
    with launches() as moved:
        out = tpd.run(cfg, U_raw=U, device=dev)
    assert_no_gram_kernel(moved)
    if not kw:
        assert_flow_kernels(moved)
    assert out["n_patches"] > 0
    assert np.isfinite(out["patch_coeffs"]).all() and np.isfinite(out["stats"]["coeffs"]).all()
    metrics = [v for pm in out["patch_train_metrics"] + out["patch_test_metrics"] for v in pm.values()]
    assert all_finite(metrics + list(out["global_test_metrics"].values()) + [out["one_step_rmse"]])
    U_pre = tpd.preprocess_head(cfg, U, dev)
    assert motion(tpd.register(cfg, U_pre)) < motion(U_pre)


@pytest.mark.gpu
def test_artifacts_on_the_card(full_stacks, tmp_path):
    """bench.py's stack with the artifacts written: the CSV's header, the
    report's "Aggregated PDE:" line and the JSON summary agree with the run."""
    U, kw = full_stacks["bench_51x512x640_f64"]
    cfg = tpd.PatchDiscoveryConfig(data_dir="unused", write_artifacts=True, output_dir=str(tmp_path), **kw)
    out = tpd.run(cfg, U_raw=U, device=card())
    csv = (tmp_path / "PATCH_PDE_COEFFS.csv").read_text()
    assert csv.startswith("term,median,q25,q75,nonzero_freq,sign_stability,agg_coeff") and "lap(u)" in csv
    assert f"Aggregated PDE:\n  {out['equation']}" in (tmp_path / "PATCH_PDE_REPORT.txt").read_text()
    summary = json.loads((tmp_path / "patch_pde_summary.json").read_text())
    assert summary["equation"] == out["equation"] and summary["n_patches"] == out["n_patches"]
    assert len(summary["agg_coeffs"]) == len(out["names"])


@pytest.mark.gpu
@pytest.mark.parametrize("registration,tol", [(False, 1e-10), (True, 1e-5)])
def test_card_matches_cpu(registration, tol):
    """12 x 128 x 128 frames: patch coefficients within the CPU tests'
    limits of max|coef|, the same kept support."""
    from tools.make_synth_stack import make_stack

    U = make_stack(T=12, H=128, W=128, seed=1)
    cfg = tpd.PatchDiscoveryConfig(data_dir="unused", registration=registration, **SMALL)
    on_card, on_cpu = (tpd.run(cfg, U_raw=U, device=d) for d in (card(), "cpu"))
    a, b = np.asarray(on_card["patch_coeffs"]), np.asarray(on_cpu["patch_coeffs"])
    assert np.abs(a - b).max() / np.abs(b).max() < tol
    assert np.array_equal(on_card["stats"]["keep"], on_cpu["stats"]["keep"])


@pytest.mark.gpu
@pytest.mark.parametrize("frames,flow_ds", [(128, None), (256, 2)], ids=["run_chain_64px", "flow_ds2_128px"])
def test_chain_card_matches_cpu(frames, flow_ds):
    """The registered frames of run's chain (64 px working frames: the flow
    at full resolution on both) and of the chain with ``flow_ds=2`` passed
    to both (128 px working frames), card against CPU within 5e-6."""
    from pdx_torch.register.farneback import farneback_register_sequence
    from tools.make_synth_stack import make_stack

    U = make_stack(T=12, H=frames, W=frames, seed=1 if flow_ds is None else 2)
    cfg = tpd.PatchDiscoveryConfig(data_dir="unused", registration=True, **SMALL)
    kw = {} if flow_ds is None else dict(flow_ds=flow_ds)
    reg = [farneback_register_sequence(tpd.preprocess_head(cfg, U, d), **kw).cpu().numpy() for d in (card(), "cpu")]
    assert np.abs(reg[0] - reg[1]).max() < 5e-6
