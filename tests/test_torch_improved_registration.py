"""pdx_torch.pipelines.improved_registration against
pdx.pipelines.improved_registration on 6 frames of 96 x 96
(``make_synthetic_stack``: diffusion and drift of a smooth random field,
uint16). ``pdx`` runs twice, in a module-scoped fixture: the default float64
configuration, and float32 with the reference's inverted warp (its fit by
``stridge_qr``).

Tolerances, and why:

* the selected method must be the same, the mean flow magnitudes within
  1e-6 relative and the improvements within 1e-4 percentage points (1e-6
  of 100%): the DIS chain, its quality and the unregistered sweep are
  float64 on both sides (measured ~1e-15 apart), but the Farnebäck chain's
  flows are float32 on a float64 stack, as in ``pdx``, and move its
  registered frames by ~1e-7 (its magnitude measured 5.5e-7 apart, its
  improvement 4.1e-5 points);
* the coefficients within 1e-5 of max|coef| with the same support (|c| >
  1e-5, the equation's terms) and R2 within 1e-6: the float32 Farnebäck path
  bounds them; with DIS selected they agree to ~3e-12;
* float32 throughout: every stage rounds in float32 in another order;
  coefficients within 1e-3 of max|coef|, magnitudes within 1e-4 relative,
  improvements within 1e-2 points, the same method.
"""

import json

import numpy as np
import pytest
import torch

from pdx.pipelines import improved_registration as jir
from pdx_torch import __main__ as tmain
from pdx_torch.pipelines import improved_registration as tir
from test_torch_patch_discovery import make_synthetic_stack
from torch_card import all_finite, assert_flow_kernels, assert_no_gram_kernel, card, full_stack, launches

BASE = dict(data_dir="unused", max_images=6, skip=10, subsample=6, savgol_window=5, savgol_poly=2,
            write_artifacts=False)
CASES = {
    "float64": (dict(), 1e-6, 1e-5),
    "float32_reference_warp": (dict(dtype="float32", reference_compat_warp=True), 1e-4, 1e-3),
}
CLI_FRAMES = 8  # the default Savitzky-Golay window is 7 frames


@pytest.fixture(scope="module")
def stack():
    return make_synthetic_stack(T=6, N=96)


@pytest.fixture(scope="module")
def pdx_results(stack):
    return {name: jir.run(jir.ImprovedRegistrationConfig(**BASE, **kw), U_raw=stack) for name, (kw, _, _) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_run_matches_pdx(name, stack, pdx_results):
    kw, q_rtol, c_tol = CASES[name]
    got = tir.run(tir.ImprovedRegistrationConfig(**BASE, **kw), U_raw=stack, device="cpu")
    want = pdx_results[name]
    assert set(got) == set(want)
    assert got["config"] == want["config"] and got["term_names"] == want["term_names"]
    assert got["selected_method"] == want["selected_method"]
    assert got["working_shape"] == tuple(want["working_shape"]) == (4, 11, 11)
    for key in ("farneback_metrics", "dis_metrics"):
        assert set(got[key]) == set(want[key])
        for k in ("avg_flow_before", "avg_flow_after"):
            np.testing.assert_allclose(got[key][k], want[key][k], rtol=q_rtol, err_msg=f"{key} {k}")
        np.testing.assert_allclose(got[key]["improvement_pct"], want[key]["improvement_pct"], rtol=0,
                                   atol=100 * q_rtol, err_msg=f"{key} improvement_pct")
    c, cj = got["coeffs"], np.asarray(want["coeffs"])
    np.testing.assert_allclose(c, cj, rtol=0, atol=c_tol * np.abs(cj).max())
    np.testing.assert_array_equal(np.abs(c) > 1e-5, np.abs(cj) > 1e-5)
    np.testing.assert_allclose(got["r2"], want["r2"], rtol=0, atol=c_tol / 10)
    assert np.isfinite(c).all() and len(c) == 13


def test_dis_register_sequence_matches_pdx(stack):
    """The DIS chain alone, float64, both warp signs: within 1e-10 of
    max|value| (measured ~1e-15)."""
    import jax.numpy as jnp
    from pdx.pipelines.improved_registration import dis_register_sequence

    U = stack[:4].astype(np.float64) / 65535.0
    for sign in (1.0, -1.0):
        got = tir.dis_register_sequence(torch.from_numpy(U), warp_sign=sign)
        want = np.asarray(dis_register_sequence(jnp.asarray(U), warp_sign=sign))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
        assert torch.equal(got[0], torch.from_numpy(U[0]))


def test_artifacts(stack, tmp_path, pdx_results):
    """registration_study.json with the keys pdx writes (its result but the
    configuration), and the four slides."""
    cfg = tir.ImprovedRegistrationConfig(**dict(BASE, write_artifacts=True, output_dir=str(tmp_path)))
    out = tir.run(cfg, U_raw=stack, device="cpu")
    art = json.loads((tmp_path / "registration_study.json").read_text())
    assert set(art) == set(pdx_results["float64"]) - {"config"}
    assert art["selected_method"] == out["selected_method"] and art["equation"] == out["equation"]
    for name in ("SLIDE1_Registration_Quality_51images.png", "SLIDE2_Flow_Fields_51images.png",
                 "SLIDE3_PDE_Results_51images.png", "SLIDE4_Spatiotemporal_51images.png"):
        assert (tmp_path / name).stat().st_size > 10_000, name
    # SLIDE2's flows, computed on the device outside the figure guard
    fb, dz, fi = tir.slide_flows(torch.from_numpy(stack.astype(np.float64) / 65535.0))
    assert fi == 4 and fb.shape == dz.shape == (2, 96, 96) and torch.isfinite(torch.cat([fb, dz])).all()


def test_cli(tmp_path, capsys, monkeypatch):
    PIL = pytest.importorskip("PIL.Image")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    d = tmp_path / "tiffs"
    d.mkdir()
    for i, frame in enumerate(make_synthetic_stack(T=CLI_FRAMES, N=96)):
        PIL.fromarray(frame).save(d / f"frame_{i:03d}.tif")
    rc = tmain.main(["improved-registration", "--data-dir", str(d), "--output-dir", str(tmp_path / "out"),
                     "--max-images", str(CLI_FRAMES), "--skip", "10", "--subsample", "6", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "Selected:" in text and "R2 = " in text and "u_t = " in text
    assert (tmp_path / "out" / "registration_study.json").exists()


# --- the card: the study at the real dataset's shape, and against the CPU ------------------------------------------


@pytest.mark.gpu
def test_full_size_on_the_card():
    """The default configuration (the Farnebäck and DIS chains, three
    quality sweeps of 50 float64 pairs at 1024 x 1280, a 49 x 80 x 101
    working stack) on the real dataset's shape: finite coefficients (13),
    R2 and quality metrics, the working shape, a selected method, none of
    K1-K4 launched, every flow kernel launched."""
    cfg = tir.ImprovedRegistrationConfig(data_dir="unused", write_artifacts=False)
    U = full_stack()  # skips without a card
    with launches() as moved:
        out = tir.run(cfg, U_raw=U, device=card())
    assert_no_gram_kernel(moved)
    assert_flow_kernels(moved)
    metrics = [out[m][k] for m in ("farneback_metrics", "dis_metrics") for k in out[m]]
    assert len(out["coeffs"]) == 13 and np.isfinite(out["coeffs"]).all() and np.isfinite(out["r2"])
    assert all_finite(metrics), metrics
    assert out["working_shape"] == (49, 80, 101) and out["selected_method"] in ("DIS", "Farneback")


@pytest.mark.gpu
def test_card_matches_cpu():
    """6 frames of 96 x 96 (Savitzky-Golay window 5): the same method, flow
    magnitudes within 1e-6 relative, improvements within 1e-4 points,
    coefficients within 1e-5 of max|coef| with the same support."""
    from tools.make_synth_stack import make_stack

    U = make_stack(T=6, H=96, W=96, seed=1)
    a, b = (tir.run(tir.ImprovedRegistrationConfig(**BASE), U_raw=U, device=d) for d in (card(), "cpu"))
    assert a["selected_method"] == b["selected_method"]
    for m in ("farneback_metrics", "dis_metrics"):
        for k in ("avg_flow_before", "avg_flow_after"):
            assert abs(a[m][k] - b[m][k]) / abs(b[m][k]) < 1e-6, (m, k)
        assert abs(a[m]["improvement_pct"] - b[m]["improvement_pct"]) < 1e-4, m
    assert np.abs(a["coeffs"] - b["coeffs"]).max() / np.abs(b["coeffs"]).max() < 1e-5
    assert np.array_equal(np.abs(a["coeffs"]) > 1e-5, np.abs(b["coeffs"]) > 1e-5)
