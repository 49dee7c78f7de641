"""pdx_torch.library.weakform against pdx.library.weakform, float64.

The same frames (a short KS trajectory from pdx's simulator, or that
trajectory jittered and with noise from a seed) go through both packages.
Every column and the target agree at 1e-10 of that column's own scale
(max |value|): the test functions are the same host numpy arrays, and the
rest is matrix products and FFTs in float64.

The ``one`` column of the rich dictionary with the Fourier basis is the one
place where the port is not held to jitted pdx: it is analytically zero, pdx
leaves the sum's round-off there (which column standardization then blows up
to a coefficient of ~1e9), and the port emits exact zeros.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdx.pipelines.ks2d_bench as jb
import pdx_torch.pipelines.ks2d_bench as tb
from pdx.library import weakform as jw
from pdx.sim.ks2d import Ks2dConfig, simulate_ks2d
from pdx_torch.library import weakform as tw

TOL = 1e-10
NX, NY, DX = 20, 16, 0.5


@functools.lru_cache(maxsize=None)
def _frames(perturbed=False):
    U, dx, dy, DT = simulate_ks2d(Ks2dConfig(Nx=NX, Ny=NY, Lx=NX * DX, Ly=NY * DX, n_seconds=0.012), dtype=jnp.float64)
    U = np.array(U)  # a writable copy: torch.from_numpy shares it
    if perturbed:
        rng = np.random.default_rng(5)
        U = np.stack([np.roll(f, rng.integers(-2, 3, size=2), axis=(0, 1)) for f in U])
        U = U + 0.01 * U.std() * rng.normal(size=U.shape)
    return U, DT


def _both(U, DT, **kw):
    kw = dict(dict(dx=DX, dy=DX, dt_frame=DT, lx=NX * DX, ly=NY * DX, max_k=2, n_phi=7, sigma_px=3.0), **kw)
    return tw.build_weakform_dataset(torch.from_numpy(U), **kw), jw.build_weakform_dataset(jnp.asarray(U), **kw)


def _columns_close(got, want, skip=()):
    (gn, gX, gy), (wn, wX, wy) = got, want
    wX, wy = np.asarray(wX), np.asarray(wy)
    assert gn == wn and gX.shape == wX.shape and gy.shape == wy.shape and gX.dtype == torch.float64
    np.testing.assert_allclose(gy.numpy(), wy, rtol=0, atol=TOL * np.abs(wy).max(), err_msg="y")
    for j, name in enumerate(gn):
        if name not in skip:
            scale = np.abs(wX[:, j]).max()
            assert scale > 0, name
            np.testing.assert_allclose(gX[:, j].numpy(), wX[:, j], rtol=0, atol=TOL * scale, err_msg=name)


def test_test_functions_are_the_same_host_arrays():
    for got, want in zip(tw.fourier_test_functions(NX, NY, 10.0, 8.0, max_k=3), jw.fourier_test_functions(NX, NY, 10.0, 8.0, max_k=3)):
        np.testing.assert_array_equal(got, want)
    got = tw.gaussian_test_functions(NX, NY, n_phi=9, sigma_px=3.0)
    np.testing.assert_array_equal(got, jw.gaussian_test_functions(NX, NY, n_phi=9, sigma_px=3.0))
    assert got.shape == (9, NX, NY) and got.dtype == np.float64
    with pytest.raises(ValueError, match="positive sigma_px"):
        tw.gaussian_test_functions(NX, NY, n_phi=2, sigma_px=0.0)


@pytest.mark.parametrize("dictionary", ["true", "rich"])
@pytest.mark.parametrize("operator", ["spectral", "fd"])
@pytest.mark.parametrize("basis", ["gaussian", "fourier"])
def test_dataset_matches_pdx(basis, operator, dictionary):
    U, DT = _frames()
    got, want = _both(U, DT, basis=basis, operator=operator, dictionary=dictionary)
    fault = basis == "fourier" and dictionary == "rich"
    _columns_close(got, want, skip=("one",) if fault else ())
    P = 16 if basis == "fourier" else 7
    assert got[1].shape == ((U.shape[0] - 1) * P, 3 if dictionary == "true" else 9)
    if fault:
        # analytically zero: pdx keeps the sum's round-off, the port exact zeros
        assert float(np.abs(np.asarray(want[1])[:, 0]).max()) < 1e-10
        assert torch.count_nonzero(got[1][:, 0]) == 0


def test_grad_cutoff():
    U, DT = _frames()
    _columns_close(*_both(U, DT, basis="gaussian", grad_cutoff=0.4))
    default, _ = _both(U, DT, basis="gaussian")
    explicit = tw.build_weakform_dataset(
        torch.from_numpy(U), dx=DX, dy=DX, dt_frame=DT, lx=NX * DX, ly=NY * DX, n_phi=7, sigma_px=3.0, grad_cutoff=0.65
    )
    assert torch.equal(default[1], explicit[1])  # None means 0.65


@pytest.mark.parametrize("kw,match", [
    (dict(operator="fd", grad_cutoff=0.5), "grad_cutoff only applies"),
    (dict(operator="nope"), "operator must be"),
    (dict(basis="nope"), "unknown weak-form basis"),
    (dict(dictionary="nope"), "dictionary must be"),
])
def test_bad_options_raise_as_in_pdx(kw, match):
    U, DT = _frames()
    args = dict(dx=DX, dy=DX, dt_frame=DT, lx=NX * DX, ly=NY * DX, **kw)
    with pytest.raises(ValueError, match=match):
        tw.build_weakform_dataset(torch.from_numpy(U), **args)
    with pytest.raises(ValueError, match=match):
        jw.build_weakform_dataset(jnp.asarray(U), **args)
    with pytest.raises(ValueError, match="frame stack"):
        tw.build_weakform_dataset(torch.from_numpy(U[0]), **args)


@pytest.mark.parametrize("kw", [
    dict(motion_clip_px=None),
    dict(motion_clip_px=0.75),
    dict(motion_clip_px=1.5, motion_est_sigma_px=1.0, motion_smooth_window=3, operator="fd", dictionary="rich"),
], ids=["no_clip", "clip", "clip_smoothed_fd_rich"])
def test_motion_correction_matches_pdx(kw):
    """Jittered, noisy frames: the estimated shifts (up to 2 px) are clipped
    or not, smoothed or not, and enter the target through <u, grad phi>."""
    U, DT = _frames(perturbed=True)
    got, want = _both(U, DT, basis="gaussian", motion_correct=True, **kw)
    _columns_close(got, want)
    plain, _ = _both(U, DT, basis="gaussian", **{k: v for k, v in kw.items() if k in ("operator", "dictionary")})
    assert not torch.allclose(got[2], plain[2])
    if kw["motion_clip_px"] == 0.75:
        unclipped, _ = _both(U, DT, basis="gaussian", motion_correct=True)
        assert not torch.allclose(got[2], unclipped[2])


def test_float32_frames_give_float32_columns():
    """The test functions are built in float64 on the host and cast to the
    frames' dtype; float32 columns sit within 1e-4 of the float64 ones."""
    U, DT = _frames()
    kw = dict(dx=DX, dy=DX, dt_frame=DT, lx=NX * DX, ly=NY * DX, n_phi=7, sigma_px=3.0, dictionary="rich")
    _n, X32, y32 = tw.build_weakform_dataset(torch.from_numpy(U.astype(np.float32)), **kw)
    _n, X64, y64 = tw.build_weakform_dataset(torch.from_numpy(U), **kw)
    assert X32.dtype == y32.dtype == torch.float32
    scale = X64.abs().amax(dim=0)
    assert float(((X32.double() - X64).abs().amax(dim=0) / scale).max()) < 1e-4


RICH_FOURIER = dict(Nx=48, Ny=48, n_seconds=0.4, dt=1e-3, method="weakform", weak_basis="fourier",
                    dictionary="rich", n_sample=50_000, alpha=1e-6, threshold=1e-3)


def test_rich_fourier_weakform_recovers_true_terms(monkeypatch):
    """pdx's own end-to-end rich-Fourier case. Jitted pdx fails it (the
    `one` coefficient comes out at ~-2e9); the port passes its assertions
    and agrees with pdx run eagerly (jax.disable_jit(), where the `one`
    column sums to exactly 0) at 1e-8 of max|coef|. Only pdx's weak-form
    build, where the fault sits, runs eagerly; the rest of its run is jitted."""
    res = tb.run(tb.Ks2dBenchConfig(**RICH_FOURIER), "cpu")
    assert res["names"] == ["one", "u", "u2", "ux", "uy", "lap", "bih", "gradsq", "u_lap"]
    assert res["gt_errors"]["lap"]["rel_err_pct"] < 5.0, res["gt_errors"]
    assert res["gt_errors"]["bih"]["rel_err_pct"] < 20.0, res["gt_errors"]
    coeffs = dict(zip(res["names"], res["coeffs"]))
    for decoy in ("one", "u", "ux", "uy"):
        assert abs(coeffs[decoy]) < 0.1, coeffs
    assert res["fit"]["test_r2"] > 0.9
    assert coeffs["one"] == 0.0

    def eager_build(*args, **kwargs):
        with jax.disable_jit():
            return jw.build_weakform_dataset(*args, **kwargs)

    monkeypatch.setattr(jb, "build_weakform_dataset", eager_build)
    want = jb.run(jb.Ks2dBenchConfig(**RICH_FOURIER))
    w = np.asarray(want["coeffs"])
    assert w[0] == 0.0 and abs(w[5] + 1.0) < 0.05
    np.testing.assert_allclose(res["coeffs"], w, rtol=0, atol=1e-8 * np.abs(w).max())
    np.testing.assert_allclose(res["fit"]["test_r2"], want["fit"]["test_r2"], rtol=1e-9)
    np.testing.assert_allclose(res["rollout"]["mean"], want["rollout"]["mean"], rtol=1e-6)
