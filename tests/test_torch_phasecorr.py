"""pdx_torch.register.phasecorr against pdx.register.phasecorr, float64.

The fields have one clear correlation peak per pair, so the integer argmax
is the same on both sides and only FFT round-off separates the subpixel
centroids: estimated shifts agree at 1e-9 (absolute, pixels) and stabilised
stacks at 1e-9 of max|ref|. Phase-only correlation divides every Fourier bin
by its magnitude, which magnifies the round-off of bins near zero; so the
fields are only lightly smoothed (sigma 1 px) and the estimation smoothing
is 0.6 px, which keeps every bin far above round-off. (With sigma 4 px
fields the two packages' FFTs already part at ~1e-6 px.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from pdx.ops.interp import shift_periodic as jshift
from pdx.register import phasecorr as jpc
from pdx_torch.register import phasecorr as tpc

TOL = 1e-9


def _field(n=48, seed=0):
    rng = np.random.default_rng(seed)
    f = gaussian_filter(rng.normal(size=(n, n)), 1.0, mode="wrap")
    return (f - f.min()) / (f.max() - f.min())


@pytest.fixture(scope="module")
def trajectory():
    """A smooth field under a known jitter of subpixel shifts, 7 frames."""
    base = _field()
    s = np.random.default_rng(1).uniform(-2.0, 2.0, size=(6, 2))
    frames = [base] + [np.asarray(jshift(jnp.asarray(base), a, b)) for a, b in s]
    return np.stack(frames), s


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_phase_correlate_pairs(trajectory):
    U, _s = trajectory
    got = tpc.phase_correlate(torch.from_numpy(U[:-1]), torch.from_numpy(U[1:]))
    want = jpc.phase_correlate(jnp.asarray(U[:-1]), jnp.asarray(U[1:]))
    for g, w in zip(got, want):
        assert g.shape == (6,)
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=TOL)


def test_estimate_shift_recovers_known_shift(trajectory):
    U, s = trajectory
    sx, sy = tpc.estimate_shift_phasecorr(torch.from_numpy(U[0]), torch.from_numpy(U[3]))
    jx, jy = jpc.estimate_shift_phasecorr(jnp.asarray(U[0]), jnp.asarray(U[3]))
    np.testing.assert_allclose([float(sx), float(sy)], [float(jx), float(jy)], rtol=0, atol=TOL)
    # the shift that aligns frame 3 undoes its jitter, to the centroid's ~0.3 px
    np.testing.assert_allclose([float(sx), float(sy)], -s[2], atol=0.45)


@pytest.mark.parametrize("sigma", [0.0, 0.6])
def test_interframe_shifts(trajectory, sigma):
    U, _s = trajectory
    got = tpc.estimate_interframe_shifts(torch.from_numpy(U), estimate_sigma_px=sigma)
    want = jpc.estimate_interframe_shifts(jnp.asarray(U), estimate_sigma_px=sigma)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["to_first", "to_prev"])
@pytest.mark.parametrize("sigma", [0.0, 0.6])
def test_stabilize(trajectory, mode, sigma):
    U, _s = trajectory
    got = tpc.stabilize_translation_sequence(torch.from_numpy(U), mode=mode, estimate_sigma_px=sigma)
    want = np.asarray(jpc.stabilize_translation_sequence(jnp.asarray(U), mode=mode, estimate_sigma_px=sigma))
    assert got.shape == U.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    # and it does stabilise: every frame closer to frame 0 than before
    before = np.sqrt(np.mean((U[1:] - U[:1]) ** 2, axis=(1, 2)))
    after = np.sqrt(np.mean((got.numpy()[1:] - U[:1]) ** 2, axis=(1, 2)))
    assert (after < 0.5 * before).all()


def test_reflect_border_and_bad_mode_raise(trajectory):
    U = torch.from_numpy(trajectory[0])
    with pytest.raises(NotImplementedError, match="slice 3"):
        tpc.stabilize_translation_sequence(U, border="reflect")
    with pytest.raises(NotImplementedError, match="slice 3"):
        tpc.stabilize_translation_sequence(U, smooth="reflect")
    with pytest.raises(ValueError, match="mode"):
        tpc.stabilize_translation_sequence(U, mode="sideways")
