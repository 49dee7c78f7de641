"""pdx_torch.sim.perturb (N1-N7) and pdx_torch.ops.interp against pdx, float64.

Both packages draw on the host with np.random.default_rng(noise_seed) in the
reference's order (pdx takes its host-RNG branch on the CPU), so the noise
fields are identical and the perturbed stacks agree at rtol 1e-12 with an
absolute floor of 1e-12 * max|ref|. The N3/N6/N7 blur is the FFT Gaussian
on both sides and is held to pdx at the same 1e-12 (not to cv2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdx.ops import interp as jint
from pdx.sim import perturb as jpt
from pdx_torch.ops import interp as tint
from pdx_torch.sim import perturb as tpt

TOL = 1e-12
KINDS = ["none", "N1_shifts", "N2_noise", "N3_blur", "N4_drift", "N5_shifts_noise", "N6_blur_noise", "N7_all"]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.fixture
def stack():
    return np.random.default_rng(0).uniform(-0.1, 0.1, size=(6, 16, 20))


def test_config_fields_and_defaults_match_pdx():
    want = [(f.name, f.default) for f in dataclasses.fields(jpt.PerturbConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(tpt.PerturbConfig)] == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["constant", "jitter"])
def test_suite_matches_pdx_host_draws(stack, kind, mode):
    kw = dict(perturbation=kind, noise_rel=0.05, noise_seed=7, shift_max_px=1.3, shift_mode=mode)
    got = tpt.apply_perturbation_suite(torch.from_numpy(stack), tpt.PerturbConfig(**kw))
    want = jpt.apply_perturbation_suite(jnp.asarray(stack), jpt.PerturbConfig(**kw))
    assert got.shape == stack.shape and got.dtype == torch.float64
    _close(got, want)


def test_unknown_options_raise(stack):
    with pytest.raises(ValueError, match="Unknown perturbation"):
        tpt.apply_perturbation_suite(torch.from_numpy(stack), tpt.PerturbConfig(perturbation="N9"))
    with pytest.raises(ValueError, match="shift_mode"):
        tpt.apply_perturbation_suite(torch.from_numpy(stack), tpt.PerturbConfig(perturbation="N1_shifts", shift_mode="x"))


def test_noise_uses_population_std(stack):
    """sigma = noise_rel * np.std (ddof 0): the noise is the seed's normal
    draws times exactly that sigma."""
    got = tpt.apply_perturbation_suite(torch.from_numpy(stack), tpt.PerturbConfig(perturbation="N2_noise", noise_rel=0.1))
    draws = np.random.default_rng(999).normal(0.0, 0.1 * np.std(stack), size=stack.shape)
    np.testing.assert_allclose(got.numpy() - stack, draws, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("sx,sy", [(0.0, 0.0), (1.0, -2.0), (0.37, -1.61), (-2.5, 3.25)])
def test_shift_periodic_single_frame(stack, sx, sy):
    got = tint.shift_periodic(torch.from_numpy(stack[0]), sx, sy)
    _close(got, jint.shift_periodic(jnp.asarray(stack[0]), sx, sy))


def test_shift_periodic_per_frame_matches_vmap(stack):
    s = np.random.default_rng(1).uniform(-2, 2, size=(2, stack.shape[0]))
    got = tint.shift_periodic(torch.from_numpy(stack), torch.from_numpy(s[0]), torch.from_numpy(s[1]))
    want = jax.vmap(jint.shift_periodic)(jnp.asarray(stack), jnp.asarray(s[0]), jnp.asarray(s[1]))
    _close(got, want)


def test_bilinear_sample_periodic(stack):
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-20, 40, size=(2, 5, 7))
    got = tint.bilinear_sample_periodic(torch.from_numpy(stack), torch.from_numpy(x), torch.from_numpy(y))
    want = jint.bilinear_sample_periodic(jnp.asarray(stack), jnp.asarray(x), jnp.asarray(y))
    assert got.shape == (6, 5, 7)
    _close(got, want)
