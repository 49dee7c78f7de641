"""pdx_torch.register.ecc against pdx.register.ecc, float64, on smooth random
fields shifted (and rotated) by known amounts.

``pdx`` runs one ``while_loop`` a frame pair; the port runs a batch of pairs
and freezes each member at the iteration where its own loop stops. Every
result (params, cc, warped frames, registered sequences) is held within
1e-10 of max|value| of ``pdx``'s (measured ~4e-15: the sampler's bilinear
blend and the reductions round in another order), and each member's
iteration count must equal ``pdx``'s. ``pdx`` does not return its count; it
is the least ``max_iter`` that reproduces its full result: ``pdx`` run with
``max_iter`` = the port's count gives the same params bit for bit, and with
one iteration fewer it does not.

The ``gpu`` tests hold the card against the CPU (the same tolerance, the
same counts); ``pdx`` is imported inside the tests, so that those run on a
machine without jax (``python -m pytest --noconftest -m gpu ...``).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, rotate, shift as ndshift

from pdx_torch.register import ecc as tec
from torch_card import cuda

TOL = 1e-10
SHIFTS = [(0.3, -0.2), (1.5, 0.7), (-0.8, 1.1), (0.0, 0.0)]


def _pdx():
    import jax.numpy as jnp
    from pdx.register import ecc as jec

    return jnp, jec


def field(n=48, seed=1, sigma=4):
    f = gaussian_filter(np.random.default_rng(seed).normal(size=(n, n)), sigma)
    return (f - f.min()) / (f.max() - f.min())


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-300))


def _pairs():
    base = field()
    movs = [ndshift(base, s, mode="reflect") for s in SHIFTS]
    movs.append(rotate(base, 2.0, reshape=False, mode="reflect"))  # a rotation for the euclidean motion
    return np.stack([base] * len(movs)), np.stack(movs)


def _assert_pdx_iterations(jnp, jec, template, image, n_iter, want_params, **kw):
    """pdx stops after exactly n_iter iterations."""
    again, _ = jec.ecc_align(jnp.asarray(template), jnp.asarray(image), max_iter=n_iter, **kw)
    fewer, _ = jec.ecc_align(jnp.asarray(template), jnp.asarray(image), max_iter=n_iter - 1, **kw)
    assert np.array_equal(np.asarray(again), np.asarray(want_params))
    assert not np.array_equal(np.asarray(fewer), np.asarray(want_params))


@pytest.mark.parametrize("motion", ["euclidean", "translation"])
@pytest.mark.parametrize("gauss_sigma", [0.0, 1.0])
def test_batched_align_equals_pdx_pair_by_pair(motion, gauss_sigma):
    """Members that stop at different iterations (the identity pair after
    one), each frozen at its own stop. Params are compared as one array of
    the batch: the identity pair's are round-off (~1e-16)."""
    jnp, jec = _pdx()
    T, I = _pairs()
    kw = dict(motion=motion, gauss_sigma=gauss_sigma)
    params, cc, n_iter = tec.ecc_align_batch(torch.from_numpy(T), torch.from_numpy(I), **kw)
    assert len(set(n_iter.tolist())) > 2, n_iter  # the batch really mixes stops
    want = [jec.ecc_align(jnp.asarray(T[k]), jnp.asarray(I[k]), **kw) for k in range(T.shape[0])]
    _close(params, np.stack([np.asarray(p) for p, _ in want]))
    _close(cc, np.stack([np.asarray(c) for _, c in want]))
    for k, (pj, _) in enumerate(want):
        _assert_pdx_iterations(jnp, jec, T[k], I[k], int(n_iter[k]), pj, **kw)
    warped = tec.ecc_warp(torch.from_numpy(I), params, motion=motion)  # one batch
    _close(warped, np.stack([np.asarray(jec.ecc_warp(jnp.asarray(I[k]), pj, motion=motion)) for k, (pj, _) in enumerate(want)]))
    # ecc_align on one pair: the same function as a member of the batch
    p0, cc0 = tec.ecc_align(torch.from_numpy(T[1]), torch.from_numpy(I[1]), **kw)
    _close(p0, want[1][0])
    _close(cc0, want[1][1])


@pytest.mark.parametrize("motion", ["euclidean", "translation"])
def test_max_iter_caps_each_member(motion):
    """max_iter 3: members still moving stop at 3 with pdx's params; max_iter 0
    returns the initial state (zero params, cc 0), as pdx's loop does."""
    jnp, jec = _pdx()
    T, I = _pairs()
    params, cc, n_iter = tec.ecc_align_batch(torch.from_numpy(T), torch.from_numpy(I), motion=motion, max_iter=3)
    assert n_iter.max() == 3 and n_iter.min() == 1
    want = [jec.ecc_align(jnp.asarray(T[k]), jnp.asarray(I[k]), motion=motion, max_iter=3) for k in range(T.shape[0])]
    _close(params, np.stack([np.asarray(p) for p, _ in want]))
    _close(cc, np.stack([np.asarray(c) for _, c in want]))
    params, cc, n_iter = tec.ecc_align_batch(torch.from_numpy(T), torch.from_numpy(I), motion=motion, max_iter=0)
    assert not params.any() and not cc.any() and not n_iter.any()


@pytest.mark.parametrize("check_every", [1, 7, 50])
def test_stop_checks_change_no_result(monkeypatch, check_every):
    """The host's "any running" check only ends the loop early: the same
    results for any check interval."""
    T, I = _pairs()
    want = tec.ecc_align_batch(torch.from_numpy(T), torch.from_numpy(I), gauss_sigma=1.0)
    monkeypatch.setattr(tec, "CHECK_EVERY", check_every)
    got = tec.ecc_align_batch(torch.from_numpy(T), torch.from_numpy(I), gauss_sigma=1.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _sequences(n_seq=3, T=5, n=40, noise=True):
    """Drifting sequences, a different drift each; with ``noise`` the last
    one's last frame is noise uncorrelated with the rest (the guard must
    fire there)."""
    seqs = []
    for s in range(n_seq):
        f = field(n, seed=10 + s)
        seqs.append([ndshift(f, (0.35 * t * (s + 1) / 2, -0.25 * t), mode="reflect") for t in range(T)])
    if noise:
        seqs[-1][-1] = np.random.default_rng(3).normal(size=(n, n))
    return np.asarray(seqs)


@pytest.mark.parametrize("motion", ["euclidean", "translation"])
def test_register_sequence_equals_pdx_patch_by_patch(motion):
    """All sequences as one batch against pdx's loop over them: registered
    frames, ccs, and every step's iteration count; the divergence guard
    passes the noise frame through unwarped."""
    jnp, jec = _pdx()
    seqs = _sequences()
    kw = dict(motion=motion, gauss_sigma=1.0, cc_threshold=0.3)
    out, ccs, iters, syncs = tec.register_sequence_info(torch.from_numpy(seqs), **kw)
    assert out.shape == seqs.shape and ccs.shape == iters.shape == (seqs.shape[0], seqs.shape[1] - 1)
    assert syncs >= seqs.shape[1] - 1
    want = [jec.ecc_register_sequence(jnp.asarray(seqs[k]), **kw) for k in range(seqs.shape[0])]
    _close(out, np.stack([np.asarray(o) for o, _ in want]))
    want_ccs = np.stack([np.asarray(c) for _, c in want])
    assert ccs[-1, -1] < 0.3 and want_ccs[-1, -1] < 0.3  # the noise frame: the guard fired on both sides
    assert torch.equal(out[-1, -1], torch.from_numpy(seqs[-1, -1]))  # and passed it through untouched
    _close(ccs, want_ccs)
    ref = np.asarray(want[-1][0])
    for t in range(1, seqs.shape[1]):  # the last sequence's counts (every kind of step), against pdx's
        tmpl, img = (gaussian_filter_np(ref[t - 1]), gaussian_filter_np(seqs[-1, t]))
        pj, _ = jec.ecc_align(jnp.asarray(tmpl), jnp.asarray(img), motion=motion)
        _assert_pdx_iterations(jnp, jec, tmpl, img, int(iters[-1, t - 1]), pj, motion=motion)
    got, got_ccs = tec.ecc_register_sequence(torch.from_numpy(seqs), **kw)
    assert torch.equal(got, out) and torch.equal(got_ccs, ccs)


def gaussian_filter_np(f):
    """The smoothing ecc_register_sequence applies with gauss_sigma=1, as
    pdx computes it (the port's is held to it in test_torch_filters.py)."""
    import jax.numpy as jnp
    from pdx.ops.filters import gaussian_filter_reflect

    return np.asarray(gaussian_filter_reflect(jnp.asarray(f), 1.0))


def test_guard_on_non_finite_params():
    """A member whose params are not finite passes through unwarped, whatever
    the threshold; the other member of the batch registers, as in pdx."""
    jnp, jec = _pdx()
    seqs = _sequences(n_seq=2, T=2, noise=False)
    seqs[0, 1, 5, 5] = np.nan  # spreads into the gradient, the sums and the params
    kw = dict(cc_threshold=-np.inf, max_iter=5)
    out, ccs = tec.ecc_register_sequence(torch.from_numpy(seqs), **kw)
    assert torch.equal(out[0, 1].nan_to_num(), torch.from_numpy(seqs[0, 1]).nan_to_num())
    assert not torch.equal(out[1, 1], torch.from_numpy(seqs[1, 1]))
    for k in range(2):
        oj, _ = jec.ecc_register_sequence(jnp.asarray(seqs[k]), **kw)
        _close(out[k].nan_to_num(), np.nan_to_num(np.asarray(oj)))


@pytest.mark.gpu
@pytest.mark.parametrize("motion", ["euclidean", "translation"])
def test_batched_ecc_card_equals_cpu(cuda, motion):
    seqs = torch.from_numpy(_sequences(n_seq=4, T=6, n=64))
    kw = dict(motion=motion, gauss_sigma=1.0, cc_threshold=0.3)
    on_card = tec.register_sequence_info(seqs.to(cuda), **kw)
    on_cpu = tec.register_sequence_info(seqs, **kw)
    _close(on_card[0].cpu(), on_cpu[0])
    _close(on_card[1].cpu(), on_cpu[1])
    assert torch.equal(on_card[2].cpu(), on_cpu[2])
