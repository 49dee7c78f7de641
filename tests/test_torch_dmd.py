"""pdx_torch.solve.dmd against pdx.solve.dmd, float64.

Tolerances, and why:

* on noisy stacks (every singular value of the snapshot matrix well above
  the 1e-10 floor) standard, multiscale and sparse DMD reconstructions agree
  within 1e-10 of max|stack| (measured ~1e-14): the same SVD-projected
  operator, the same host eigendecomposition, the same minimum-norm
  amplitudes;
* on a clean low-rank stack the modes beyond the rank are round-off
  directions whose eigenvectors differ between any two SVDs; the standard
  and multiscale reconstructions, which these modes barely touch, agree
  within 1e-8 of max|stack|, and ``sparse_dmd`` is not compared there (its
  percentile picks among those directions: fault F7);
* the minimum-norm solve against ``np.linalg.lstsq`` and ``jnp.linalg.lstsq``
  within 1e-10 of max|x| on an ill-conditioned, rank-deficient stacking.
"""

import numpy as np
import pytest
import torch

import pdx_torch.solve.dmd as tdmd
from torch_card import cuda


def _pdx():
    """pdx's DMD and jax.numpy, imported inside the tests so that the ``gpu``
    tests run on a machine without jax (``pytest --noconftest -m gpu``)."""
    import jax.numpy as jnp

    import pdx.solve.dmd as jdmd

    return jdmd, jnp


def lowrank(T=30, n=16):
    """Two decaying travelling modes (pdx's tests/test_comprehensive.py)."""
    t = np.arange(T)[:, None, None]
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    X, Y = np.meshgrid(x, x, indexing="ij")
    return np.exp(-0.01 * t) * np.sin(X + 0.1 * t) * np.cos(Y) + 0.5 * np.exp(-0.05 * t) * np.cos(2 * X - 0.2 * t)


def noisy(T=30, n=16, seed=0):
    return lowrank(T, n) + 0.05 * np.random.default_rng(seed).normal(size=(T, n, n))


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


CALLS = {
    "standard_r10": (lambda m, d: m.standard_dmd(d, rank=10)),
    "standard_none": (lambda m, d: m.standard_dmd(d)),
    "standard_r50": (lambda m, d: m.standard_dmd(d, rank=50)),
    "multiscale": (lambda m, d: m.multiscale_dmd(d)),
    "multiscale_8_20": (lambda m, d: m.multiscale_dmd(d, low_rank=8, high_rank=20)),
    "sparse_r10": (lambda m, d: m.sparse_dmd(d, rank=10)),
    "sparse_r50": (lambda m, d: m.sparse_dmd(d, rank=50)),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_noisy_reconstruction_matches_pdx(name):
    jdmd, jnp = _pdx()
    U = noisy()
    got = CALLS[name](tdmd, torch.from_numpy(U))
    assert got.shape == U.shape and got.is_contiguous()
    assert _rel(got, CALLS[name](jdmd, jnp.asarray(U))) < 1e-10


@pytest.mark.parametrize("name", [n for n in CALLS if not n.startswith("sparse")])
def test_clean_lowrank_reconstruction_matches_pdx(name):
    jdmd, jnp = _pdx()
    U = lowrank()
    got = CALLS[name](tdmd, torch.from_numpy(U))
    assert _rel(got, CALLS[name](jdmd, jnp.asarray(U))) < 1e-8
    if name == "standard_r10":
        assert np.abs(got.numpy() - U).max() / np.abs(U).max() < 1e-3


def test_standard_dmd_matches_numpy_oracle():
    """The reference algorithm in numpy/scipy (pdx's oracle test)."""
    from scipy.linalg import lstsq as scipy_lstsq

    U = noisy(T=20, n=8, seed=3)
    rank = 6
    got = tdmd.standard_dmd(torch.from_numpy(U), rank=rank).numpy()
    X = U.reshape(20, -1).T
    X1, X2 = X[:, :-1], X[:, 1:]
    Uu, s, Vh = np.linalg.svd(X1, full_matrices=False)
    Uu, s, Vh = Uu[:, :rank], s[:rank], Vh[:rank]
    At = Uu.T @ X2 @ Vh.T @ np.diag(1 / s)
    ev, W = np.linalg.eig(At)
    Phi = X2 @ Vh.T @ np.diag(1 / s) @ W
    b = scipy_lstsq(Phi, X[:, 0], cond=1e-10)[0]
    want = np.real(np.stack([Phi @ (b * ev**t) for t in range(20)]).reshape(U.shape))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("T,rank,expect", [(12, None, 10), (12, 50, 10), (12, 5, 5)])
def test_standard_rank_is_capped_at_T_minus_2(T, rank, expect, monkeypatch):
    """r = min(rank or T - 1, T - 1, T - 2), as pdx."""
    seen = []
    real = tdmd._project
    monkeypatch.setattr(tdmd, "_project", lambda X1, X2, r: seen.append(r) or real(X1, X2, r))
    tdmd.standard_dmd(torch.from_numpy(noisy(T=T, n=6)), rank=rank)
    assert seen == [expect]


@pytest.mark.parametrize("T,rank,expect", [(12, 50, 11), (12, 5, 5)])
def test_sparse_rank_is_capped_at_T_minus_1(T, rank, expect, monkeypatch):
    seen = []
    real = tdmd._project
    monkeypatch.setattr(tdmd, "_project", lambda X1, X2, r: seen.append(r) or real(X1, X2, r))
    tdmd.sparse_dmd(torch.from_numpy(noisy(T=T, n=6)), rank=rank)
    assert seen == [expect]


@pytest.mark.parametrize("dtype,floor", [(np.float64, lambda s0: 1e-10), (np.float32, lambda s0: s0 * 100 * np.finfo(np.float32).eps)])
def test_singular_value_floor(dtype, floor):
    """Singular values below the floor are raised to it: 1e-10 in float64
    (the reference's), s[0] * 100 eps in float32. Each column of M = X2 V
    diag(1 / s) then has the norm ||X2 v_k|| / max(s_k, floor), whatever
    the signs of the singular vectors."""
    rng = np.random.default_rng(4)
    Uq, _ = np.linalg.qr(rng.normal(size=(30, 5)))
    Vq, _ = np.linalg.qr(rng.normal(size=(5, 5)))
    s = np.array([2.0, 1.0, 1e-3, 1e-6, 1e-12])
    X1, X2 = ((Uq * s) @ Vq.T).astype(dtype), rng.normal(size=(30, 5)).astype(dtype)
    M, _ = tdmd._project(torch.from_numpy(X1), torch.from_numpy(X2), 5)
    _, s_got, Vh = np.linalg.svd(X1.astype(np.float64), full_matrices=False)
    s_reg = np.maximum(s_got, floor(s_got[0]))
    want = np.linalg.norm(X2.astype(np.float64) @ Vh.T, axis=0) / s_reg
    big = s_got > floor(s_got[0])  # columns past the floor are round-off directions, norms only bounded
    np.testing.assert_allclose(np.linalg.norm(M.numpy().astype(np.float64), axis=0)[big], want[big],
                               rtol=1e-10 if dtype == np.float64 else 1e-4)
    assert np.linalg.norm(M.numpy(), axis=0).max() <= 1.01 * np.linalg.norm(X2, axis=0).sum() / floor(s_got[0])


def test_float32_floor_is_relative():
    """float32: the floor is s[0] * 100 eps; the clean low-rank stack stays
    finite and within 1e-3 of pdx's float32 result."""
    jdmd, jnp = _pdx()
    U = lowrank().astype(np.float32)
    got = tdmd.standard_dmd(torch.from_numpy(U), rank=10)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got, jdmd.standard_dmd(jnp.asarray(U), rank=10)) < 1e-3


def test_host_syncs_two_per_call():
    U = torch.from_numpy(noisy(T=12, n=6))
    before = tdmd.HOST_SYNCS.count
    tdmd.standard_dmd(U, rank=5)
    tdmd.sparse_dmd(U, rank=5)
    tdmd.multiscale_dmd(U)
    assert tdmd.HOST_SYNCS.count - before == 2 + 2 + 4


def _ill_conditioned(seed=0, n=40, r=6):
    """A real 2n x 2r stacking [[Pr, -Pi], [Pi, Pr]] whose columns span 5
    decades and two of which repeat others (rank 2r - 2)."""
    rng = np.random.default_rng(seed)
    Pr = rng.normal(size=(n, r)) * np.logspace(0, -5, r)
    Pi = rng.normal(size=(n, r)) * np.logspace(0, -5, r)
    Pr[:, -1], Pi[:, -1] = Pr[:, 0], Pi[:, 0]
    A = np.block([[Pr, -Pi], [Pi, Pr]])
    return A, np.concatenate([rng.normal(size=n), np.zeros(n)])


@pytest.mark.parametrize("seed", [0, 1])
def test_min_norm_lstsq_on_an_ill_conditioned_stacking(seed):
    """The minimum-norm solution (not QR's, which assumes full rank), with
    jnp.linalg.lstsq's cutoff."""
    _, jnp = _pdx()
    A, b = _ill_conditioned(seed)
    got = tdmd.lstsq_min_norm(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    want = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    jx = np.asarray(jnp.linalg.lstsq(jnp.asarray(A), jnp.asarray(b))[0])
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-10 * np.abs(jx).max())


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_min_norm_lstsq_on_the_card(cuda, seed):
    """The SVD-based amplitude solve on the card against np.linalg.lstsq."""
    A, b = _ill_conditioned(seed)
    got = tdmd.lstsq_min_norm(torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)).cpu().numpy()
    want = np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CALLS))
def test_noisy_reconstruction_on_the_card(cuda, name):
    """cuSOLVER's SVD against LAPACK's: within 1e-10 of max|stack|, the
    singular-vector signs notwithstanding."""
    U = torch.from_numpy(noisy())
    got = CALLS[name](tdmd, U.to(cuda)).cpu()
    assert _rel(got, CALLS[name](tdmd, U).numpy()) < 1e-10
