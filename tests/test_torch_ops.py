"""pdx_torch.ops (fd, metrics, linalg) against pdx.ops, float64, rtol 1e-12
(the stencils within 1e-12 of each field's largest value).

The same numpy inputs go through both packages; the port keeps pdx's
operation order, so only reassociation inside XLA / LAPACK separates them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdx_torch
from pdx.ops import fd as jfd
from pdx.ops import linalg as jlin
from pdx.ops import metrics as jmet
from pdx_torch.ops import fd as tfd
from pdx_torch.ops import linalg as tlin
from pdx_torch.ops import metrics as tmet

RTOL = 1e-12


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.fixture
def field():
    return np.random.default_rng(0).normal(size=(5, 16, 24))


class TestPrecisionPin:
    def test_tf32_off_and_highest(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"

    def test_resolve_device_and_dtype(self):
        """No silent CPU fallback: without a card resolve_device() raises."""
        assert pdx_torch.resolve_device("cpu") == torch.device("cpu")
        if torch.cuda.is_available():
            assert pdx_torch.resolve_device().type == "cuda"
        else:
            for asked in (None, "cuda"):
                with pytest.raises(RuntimeError, match="no CUDA card"):
                    pdx_torch.resolve_device(asked)
        assert pdx_torch.resolve_dtype("float32") is torch.float32
        assert pdx_torch.resolve_dtype("float64") is torch.float64
        with pytest.raises(ValueError, match="dtype"):
            pdx_torch.resolve_dtype("bfloat16")


class TestFd:
    @pytest.mark.parametrize("name", ["laplacian_periodic", "biharmonic_periodic"])
    def test_scalar_stencils(self, field, name):
        got = getattr(tfd, name)(torch.from_numpy(field), 0.5, 0.25)
        want = getattr(jfd, name)(jnp.asarray(field), 0.5, 0.25)
        _close(got, want, atol=1e-12 * np.abs(_np(want)).max())

    def test_gradients(self, field):
        gx, gy = tfd.gradients_periodic(torch.from_numpy(field), 0.5, 0.25)
        jx, jy = jfd.gradients_periodic(jnp.asarray(field), 0.5, 0.25)
        _close(gx, jx)
        _close(gy, jy)

    @pytest.mark.parametrize("name", [
        "gradients_central_interior", "derivs_2d_reflect", "gradients_4th_order", "second_derivs_4th_order",
    ])
    def test_non_periodic_stencils(self, field, name):
        """The real-image stencils (reflect-101, one-sided edges, 4th order),
        on a leading batch of frames, within 1e-12 of each field's max."""
        got = getattr(tfd, name)(torch.from_numpy(field), 0.5, 0.25)
        want = getattr(jfd, name)(jnp.asarray(field), 0.5, 0.25)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol=1e-12 * np.abs(_np(w)).max())

    @pytest.mark.parametrize("axis", [0, 1, 2, -1])
    def test_gradient_edge2(self, field, axis):
        """np.gradient(edge_order=2) along any axis, against pdx and numpy."""
        got = tfd.gradient_edge2(torch.from_numpy(field), 0.7, axis)
        _close(got, jfd.gradient_edge2(jnp.asarray(field), 0.7, axis), atol=1e-12 * np.abs(field).max())
        _close(got, np.gradient(field, 0.7, axis=axis, edge_order=2), atol=1e-12 * np.abs(field).max())

    @pytest.mark.parametrize("dx", [0.5, 0.37])
    def test_d4_1d_periodic(self, field, dx):
        """The 1-D periodic fourth difference on the trailing axis."""
        got = tfd.d4_1d_periodic(torch.from_numpy(field), dx)
        _close(got, jfd.d4_1d_periodic(jnp.asarray(field), dx), atol=1e-12 * np.abs(_np(got)).max())
        f = field[0, 0]
        want = (np.roll(f, -2) - 4 * np.roll(f, -1) + 6 * f - 4 * np.roll(f, 1) + np.roll(f, 2)) / dx**4
        _close(got[0, 0], want)

    def test_reflect_is_reflect101(self):
        """derivs_2d_reflect pads like np.pad(mode="reflect"), not symmetric."""
        f = np.random.default_rng(4).normal(size=(6, 7))
        p = np.pad(f, 1, mode="reflect")
        ux, uy, uxx, uyy = tfd.derivs_2d_reflect(torch.from_numpy(f), 1.0, 1.0)
        _close(ux, (p[1:-1, 2:] - p[1:-1, :-2]) / 2.0)
        _close(uyy, p[2:, 1:-1] - 2.0 * f + p[:-2, 1:-1])


class TestMetrics:
    def test_rmse_r2(self):
        rng = np.random.default_rng(1)
        y, p = rng.normal(size=500), rng.normal(size=500)
        _close(tmet.rmse(torch.from_numpy(y), torch.from_numpy(p)), jmet.rmse(jnp.asarray(y), jnp.asarray(p)))
        _close(tmet.r2_score(torch.from_numpy(y), torch.from_numpy(p)), jmet.r2_score(jnp.asarray(y), jnp.asarray(p)))

    def test_regression_metrics_batched(self):
        """Leading axes are a batch (one row of metrics per patch, where pdx
        vmaps); each row equals pdx's scalar."""
        rng = np.random.default_rng(2)
        y, p = rng.normal(size=(2, 4, 50))
        got = tmet.regression_metrics(torch.from_numpy(y), torch.from_numpy(p))
        want = jax.vmap(jmet.regression_metrics)(jnp.asarray(y), jnp.asarray(p))
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == (4,)
            _close(got[k], want[k])

    @pytest.mark.parametrize("n_keep", [0, 1, 7, 8])
    def test_masked_regression_metrics(self, n_keep):
        """The median of an even count averages the middle pair, as
        jnp.nanmedian does; an empty mask gives NaN there too."""
        rng = np.random.default_rng(3)
        y, p = rng.normal(size=(2, 20))
        mask = np.zeros(20, bool)
        mask[rng.permutation(20)[:n_keep]] = True
        got = tmet.masked_regression_metrics(torch.from_numpy(y), torch.from_numpy(p), torch.from_numpy(mask))
        want = jmet.masked_regression_metrics(jnp.asarray(y), jnp.asarray(p), jnp.asarray(mask))
        for k in want:
            w = np.asarray(want[k])
            if n_keep == 0:
                assert np.isnan(got[k].item()) == np.isnan(w), k
            else:
                np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-12, atol=1e-12, err_msg=k)

    def test_support_f1_and_relative_errors(self):
        est = np.array([0.0, 1.0, -2.0, 1e-9, 3.0])
        true = np.array([1.0, 1.0, 0.0, 0.0, 2.5])
        t_est, t_true = torch.from_numpy(est), torch.from_numpy(true)
        _close(tmet.f1_support_score(t_est, t_true), jmet.f1_support_score(jnp.asarray(est), jnp.asarray(true)))
        _close(tmet.coefficient_relative_errors(t_est, t_true),
               jmet.coefficient_relative_errors(jnp.asarray(est), jnp.asarray(true)))


def _problem(seed=0, n=400, p=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)) * rng.uniform(0.5, 3.0, size=p)
    y = X @ rng.normal(size=p) + 0.01 * rng.normal(size=n)
    return X, y


class TestLinalg:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_gram_stats(self, weighted):
        X, y = _problem()
        w = np.random.default_rng(2).integers(0, 3, size=len(y)).astype(float) if weighted else None
        got = tlin.gram_stats(torch.from_numpy(X), torch.from_numpy(y), None if w is None else torch.from_numpy(w))
        want = jlin.gram_stats(jnp.asarray(X), jnp.asarray(y), None if w is None else jnp.asarray(w))
        for k in want:
            _close(got[k], want[k])

    def test_standardized_stats(self):
        X, y = _problem(3)
        got = tlin.standardized_stats(tlin.gram_stats(torch.from_numpy(X), torch.from_numpy(y)))
        want = jlin.standardized_stats(jlin.gram_stats(jnp.asarray(X), jnp.asarray(y)))
        for g, w in zip(got, want):
            _close(g, w, atol=1e-12 * np.abs(_np(w)).max())

    def test_zero_std_tol_constant_column(self):
        """A constant column keeps scale 1 (its O(eps) residual std is under
        the |mean|-relative cutoff); an exactly-zero column too."""
        rng = np.random.default_rng(4)
        X = np.column_stack([np.full(300, 3.7), rng.normal(size=300), np.zeros(300)])
        y = rng.normal(size=300)
        _g, _b, mean, scale = tlin.standardized_stats(tlin.gram_stats(torch.from_numpy(X), torch.from_numpy(y)))
        jg, jb, jmean, jscale = jlin.standardized_stats(jlin.gram_stats(jnp.asarray(X), jnp.asarray(y)))
        assert _np(scale)[0] == 1.0 and _np(scale)[2] == 1.0
        _close(scale, jscale)
        _close(tlin._zero_std_tol(mean, torch.float64), jlin._zero_std_tol(jmean, jnp.float64))

    def test_ridge_solve(self):
        X, y = _problem(5)
        G, b = X.T @ X, X.T @ y
        got = tlin.ridge_solve(torch.from_numpy(G), torch.from_numpy(b), 1e-3)
        want = jlin.ridge_solve(jnp.asarray(G), jnp.asarray(b), 1e-3)
        _close(got, want)

    def test_masked_ridge_solve_batched(self):
        """A (2, 3) batch of masks and alphas in one solve equals pdx per point."""
        X, y = _problem(6)
        G, b = X.T @ X, X.T @ y
        rng = np.random.default_rng(7)
        masks = (rng.uniform(size=(2, 3, 5)) > 0.4).astype(float)
        alphas = np.array([[1e-6, 1e-3, 1e-1], [1e-4, 1e-2, 1.0]])
        got = _np(tlin.masked_ridge_solve(torch.from_numpy(G), torch.from_numpy(b), torch.from_numpy(masks), torch.from_numpy(alphas)))
        for i in range(2):
            for j in range(3):
                want = jlin.masked_ridge_solve(jnp.asarray(G), jnp.asarray(b), jnp.asarray(masks[i, j]), alphas[i, j])
                _close(got[i, j], want, atol=1e-14)

    def test_column_standardize_stats(self):
        """Population std (jnp.std's default); a constant column keeps scale 1."""
        rng = np.random.default_rng(8)
        X = np.column_stack([rng.normal(size=300) * 3.0, np.full(300, 2.5), rng.normal(size=300) + 10.0])
        mean, scale = tlin.column_standardize_stats(torch.from_numpy(X))
        jmean, jscale = jlin.column_standardize_stats(jnp.asarray(X))
        _close(mean, jmean)
        _close(scale, jscale)
        assert _np(scale)[1] == 1.0
        batched = tlin.column_standardize_stats(torch.from_numpy(np.stack([X, 2.0 * X])))
        _close(batched[1][1], 2.0 * _np(scale) - np.array([0.0, 1.0, 0.0]))

    def test_sse_from_stats(self):
        X, y = _problem(9)
        c = np.random.default_rng(10).normal(size=(3, 5))
        G, b, syy = X.T @ X, X.T @ y, float(y @ y)
        got = tlin.test_sse_from_stats(torch.from_numpy(c), torch.from_numpy(G), torch.from_numpy(b), torch.tensor(syy, dtype=torch.float64))
        want = jlin.test_sse_from_stats(jnp.asarray(c), jnp.asarray(G), jnp.asarray(b), jnp.asarray(syy))
        _close(got, want)
        _close(got, ((X @ c.T - y[:, None]) ** 2).sum(0), rtol=1e-9)

    def test_gram_stats_batched(self):
        """Leading batch axes: each member's statistics equal its own."""
        rng = np.random.default_rng(11)
        X, y = rng.normal(size=(3, 50, 4)), rng.normal(size=(3, 50))
        got = tlin.gram_stats(torch.from_numpy(X), torch.from_numpy(y))
        std = tlin.standardized_stats(got)
        for i in range(3):
            one = tlin.gram_stats(torch.from_numpy(X[i]), torch.from_numpy(y[i]))
            for k in one:
                _close(got[k][i] if got[k].ndim else got[k], one[k], rtol=1e-13, atol=1e-13)
            for g, w in zip(std, tlin.standardized_stats(one)):
                _close(g[i], w, rtol=1e-12, atol=1e-13)
