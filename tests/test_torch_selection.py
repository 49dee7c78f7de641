"""pdx_torch.validate.selection and pdx_torch.validate.holdout against pdx.

Selection is host numpy in both packages: results must be identical,
including the model chosen among ties in n_active (np.argsort's default
kind in both). Holdout masks and splits: exact.
"""

import numpy as np
import pytest
import torch

from pdx.validate import holdout as jho
from pdx.validate import selection as jsel
from pdx_torch.validate import holdout as tho
from pdx_torch.validate import selection as tsel


def _results(seed, n=6, ties=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "name": f"Model {i + 1}",
            "r2": float(rng.uniform(0.2, 0.9)),
            "one_step_rmse": float(rng.uniform(1e-3, 1e-2)),
            "n_active": int(rng.integers(2, 4)) if ties else i + 2,  # ties are common
            "rollout": {"k3_test": {"nrmse": float(rng.uniform(0.1, 2.0))}},
        })
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_active", [None, 3, 1])
def test_select_best_matches_pdx(seed, max_active):
    """Weighted rank sums with ties in n_active; max_active=1 leaves no
    candidate and returns the first result."""
    res = _results(seed)
    got = tsel.select_best(res, max_active=max_active, k_eval=3)
    want = jsel.select_best(res, max_active=max_active, k_eval=3)
    assert got == want


def test_rank_indices_ties_and_missing_rollout():
    vals = [2.0, 1.0, 2.0, 1.0, 3.0, 2.0]
    assert tsel.rank_indices(vals) == jsel.rank_indices(vals)
    assert tsel.rank_indices(vals, reverse=True) == jsel.rank_indices(vals, reverse=True)
    res = _results(9, ties=False)
    del res[2]["rollout"]
    for k_eval in (0, 3, 7):
        assert tsel.select_best(res, k_eval=k_eval) == jsel.select_best(res, k_eval=k_eval)


def test_patch_aggregates():
    C = np.random.default_rng(2).normal(size=(40, 5))
    C[:, 3] = 0.0
    C[::3, 1] = 0.0
    got, want = tsel.patch_stability_aggregate(C, freq_threshold=0.7), jsel.patch_stability_aggregate(C, freq_threshold=0.7)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    w = np.random.default_rng(3).uniform(size=40)
    np.testing.assert_array_equal(tsel.quality_weighted_aggregate(C, w), jsel.quality_weighted_aggregate(C, w))


@pytest.mark.parametrize("T,frac", [(49, 0.7), (10, 0.1), (10, 0.95), (7, 0.5)])
def test_split_time_clips(T, frac):
    assert tho.split_time(T, frac) == jho.split_time(T, frac)


@pytest.mark.parametrize("n,frac", [(50, 0.7), (9, 0.5), (3, 0.0)])
def test_spatial_splits_and_row_split(n, frac):
    for t_fn, j_fn in ((tho.split_space_left_right, jho.split_space_left_right),
                       (tho.split_space_top_bottom, jho.split_space_top_bottom)):
        for g, w in zip(t_fn(n, frac), j_fn(n, frac)):
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = tho.random_row_split(n, frac, np.random.default_rng(4))
    want = jho.random_row_split(n, frac, np.random.default_rng(4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
