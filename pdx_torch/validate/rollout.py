"""One-step prediction and k-step explicit-Euler rollout validation.

Port of ``pdx/validate/rollout.py``:
  * one_step_prediction_rmse (analyze_results.py:157-186);
  * rollout_k_rmse and its batched and curve forms (analyze_results.py:348-393):
    k Euler steps from every valid start time, RMSE / nRMSE, optionally on
    spatial masks;
  * the KS benchmark's single-trajectory rollout curve
    (ks2d_stridge_benchmark.py:1805-1838).

``pdx`` vmaps models and start frames and scans over steps. Here the state
of every model and start is one (M, S, H, W) tensor: the stencils act on
the last two axes, so each Euler step is one pass of the 13- or 25-term
right-hand side whatever M and S are, an eager loop over steps. Every
horizon's metrics are read off the one trajectory, as in ``pdx``'s
bundles.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import Tensor

from pdx_torch.library.dictionaries import FOURTH_ORDER_TERMS, fourth_order_term_fields, real_image_term_fields
from pdx_torch.ops.fd import gradients_periodic, laplacian_periodic
from pdx_torch.utils.profiling import count

ANALYZE13 = (
    "one", "u", "ux", "uy", "uxx", "uyy", "lap", "u2", "u_ux", "u_uy", "u3", "ux2", "uy2",
)

_TERM_SETS = {
    "real13": (real_image_term_fields, ANALYZE13),
    "fourth25": (fourth_order_term_fields, tuple(FOURTH_ORDER_TERMS)),
}


def _weighted_sum(coeff_of: Callable[[int], Tensor | float], fields: dict[str, Tensor], names) -> Tensor:
    """sum_i coeff_of(i) * fields[names[i]], accumulated in ``pdx``'s order."""
    out = coeff_of(0) * fields[names[0]]
    for i in range(1, len(names)):
        out = out + coeff_of(i) * fields[names[i]]
    return out


def make_rhs_periodic(names: list[str], coeffs, dx: float, dy: float) -> Callable[[Tensor], Tensor]:
    """Term-map RHS with periodic derivatives (KS benchmark rollout,
    ks2d_stridge_benchmark.py:1805-1827)."""

    def rhs(u: Tensor) -> Tensor:
        ux, uy = gradients_periodic(u, dx, dy)
        lap = laplacian_periodic(u, dx, dy)
        vals = {
            "one": torch.ones_like(u), "u": u, "u2": u**2, "ux": ux, "uy": uy, "lap": lap,
            "bih": laplacian_periodic(lap, dx, dy), "gradsq": ux**2 + uy**2, "u_lap": u * lap,
        }
        return _weighted_sum(lambda i: coeffs[i], vals, names)

    return rhs


def make_rhs_reflect(names: list[str], coeffs, dx: float, dy: float) -> Callable[[Tensor], Tensor]:
    """Term-map RHS with reflect-101 derivatives (real-image rollout,
    analyze_results.py:318-345)."""

    def rhs(u: Tensor) -> Tensor:
        return _weighted_sum(lambda i: coeffs[i], real_image_term_fields(u, dx, dy), names)

    return rhs


def make_rhs_fourth_order(names: list[str], coeffs, dx: float, dy: float) -> Callable[[Tensor], Tensor]:
    """Term-map RHS for the 25-term 4th-order library (notebook 02)."""

    def rhs(u: Tensor) -> Tensor:
        return _weighted_sum(lambda i: coeffs[i], fourth_order_term_fields(u, dx, dy), names)

    return rhs


def _dense_rhs(term_set: str, coeffs: Tensor, dx: float, dy: float) -> Callable[[Tensor], Tensor]:
    """RHS of M models at once: ``coeffs`` (M, p) over the term set's dense
    order, the state (M, ..., H, W), model m's fields weighted by row m."""
    fields_fn, names = _TERM_SETS[term_set]

    def rhs(u: Tensor) -> Tensor:
        c = coeffs.reshape(coeffs.shape[:1] + (1,) * (u.ndim - 1) + coeffs.shape[1:])
        return _weighted_sum(lambda i: c[..., i], fields_fn(u, dx, dy), names)

    return rhs


def one_step_prediction_rmse(
    u_field: Tensor, ut_pred: Tensor, dt: float = 1.0, spatial_mask: Tensor | None = None
) -> Tensor:
    """u(t+1) ~ u(t) + dt * ut_pred(t); RMSE over all forward pairs."""
    t_max = min(u_field.shape[0] - 1, ut_pred.shape[0])
    u0 = u_field[:t_max]
    u1 = u_field[1 : t_max + 1]
    err = (u1 - (u0 + dt * ut_pred[:t_max])) ** 2
    if spatial_mask is not None:
        m = torch.broadcast_to(spatial_mask, err.shape).to(err.dtype)
        return torch.sqrt(torch.sum(err * m) / torch.sum(m))
    return torch.sqrt(torch.mean(err))


def rollout_predict(rhs: Callable[[Tensor], Tensor], u0: Tensor, k: int, dt: float) -> Tensor:
    """k explicit-Euler steps from u0."""
    u = u0
    for _ in range(int(k)):
        u = u + dt * rhs(u)
    return u


def rollout_trajectories(rhs: Callable[[Tensor], Tensor], starts: Tensor, k_max: int, dt: float) -> Tensor:
    """Every intermediate state of a batch of rollouts: (k_max, *starts.shape),
    step j holding the (j + 1)-step predictions. ``rhs`` acts on the whole
    batch at once."""
    s, traj = starts, []
    for _ in range(int(k_max)):
        s = s + dt * rhs(s)
        traj.append(s)
    if not traj:
        return starts.new_empty((0,) + starts.shape)
    return torch.stack(traj)


def _population_std(x: Tensor) -> Tensor:
    """``jnp.std``: sqrt(mean(|x - mean|^2)); NaN for an empty x."""
    return torch.sqrt(torch.mean((x - torch.mean(x)) ** 2))


def _rollout_metrics(preds: Tensor, targets: Tensor, masks: Tensor | None) -> tuple[Tensor, Tensor]:
    """(rmse, nrmse) of predictions (M, n, H, W) against targets (n, H, W):
    column 0 unmasked, then one column per mask of ``masks`` (Nm, H, W),
    each over the mask's pixels of every frame. Returns (M, 1 + Nm) each."""
    diff2 = (targets - preds) ** 2
    rm = torch.sqrt(torch.mean(diff2, dim=(1, 2, 3)))[:, None]
    nrm = rm / (_population_std(targets) + 1e-12)
    if masks is None or masks.shape[0] == 0:
        return rm, nrm
    m = masks.to(preds.dtype)[:, None]  # (Nm, 1, H, W)
    msum = targets.shape[0] * torch.sum(m, dim=(1, 2, 3))  # the mask broadcast over the frames
    rm_m = torch.sqrt(torch.sum(diff2[:, None] * m, dim=(2, 3, 4)) / msum)  # (M, Nm)
    tmean = torch.sum(targets * m, dim=(1, 2, 3)) / msum
    tstd = torch.sqrt(torch.sum((targets - tmean[:, None, None, None]) ** 2 * m, dim=(1, 2, 3)) / msum)
    return torch.cat([rm, rm_m], dim=1), torch.cat([nrm, rm_m / (tstd + 1e-12)], dim=1)


def rollout_k_rmse(
    u_true: Tensor,
    rhs: Callable[[Tensor], Tensor],
    k: int,
    t0: int,
    t1: int,
    dt: float,
    spatial_mask: Tensor | None = None,
) -> dict[str, Tensor]:
    """k-step rollout RMSE over start times t in [t0, t1 - k) — the
    reference's enumeration (analyze_results.py:364-393)."""
    if k <= 0 or (t1 - t0) <= k:
        nan = torch.tensor(float("nan"), dtype=u_true.dtype, device=u_true.device)
        return {"rmse": nan, "nrmse": nan}
    preds = rollout_predict(rhs, u_true[t0 : t1 - k], k, dt)
    masks = None if spatial_mask is None else torch.broadcast_to(spatial_mask, u_true.shape[-2:])[None]
    rm, nrm = _rollout_metrics(preds[None], u_true[t0 + k : t1], masks)
    return {"rmse": rm[0, -1], "nrmse": nrm[0, -1]}


def rollout_curve_bundle(
    u_true: Tensor, coeffs_batch: Tensor, dt: float, dx: float, dy: float, masks: Tensor,
    *, k_max: int, t0: int, t1: int, term_set: str = "real13",
) -> tuple[Tensor, Tensor]:
    """Rollout metrics for every horizon k = 1..k_max, every model (rows of
    the dense ``coeffs_batch`` (M, p)) and every spatial mask (``masks``
    (Nm, H, W)) from one trajectory of the maximal start set
    u[t0 : t1 - 1]: step j of start s is the j-step prediction, so every
    horizon is read off it. Column 0 is the unmasked metric, columns 1..Nm
    the masked ones; horizons with no valid start are NaN. Returns
    (rmse, nrmse), each (M, k_max, Nm + 1)."""
    M = coeffs_batch.shape[0]
    starts = u_true[t0 : t1 - 1]
    state = starts.expand((M,) + starts.shape)
    traj = rollout_trajectories(_dense_rhs(term_set, coeffs_batch, dx, dy), state, k_max, dt)
    nan = torch.full((M, masks.shape[0] + 1), float("nan"), dtype=u_true.dtype, device=u_true.device)
    rm_rows, nrm_rows = [], []
    for k in range(1, k_max + 1):
        n_valid = t1 - t0 - k
        if n_valid < 1:
            rm_rows.append(nan)
            nrm_rows.append(nan)
            continue
        rm, nrm = _rollout_metrics(traj[k - 1][:, :n_valid], u_true[t0 + k : t1], masks)
        rm_rows.append(rm)
        nrm_rows.append(nrm)
    if not rm_rows:
        empty = u_true.new_empty((M, 0, masks.shape[0] + 1))
        return empty, empty
    return torch.stack(rm_rows, dim=1), torch.stack(nrm_rows, dim=1)


def dense_coeffs(names: list[str], coeffs, superset) -> np.ndarray:
    """Scatter a model's coefficient vector into the dense superset order."""
    cvals = np.asarray(coeffs.cpu() if isinstance(coeffs, Tensor) else coeffs)
    dense = np.zeros((len(superset),))
    for i, n in enumerate(names):
        dense[list(superset).index(n)] = cvals[i]
    return dense


def fig4_rollout_bundle(
    u_true: Tensor, coeffs_batch: Tensor, dt: float, dx: float, dy: float,
    *, k_max: int, t_start: int, t0: int, t1: int,
) -> tuple[Tensor, Tensor]:
    """Everything FIG4 needs from one trajectory of [the snapshot start +
    every test-split start], for dense 13-term coefficient vectors
    (ANALYZE13 order). Returns (snap_traj (M, k_max, H, W),
    nrmse (M, k_max)). A horizon with no valid start takes the first start
    alone, as ``pdx`` does."""
    starts = torch.cat([u_true[t_start][None], u_true[t0 : t1 - 1]], dim=0)
    M = coeffs_batch.shape[0]
    traj = rollout_trajectories(
        _dense_rhs("real13", coeffs_batch, dx, dy), starts.expand((M,) + starts.shape), k_max, dt
    )  # (k_max, M, S + 1, H, W)
    snap = traj[:, :, 0].transpose(0, 1)
    roll = traj[:, :, 1:]
    nrmses = []
    for k in range(1, k_max + 1):
        n_valid = max(t1 - t0 - k, 1)
        preds = roll[k - 1][:, :n_valid] if t1 - t0 - k >= 1 else roll[k - 1][:, :1]
        targets = u_true[t0 + k : t0 + k + preds.shape[1]]
        nrmses.append(_rollout_metrics(preds, targets, None)[1][:, 0])
    return snap, torch.stack(nrmses, dim=1)


def _rollout_k_dense_batch(
    u_true: Tensor, coeffs_batch: Tensor, dt: float, spatial_mask: Tensor | None,
    *, term_set: str, k: int, t0: int, t1: int, dx: float, dy: float,
) -> tuple[Tensor, Tensor]:
    """Per-model k-step rollout metrics for dense coefficient vectors
    (M, p): (rmse (M,), nrmse (M,)), on the mask if one is given."""
    M = coeffs_batch.shape[0]
    starts = u_true[t0 : t1 - k]
    preds = rollout_predict(_dense_rhs(term_set, coeffs_batch, dx, dy), starts.expand((M,) + starts.shape), k, dt)
    masks = None if spatial_mask is None else torch.broadcast_to(spatial_mask, u_true.shape[-2:])[None]
    rm, nrm = _rollout_metrics(preds, u_true[t0 + k : t1], masks)
    return rm[:, -1], nrm[:, -1]


def rollout_k_rmse_dense_batch(
    u_true: Tensor, coeffs_batch: Tensor, k: int, t0: int, t1: int, dt: float, dx: float, dy: float,
    spatial_mask: Tensor | None = None, term_set: str = "real13",
) -> tuple[np.ndarray, np.ndarray]:
    """Batched-over-models k-step rollout of dense (M, p_superset)
    coefficient vectors. Returns (rmse[M], nrmse[M]) as numpy."""
    M = coeffs_batch.shape[0]
    if k <= 0 or (t1 - t0) <= k:
        nan = np.full((M,), np.nan)
        return nan, nan
    rm, nrm = _rollout_k_dense_batch(
        u_true, torch.as_tensor(coeffs_batch, dtype=u_true.dtype, device=u_true.device), dt, spatial_mask,
        term_set=term_set, k=int(k), t0=int(t0), t1=int(t1), dx=float(dx), dy=float(dy),
    )
    both = torch.stack([rm, nrm]).cpu().numpy()
    return both[0], both[1]


def rollout_k_rmse_dense(
    u_true: Tensor, names: list[str], coeffs, k: int, t0: int, t1: int, dt: float, dx: float, dy: float,
    spatial_mask: Tensor | None = None,
) -> dict[str, Tensor]:
    """:func:`rollout_k_rmse` of one model given by its term names and
    coefficients, scattered into the dense order of the smallest term set
    that holds its names ('real13' or the 25-term 4th-order set)."""
    if k <= 0 or (t1 - t0) <= k:
        nan = torch.tensor(float("nan"), dtype=u_true.dtype, device=u_true.device)
        return {"rmse": nan, "nrmse": nan}
    term_set = "real13" if set(names) <= set(ANALYZE13) else "fourth25"
    dense = dense_coeffs(names, coeffs, _TERM_SETS[term_set][1])
    rm, nrm = _rollout_k_dense_batch(
        u_true, torch.as_tensor(dense[None], dtype=u_true.dtype, device=u_true.device), dt, spatial_mask,
        term_set=term_set, k=int(k), t0=int(t0), t1=int(t1), dx=float(dx), dy=float(dy),
    )
    return {"rmse": rm[0], "nrmse": nrm[0]}


def rollout_curve(
    u_true: Tensor, rhs: Callable[[Tensor], Tensor], k_list: list[int], t0: int, t1: int, dt: float,
    spatial_mask: Tensor | None = None,
) -> dict[int, dict[str, Tensor]]:
    """Rollout metrics for every horizon in k_list."""
    return {int(k): rollout_k_rmse(u_true, rhs, int(k), t0, t1, dt, spatial_mask) for k in k_list}


def rollout_rmse_curve(
    U: Tensor, rhs: Callable[[Tensor], Tensor], n_steps: int, dt: float
) -> Tensor:
    """Single-trajectory rollout from U[0]: errs[k] = rmse(U[k+1], u_hat_k).
    The per-step errors stay on the device and are stacked once. Adds the
    steps to the tracer's count ``rollout.steps``."""
    u = U[0]
    errs = []
    for k in range(n_steps):
        u = u + dt * rhs(u)
        errs.append(torch.sqrt(torch.mean((U[k + 1] - u) ** 2)))
    count("rollout.steps", n_steps)
    return torch.stack(errs)


def rollout_rmse_curve_named(
    U: Tensor, coeffs, names: list[str], n_steps: int, dt: float, dx: float, dy: float
) -> Tensor:
    """:func:`rollout_rmse_curve` for the periodic term-map RHS
    sum_i coeffs[i] * term_i(u) over the KS term vocabulary."""
    c = torch.as_tensor(coeffs, dtype=U.dtype, device=U.device)

    def rhs(u: Tensor) -> Tensor:
        ux, uy = gradients_periodic(u, dx, dy)
        lap = laplacian_periodic(u, dx, dy)
        vals = {
            "one": lambda: torch.ones_like(u), "u": lambda: u, "u2": lambda: u**2,
            "ux": lambda: ux, "uy": lambda: uy, "lap": lambda: lap,
            "bih": lambda: laplacian_periodic(lap, dx, dy),
            "gradsq": lambda: ux**2 + uy**2, "u_lap": lambda: u * lap,
        }
        out = torch.zeros_like(u)
        for i, name in enumerate(names):
            out = out + c[i] * vals[name]()
        return out

    return rollout_rmse_curve(U, rhs, n_steps, dt)
