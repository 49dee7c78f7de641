"""Lasso by FISTA on the Gram matrix, and plain least squares (port of
``pdx/solve/lasso.py``).

The objective is sklearn's Lasso, (1 / (2 n)) ||y - X w - b||^2 + alpha ||w||_1
(transport_pde_discovery.py:189-235). ``pdx`` runs FISTA in a
``while_loop`` and vmaps it over alphas, so each alpha stops on its own.
Here the alphas are one (A, p) batch: every iteration updates the whole
batch, and an alpha's result is frozen at the iteration where its own loop
would have stopped. The host learns whether any alpha still runs only
after iterations 1, 2, 4, ... up to ``CHECK_EVERY`` and then every
``CHECK_EVERY`` iterations, one read each time, so a sweep that stops at
once costs one stop check and a 5000-iteration sweep at most
5000 / CHECK_EVERY + 6 instead of one an iteration.
The momentum sequence t_k depends on the iteration count alone, so it is
computed on the host, in float64 as ``pdx`` computes it.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

CHECK_EVERY = 50


def _centered_gram(
    X: Tensor, y: Tensor, fit_intercept: bool, row_mask: Tensor | None
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(G, b, x_mean, y_mean) of the (masked, centred) least-squares
    problem: G = Xc^T Xc / n, b = Xc^T yc / n."""
    n = X.shape[0] if row_mask is None else torch.sum(row_mask)
    if fit_intercept:
        if row_mask is None:
            x_mean = torch.mean(X, dim=0)
            y_mean = torch.mean(y)
        else:
            x_mean = (row_mask @ X) / n
            y_mean = torch.sum(row_mask * y) / n
        Xc = X - x_mean
        yc = y - y_mean
    else:
        x_mean = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
        y_mean = torch.zeros((), dtype=X.dtype, device=X.device)
        Xc, yc = X, y
    if row_mask is not None:
        Xc = Xc * row_mask[:, None]
        yc = yc * row_mask
    return Xc.T @ Xc / n, Xc.T @ yc / n, x_mean, y_mean


def fista_gram(
    G: Tensor, b: Tensor, alphas: Tensor, *, max_iter: int, tol: float
) -> tuple[Tensor, Tensor, int]:
    """FISTA on min_w 1/2 w^T G w - b^T w + alpha ||w||_1 for every alpha of
    ``alphas`` (A,). An alpha's loop runs while
    ``((i < max_iter) & (max|w - w_prev| >= tol)) | (i == 0)``, as ``pdx``'s
    ``while_loop``. Returns (w (A, p), iterations (A,)), on G's device, and
    the host syncs it made: the step size's read and each stop check."""
    A, p = alphas.shape[0], G.shape[0]
    # Lipschitz constant of the gradient: the largest eigenvalue of G
    step = 1.0 / (float(torch.linalg.eigvalsh(G)[-1]) + 1e-12)
    thresh = (alphas * step)[:, None]
    w = torch.zeros((A, p), dtype=G.dtype, device=G.device)
    z, w_out = w, w
    running = torch.ones(A, dtype=torch.bool, device=G.device)
    n_iter = torch.zeros(A, dtype=torch.int64, device=G.device)
    t, next_check, syncs = 1.0, 1, 1  # the step size's read is the first sync
    for i in range(max(int(max_iter), 1)):
        v = z - step * (z @ G - b)  # G is symmetric: z G = (G z^T)^T
        w_new = v - torch.clamp(v, -thresh, thresh)  # soft threshold
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        d = w_new - w
        z = w_new + ((t - 1.0) / t_new) * d
        w_out = torch.where(running[:, None], w_new, w_out)
        n_iter = n_iter + running
        running = running & (torch.amax(torch.abs(d), dim=1) >= tol)
        w, t = w_new, t_new
        if i + 1 == next_check:
            syncs += 1
            if not bool(running.any()):
                break
            next_check = min(2 * next_check, next_check // CHECK_EVERY * CHECK_EVERY + CHECK_EVERY)
    return w_out, n_iter, syncs


def lasso_fista(
    X: Tensor,
    y: Tensor,
    alpha: float | Tensor,
    *,
    max_iter: int = 2000,
    tol: float = 1e-8,
    fit_intercept: bool = True,
    row_mask: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor, int]:
    """:func:`lasso_ista` that also returns each alpha's FISTA iterations
    and the host syncs of the sweep. ``alpha`` a float or an (A,) tensor;
    the results then lead with A."""
    G, b, x_mean, y_mean = _centered_gram(X, y, fit_intercept, row_mask)
    alphas = torch.as_tensor(alpha, dtype=X.dtype, device=X.device)
    w, n_iter, syncs = fista_gram(G, b, alphas.reshape(-1), max_iter=max_iter, tol=tol)
    intercept = y_mean - w @ x_mean
    shape = alphas.shape
    return w.reshape(shape + w.shape[-1:]), intercept.reshape(shape), n_iter.reshape(shape), syncs


def lasso_ista(
    X: Tensor,
    y: Tensor,
    alpha: float | Tensor,
    *,
    max_iter: int = 2000,
    tol: float = 1e-8,
    fit_intercept: bool = True,
    row_mask: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """FISTA for the sklearn Lasso objective. Returns (coef, intercept).

    With fit_intercept, X and y are centred first (the sklearn strategy);
    the intercept is y_mean - x_mean @ coef. ``row_mask`` (0/1 per row)
    fits the masked rows only, with static shapes; masked-out rows must
    hold finite values. A tensor of alphas fits them all as one batch.
    """
    coef, intercept, _, _ = lasso_fista(
        X, y, alpha, max_iter=max_iter, tol=tol, fit_intercept=fit_intercept, row_mask=row_mask
    )
    return coef, intercept


def lstsq_solve(X: Tensor, y: Tensor) -> Tensor:
    """Least squares by the normal equations with a tiny ridge for
    stability (transport_quick_test.py:113-114 uses np.linalg.lstsq)."""
    G = X.T @ X
    b = X.T @ y
    p = G.shape[0]
    return torch.linalg.solve(G + 1e-12 * torch.trace(G) / p * torch.eye(p, dtype=G.dtype, device=G.device), b)
