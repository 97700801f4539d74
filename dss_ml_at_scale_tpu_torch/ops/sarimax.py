"""SARIMAX (ARIMA + exogenous regressors) fitted over a batch of series.

Port of ``dss_ml_at_scale_tpu/ops/sarimax.py``: statsmodels'
``SARIMAX(train, exog=..., order=(p,d,q)).fit(method='nm')`` and
``.predict(start, end, exog=...)``, with p <= 4, d <= 2, q <= 4 masked
against the static maxima of :class:`SarimaxConfig`, so that every order
of the grid runs in the same batch.

The JAX module fits one series per call and ``vmap``s over orders, starts
and groups. Here those axes are flattened into one lane axis: every
function takes lanes as leading axes (``y`` ``[..., N]``, ``exog``
``[..., N, k]``, ``order`` ``[..., 3]``, ``n_valid`` ``[...]``,
``params`` ``[..., n_params]``, broadcasting against each other). A fit
runs its three starts as lanes of the same Nelder-Mead and BFGS batches,
and each Nelder-Mead iteration evaluates its four candidates and its
``n+1`` shrink points in one filter call of ``(n + 5) x lanes`` series.

Parameters use the JAX package's packed layout, ``[beta (k_exog), phi
(max_p), theta (max_q), log_sigma2]``, so parameter arrays carry across
unchanged. The dtype follows the input, as in JAX: an f64 panel gives an
f64 search.

Model: y_t = x_t'beta + u_t, with Delta^d u_t ~ ARMA(p, q). The ARMA part
runs through a Harvey-representation Kalman filter (state dim
``max(max_p, max_q + 1)``), initialized by the stationary Lyapunov solve
when it is valid and approximate-diffuse otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .bfgs import minimize_bfgs
from .kalman import kalman_filter_companion
from .neldermead import nan_to_max, nelder_mead

_LOG2PI = 1.8378770664093453

# Series per filter call when a Nelder-Mead step evaluates its points (no
# gradient kept): bounds the batched Lyapunov systems and filter state.
FILTER_LANES = 1 << 20
# Lanes per backward pass of BFGS: the filter saves its whole time loop
# (about 65 KiB a lane at 157 weeks in float32, so a full 1,024-group
# chunk of 230,400 fits takes one pass).
GRAD_LANES = 1 << 18


@dataclasses.dataclass(frozen=True)
class SarimaxConfig:
    """Static shape bounds; per-fit orders are masked against these."""

    max_p: int = 4
    max_d: int = 2
    max_q: int = 4
    k_exog: int = 0
    kappa: float = 1e4  # approximate-diffuse prior variance scale
    max_iter: int = 200  # Nelder-Mead iterations (reference: method='nm')
    bfgs_iter: int = 100  # gradient polish after NM (0 disables)

    @property
    def state_dim(self) -> int:
        return max(self.max_p, self.max_q + 1)

    @property
    def n_params(self) -> int:
        # [beta (k_exog), phi (max_p), theta (max_q), log_sigma2]
        return self.k_exog + self.max_p + self.max_q + 1

    def unpack(self, params):
        k, p, q = self.k_exog, self.max_p, self.max_q
        return (
            params[..., :k],
            params[..., k : k + p],
            params[..., k + p : k + p + q],
            params[..., k + p + q],
        )

    def pack(self, beta, phi, theta, log_sigma2):
        """The inverse of :meth:`unpack`."""
        return torch.cat([beta, phi, theta, log_sigma2.unsqueeze(-1)], -1)


class SarimaxResult(NamedTuple):
    params: torch.Tensor  # [..., n_params] packed [beta, phi, theta, log_sigma2]
    loglike: torch.Tensor  # [...]
    n_iter: torch.Tensor  # [...] NM iterations over the three starts
    converged: torch.Tensor  # [...]


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def _difference(x: torch.Tensor, d: torch.Tensor, max_d: int) -> torch.Tensor:
    """Delta^d x along the last axis, per-lane d <= max_d; the first d
    outputs are invalid. Every branch is computed and d selects."""
    z = torch.zeros_like(x[..., :1])
    d = torch.clamp(d, 0, max_d).unsqueeze(-1)
    out = x
    if max_d >= 1:
        out = torch.where(d == 1, torch.cat([z, x[..., 1:] - x[..., :-1]], -1), out)
    if max_d >= 2:
        out = torch.where(
            d == 2, torch.cat([z, z, x[..., 2:] - 2 * x[..., 1:-1] + x[..., :-2]], -1), out)
    return out


def _ssm_matrices(cfg: SarimaxConfig, phi_eff, theta_eff, sigma2):
    """Harvey representation: T companion on phi, R = [1, theta...],
    Q = sigma2 (the observation row Z is e_0)."""
    r = cfg.state_dim
    batch = phi_eff.shape[:-1]
    zero = phi_eff.new_zeros(batch + (r - cfg.max_p,))
    shift = torch.eye(r, r - 1, dtype=phi_eff.dtype, device=phi_eff.device)
    T = torch.cat([torch.cat([phi_eff, zero], -1).unsqueeze(-1),
                   shift.expand(batch + (r, r - 1))], -1)
    R = torch.cat([theta_eff.new_ones(batch + (1,)), theta_eff,
                   theta_eff.new_zeros(batch + (r - 1 - cfg.max_q,))], -1).unsqueeze(-1)
    return T, R, sigma2[..., None, None]


def _init_cov(cfg: SarimaxConfig, T, RQR, sigma2, r_eff):
    """Stationary Lyapunov solve, approximate-diffuse fallback.

    The diffuse identity covers only the ``r_eff = max(p, q+1)`` ACTIVE
    state dims, so the padded filter reproduces the unpadded one. A
    singular system (a unit root) gives non-finite values, not an error,
    and takes the fallback.
    """
    r = cfg.state_dim
    batch = T.shape[:-2]
    kron = (T[..., :, None, :, None] * T[..., None, :, None, :]).reshape(batch + (r * r, r * r))
    eye = torch.eye(r * r, dtype=T.dtype, device=T.device)
    P_vec, _ = torch.linalg.solve_ex(eye - kron, RQR.reshape(batch + (r * r, 1)),
                                     check_errors=False)
    P = P_vec.reshape(batch + (r, r))
    P = 0.5 * (P + P.mT)
    kappa = cfg.kappa * torch.clamp_min(sigma2, 1.0)
    # Padded state dims legitimately have zero stationary variance, so the
    # check allows diag == 0; it rejects non-finite / negative / exploding
    # solves (non-stationary phi iterates under Nelder-Mead).
    ok = (
        torch.isfinite(P).all(-1).all(-1)
        & (torch.diagonal(P, dim1=-2, dim2=-1) >= -1e-6).all(-1)
        & (P.abs().amax((-2, -1)) < kappa)
    )
    active = (_arange(r, T) < r_eff.unsqueeze(-1)).to(T.dtype)
    return torch.where(ok[..., None, None], P, kappa[..., None, None] * torch.diag_embed(active))


def _xbeta(exog: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``exog @ beta`` per lane: ``[..., N, k] x [..., k] -> [..., N]``."""
    out = exog[..., 0] * beta[..., :1]
    for j in range(1, beta.shape[-1]):
        out = out + exog[..., j] * beta[..., j : j + 1]
    return out


def _filter(cfg: SarimaxConfig, params, y, exog, order, n_valid, *, with_loglike=True):
    """Shared setup: regression residual -> difference -> Kalman filter.

    Returns ``(filtered, resid, w, mask)``; ``w`` is the differenced
    residual the filter ran on."""
    p, d, q = order[..., 0], order[..., 1], order[..., 2]
    beta, phi, theta, log_sigma2 = cfg.unpack(params)
    phi_eff = phi * (_arange(cfg.max_p, y) < p.unsqueeze(-1))
    theta_eff = theta * (_arange(cfg.max_q, y) < q.unsqueeze(-1))
    sigma2 = torch.exp(log_sigma2)

    resid = y - _xbeta(exog, beta) if cfg.k_exog else y
    w = _difference(resid, d, cfg.max_d)
    t_idx = _arange(y.shape[-1], y)
    mask = (t_idx >= d.unsqueeze(-1)) & (t_idx < n_valid.unsqueeze(-1))

    T, R, Q = _ssm_matrices(cfg, phi_eff, theta_eff, sigma2)
    r_eff = torch.clamp_min(torch.maximum(p, q + 1), 1)
    RQR = R @ Q @ R.mT
    P0 = _init_cov(cfg, T, RQR, sigma2, r_eff)
    a0 = y.new_zeros(P0.shape[:-1])
    # The general filter with T, R, Q, Z, H = 0; the companion form runs it
    # without the 5 x 5 products.
    filt = kalman_filter_companion(w, T[..., 0], RQR, a0, P0, mask, with_loglike=with_loglike)
    return filt, resid, w, mask


def sarimax_loglike(cfg: SarimaxConfig, params, y, exog, order, n_valid) -> torch.Tensor:
    """Exact (prediction-error decomposition) log-likelihood."""
    return _filter(cfg, params, y, exog, order, n_valid)[0].loglike


def _lagmat(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., n, k]`` matrix of x lagged 1..k, zero before the start."""
    n = x.shape[-1]
    cols = [torch.cat([x.new_zeros(x.shape[:-1] + (min(j + 1, n),)), x[..., : n - j - 1]], -1)
            for j in range(k)]
    return torch.stack(cols, -1) if cols else x.new_zeros(x.shape + (0,))


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A^-1 b`` per lane; a singular system gives non-finite values, as
    ``jnp.linalg.solve`` does, never an error (nor a host sync)."""
    return torch.linalg.solve_ex(A, b.unsqueeze(-1), check_errors=False)[0].squeeze(-1)


def _masked_ridge(X, t, row_mask, lam):
    """Ridge OLS of t on X over masked rows (fixed shapes)."""
    Xm = X * row_mask.unsqueeze(-1)
    k = X.shape[-1]
    eye = torch.eye(k, dtype=X.dtype, device=X.device)
    return _solve(Xm.mT @ Xm + lam * eye, (Xm.mT @ (t * row_mask).unsqueeze(-1)).squeeze(-1))


def _start_params(cfg: SarimaxConfig, y, exog, order, n_valid):
    """Start values: OLS beta, then Hannan-Rissanen phi/theta, and the
    pure long-AR alternative. Returns ``(hr, ar)``, each packed."""
    p, d, q = order[..., 0], order[..., 1], order[..., 2]
    t_idx = _arange(y.shape[-1], y)
    obs = (t_idx < n_valid.unsqueeze(-1)).to(y.dtype)
    if cfg.k_exog:
        # Masked ridge OLS of y on exog for beta start values.
        Xw = exog * obs.unsqueeze(-1)
        eye = torch.eye(cfg.k_exog, dtype=y.dtype, device=y.device)
        beta0 = _solve(Xw.mT @ exog + 1e-3 * eye, (Xw.mT @ y.unsqueeze(-1)).squeeze(-1))
        resid = y - _xbeta(exog, beta0)
    else:
        beta0 = y.new_zeros(y.shape[:-1] + (0,))
        resid = y
    w = _difference(resid, d, cfg.max_d)
    wmask = (t_idx >= d.unsqueeze(-1)) & (t_idx < n_valid.unsqueeze(-1))
    wm = torch.where(wmask, w, 0.0)

    # Stage 1: long AR(L) for innovation estimates e_t.
    L = cfg.max_p + cfg.max_q
    X1 = _lagmat(wm, L)
    m1 = (wmask & (t_idx >= (d + L).unsqueeze(-1))).to(y.dtype)
    a_long = _masked_ridge(X1, wm, m1, 1e-2)
    e = torch.where(wmask, wm - (X1 @ a_long.unsqueeze(-1)).squeeze(-1), 0.0)

    # Stage 2: w_t ~ [w lags (<p), e lags (<q)]; inactive columns masked.
    X2 = torch.cat([_lagmat(wm, cfg.max_p), _lagmat(e, cfg.max_q)], -1)
    p_on = (_arange(cfg.max_p, y) < p.unsqueeze(-1)).to(y.dtype)
    col_mask = torch.cat([p_on, (_arange(cfg.max_q, y) < q.unsqueeze(-1)).to(y.dtype)], -1)
    X2m = X2 * col_mask.unsqueeze(-2)
    sol = _masked_ridge(X2m, wm, m1, 1e-2) * col_mask
    phi0 = torch.clamp(sol[..., : cfg.max_p], -2.0, 2.0)
    theta0 = torch.clamp(sol[..., cfg.max_p :], -2.0, 2.0)

    # Innovation-variance start from the stage-2 residuals.
    res2 = torch.where(wmask, wm - (X2m @ sol.unsqueeze(-1)).squeeze(-1), 0.0)
    denom = torch.clamp_min(m1.sum(-1), 1)
    var = torch.clamp_min((res2 * res2 * m1).sum(-1) / denom, 1e-8)
    log_var = torch.log(var)
    beta0 = beta0.expand(phi0.shape[:-1] + beta0.shape[-1:])
    hr = cfg.pack(beta0, phi0, theta0, log_var)

    # Alternative start: pure long-AR coefficients as phi (theta = 0), the
    # strong seed when the series is (near-)integrated.
    phi_ar = torch.clamp(a_long[..., : cfg.max_p], -2.0, 2.0) * p_on
    ar = cfg.pack(beta0, phi_ar, torch.zeros_like(theta0), log_var)
    return hr, ar


def _concentrated_nll(cfg: SarimaxConfig, free, y, exog, order, n_valid):
    """Scale-concentrated negative loglike over [beta, phi, theta]:
    the filter runs at sigma2 = 1 and the ML scale has the closed form
    ``mean(v_t^2 / F~_t)``. Returns ``(nll, log_sigma2*)``."""
    params1 = torch.cat([free, torch.zeros_like(free[..., :1])], -1)  # sigma2 = 1
    filt, _, w, mask = _filter(cfg, params1, y, exog, order, n_valid, with_loglike=False)
    v = torch.where(mask, w - filt.pred_mean, 0.0)
    F = torch.clamp_min(filt.pred_var, 1e-12)
    n_obs = torch.clamp_min(mask.sum(-1), 1).to(y.dtype)
    sigma2 = torch.clamp_min(torch.where(mask, v * v / F, 0.0).sum(-1) / n_obs, 1e-12)
    nll = 0.5 * (n_obs * (_LOG2PI + 1.0 + torch.log(sigma2))
                 + torch.where(mask, torch.log(F), 0.0).sum(-1))
    return nll, torch.log(sigma2)


class _Objective:
    """The penalized concentrated NLL of a batch of fits (lanes), for the
    optimizers: ``obj(x, lanes)`` takes points ``[k, *S, n_free]`` of the
    lanes ``lanes`` and returns ``[k, *S]``."""

    def __init__(self, cfg, y, exog, order, n_valid):
        self.cfg, self.y, self.exog, self.order, self.n_valid = cfg, y, exog, order, n_valid
        self.n_eff = torch.clamp_min(n_valid - order[..., 1], 1).to(y.dtype)
        # Coefficients masked out by (p, q) do not touch the likelihood;
        # a quadratic penalty pins them so the simplex does not wander.
        self.pin = torch.cat([
            y.new_zeros(y.shape[:-1] + (cfg.k_exog,)),
            (_arange(cfg.max_p, y) >= order[..., :1]).to(y.dtype),
            (_arange(cfg.max_q, y) >= order[..., 2:]).to(y.dtype),
        ], -1)

    def __call__(self, x: torch.Tensor, lanes: slice = slice(None)) -> torch.Tensor:
        extra = x.dim() - 2  # stacked-point axes between lanes and params

        def lane(t):
            t = t[lanes]
            return t.reshape(t.shape[:1] + (1,) * extra + t.shape[1:])

        nll, _ = _concentrated_nll(self.cfg, x, lane(self.y), lane(self.exog),
                                   lane(self.order), lane(self.n_valid))
        return nan_to_max(nll) / lane(self.n_eff) + 10.0 * ((x * lane(self.pin)) ** 2).sum(-1)

    def points(self, x: torch.Tensor) -> torch.Tensor:
        """Evaluate many points per lane (``[L, S, n]``) without a graph, at
        most :data:`FILTER_LANES` series per filter call."""
        L, S = x.shape[:2]
        step = max(1, FILTER_LANES // S)
        if step >= L:
            return self(x)
        return torch.cat([self(x[lo : lo + step], slice(lo, lo + step))
                          for lo in range(0, L, step)])


def _lanes(y, exog, order, n_valid):
    """Broadcast the per-fit inputs against each other and flatten the
    fits into one lane axis: ``(batch_shape, y [B, N], exog [B, N, k],
    order [B, 3], n_valid [B])``."""
    order = torch.as_tensor(order, device=y.device).long()
    n_valid = torch.as_tensor(y.shape[-1] if n_valid is None else n_valid,
                              device=y.device).long()
    batch = torch.broadcast_shapes(y.shape[:-1], exog.shape[:-2], order.shape[:-1],
                                   n_valid.shape)
    N, k, B = y.shape[-1], exog.shape[-1], batch.numel()
    # Explicit B: a series without regressors (k = 0) has no element to infer it from.
    return (batch, y.expand(batch + (N,)).reshape(B, N),
            exog.expand(batch + (N, k)).reshape(B, N, k),
            order.expand(batch + (3,)).reshape(B, 3), n_valid.expand(batch).reshape(B))


def sarimax_fit(cfg: SarimaxConfig, y, exog, order, n_valid=None) -> SarimaxResult:
    """ML fit via Nelder-Mead (the reference's ``method='nm'``), then BFGS.

    ``order`` is ``(p, d, q)`` per fit (``[..., 3]``); every fit of the
    batch runs in the same lanes whatever its order. The scale is
    concentrated out of the search; the reported ``loglike`` is the exact
    likelihood at the returned packed params.

    Three starting points per fit (Hannan-Rissanen, pure long-AR, zeros),
    each a 2-round Nelder-Mead chain and a BFGS polish; all 3 x 3
    candidates are ranked under ONE evaluation of the objective.
    """
    batch, y, exog, order, n_valid = _lanes(y, exog, order, n_valid)
    B = y.shape[0]
    with torch.no_grad():
        hr_full, ar_full = _start_params(cfg, y, exog, order, n_valid)
    hr = hr_full[:, :-1]  # drop log_sigma2: concentrated out
    zeros = torch.cat([hr[:, : cfg.k_exog], torch.zeros_like(hr[:, cfg.k_exog :])], -1)
    starts = torch.stack([hr, ar_full[:, :-1], zeros], 1).reshape(B * 3, -1)

    rep = lambda t: t.repeat_interleave(3, 0)  # noqa: E731  fit -> its 3 chains
    chains = _Objective(cfg, rep(y), rep(exog), rep(order), rep(n_valid))
    nm = lambda x: chains.points(x)  # noqa: E731
    r1 = nelder_mead(nm, starts, max_iter=cfg.max_iter, xatol=1e-5, fatol=1e-7)
    r2 = nelder_mead(nm, r1.x, max_iter=cfg.max_iter, xatol=1e-5, fatol=1e-7)
    cands = [r1.x, r2.x]
    if cfg.bfgs_iter > 0:
        b = minimize_bfgs(chains, r2.x, maxiter=cfg.bfgs_iter, lane_chunk=GRAD_LANES)
        cands.append(b.x)
    n_free = starts.shape[-1]
    cand = torch.stack(cands, 1).reshape(B, 3 * len(cands), n_free)
    n_iter = (r1.n_iter + r2.n_iter).reshape(B, 3).sum(1).to(torch.int32)
    converged = (r1.converged | r2.converged).reshape(B, 3).any(1)

    with torch.no_grad():
        fits = _Objective(cfg, y, exog, order, n_valid)
        fs = nan_to_max(fits.points(cand))
        best_free = torch.take_along_dim(cand, fs.argmin(1)[:, None, None], 1).squeeze(1)
        _, log_sigma2 = _concentrated_nll(cfg, best_free, y, exog, order, n_valid)
        best_x = torch.cat([best_free, log_sigma2.unsqueeze(-1)], -1)
        loglike = sarimax_loglike(cfg, best_x, y, exog, order, n_valid)
    return SarimaxResult(best_x.reshape(batch + (-1,)), loglike.reshape(batch),
                         n_iter.reshape(batch), converged.reshape(batch))


def grid_orders(cfg: SarimaxConfig) -> np.ndarray:
    """The full discrete HPO grid as a ``(K, 3)`` int32 host array: every
    ``(p, d, q)`` within the bounds, p-major (75 orders at 4/2/4)."""
    grids = np.meshgrid(
        np.arange(cfg.max_p + 1), np.arange(cfg.max_d + 1), np.arange(cfg.max_q + 1),
        indexing="ij",
    )
    return np.stack(grids, axis=-1).reshape(-1, 3).astype(np.int32)


class SarimaxGridResult(NamedTuple):
    """Each group's grid-fused fit, reduced over the order axis."""

    order: torch.Tensor  # [G, 3] winning (p, d, q)
    params: torch.Tensor  # [G, n_params] packed params at the winning order
    loss: torch.Tensor  # [G] selection score at the winner (mse, or -loglike)
    loglike: torch.Tensor  # [G] exact loglike of the winning fit
    pred: torch.Tensor  # [G, N] full-range predictions at the winning order
    n_iter: torch.Tensor  # [G] NM iterations summed over the whole grid
    converged: torch.Tensor  # [G] the winning fit's convergence flag


def sarimax_fit_grid(
    cfg: SarimaxConfig,
    y: torch.Tensor,
    exog: torch.Tensor,
    orders,
    n_train,
    n_valid=None,
    select: str = "mse",
) -> SarimaxGridResult:
    """Fit-tune-score every group (``y`` ``[G, N]``, ``exog`` ``[G, N, k]``,
    ``n_train``/``n_valid`` ``[G]``) over a whole ``(K, 3)`` order grid.

    Every (group, order) fit is a lane of one :func:`sarimax_fit`; each
    group's argmin over the order axis is taken on the device, with the
    predictions at the winning order riding along. ``select``: ``"mse"``
    is the holdout MSE on ``[n_train, n_valid)`` of predictions from a fit
    on ``[0, n_train)`` (the reference's Hyperopt objective); ``"loglike"``
    maximizes the in-sample log-likelihood.
    """
    if select not in ("mse", "loglike"):
        raise ValueError(f"select must be 'mse' or 'loglike', got {select!r}")
    G, N = y.shape
    orders = torch.as_tensor(orders, device=y.device).long()
    K = orders.shape[0]
    n_train = torch.as_tensor(n_train, device=y.device).long().expand(G)
    n_valid = torch.as_tensor(N if n_valid is None else n_valid, device=y.device).long().expand(G)
    yl = y[:, None].expand(G, K, N)
    el = exog[:, None].expand((G, K) + exog.shape[1:])
    ol = orders[None].expand(G, K, 3)
    ntl = n_train[:, None].expand(G, K)
    fit = sarimax_fit(cfg, yl, el, ol, ntl)
    with torch.no_grad():
        pred = sarimax_predict(cfg, fit.params, yl, el, ol, ntl)
        t = _arange(N, y)
        m = (t >= n_train[:, None, None]) & (t < n_valid[:, None, None])
        err = torch.where(m, yl - pred, 0.0)
        mse = (err * err).sum(-1) / torch.clamp_min(m.sum(-1), 1)
        score = nan_to_max(mse if select == "mse" else -fit.loglike)
        best = score.argmin(1)

    def pick(t):
        idx = best.reshape((G, 1) + (1,) * (t.dim() - 2)).expand((G, 1) + t.shape[2:])
        return torch.take_along_dim(t, idx, 1).squeeze(1)

    return SarimaxGridResult(
        order=orders[best].to(torch.int32),
        params=pick(fit.params),
        loss=pick(score),
        loglike=pick(fit.loglike),
        pred=pick(pred),
        n_iter=fit.n_iter.sum(1).to(torch.int32),
        converged=pick(fit.converged),
    )


def sarimax_predict(cfg: SarimaxConfig, params, y, exog, order, n_valid) -> torch.Tensor:
    """Full-range prediction, the reference's ``predict(start, end, exog)``.

    ``y`` spans train + horizon and is observed up to ``n_valid`` (ignored
    after); ``exog`` holds the known future regressors. One-step-ahead
    in-sample for ``t < n_valid`` (the first ``d`` points echo the
    observation), dynamic multi-step forecasts after.
    """
    order = torch.as_tensor(order, device=y.device).long()
    n_valid = torch.as_tensor(n_valid, device=y.device).long()
    d = order[..., 1]
    beta = cfg.unpack(params)[0]
    xb = _xbeta(exog, beta) if cfg.k_exog else torch.zeros_like(y)

    filt, resid, _, _ = _filter(cfg, params, y, exog, order, n_valid, with_loglike=False)
    w_hat = filt.pred_mean  # one-step in-sample; multi-step beyond n_valid
    resid = resid.expand(w_hat.shape)
    rm1 = rm2 = torch.zeros_like(w_hat[..., 0])
    preds = []
    for t in range(y.shape[-1]):
        lag = torch.where(d == 1, rm1, torch.where(d == 2, 2 * rm1 - rm2, 0.0))
        pred = torch.where(t < d, resid[..., t], w_hat[..., t] + lag)
        r_t = torch.where(t < n_valid, resid[..., t], pred)
        preds.append(pred)
        rm1, rm2 = r_t, rm1
    return xb + torch.stack(preds, -1)
