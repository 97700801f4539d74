"""Holt-Winters exponential smoothing, fitted by least squares.

Port of ``dss_ml_at_scale_tpu/ops/holt_winters.py``: the four variants the
reference's EDA compares, additive trend x {additive, multiplicative}
seasonal, each optionally damped, with an optional Box-Cox pre-transform
and the smoothing parameters fitted by SSE (statsmodels'
``ExponentialSmoothing(..., use_boxcox=True).fit(method='ls')``
capability), in torch on the series' device.

The JAX recursion is a ``lax.scan``; here it is a loop over time whose
every step works on a batch of parameter points at once, so one
Nelder-Mead iteration (:func:`.neldermead.nelder_mead`, the port's batched
simplex) evaluates its candidates and shrink points in one pass of the
loop. The Box-Cox lambda is the same 60-step golden-section search of the
concentrated likelihood.

Deviations from statsmodels, as in the JAX package:
- the initial level, trend and seasonals come from the standard
  two-season heuristic rather than joining the optimization; the
  smoothing parameters are still SSE-optimized;
- inputs to Box-Cox (and to the multiplicative variants) are clamped to a
  small positive floor (statsmodels raises on non-positive data).

The variant is recorded in the result, so :func:`holt_winters_forecast`
can never be called with a mismatched one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .neldermead import nelder_mead

_SEASONAL_CODES = {None: 0, "add": 1, "mul": 2}
_GOLDEN = 0.6180339887498949


class HoltWintersResult(NamedTuple):
    alpha: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    phi: torch.Tensor  # damping (1.0 when undamped)
    boxcox_lambda: torch.Tensor  # 1.0 when no transform
    use_boxcox: bool  # whether the fit ran on the Box-Cox scale
    seasonal_code: int  # 0 = none, 1 = additive, 2 = multiplicative
    level: torch.Tensor  # final level state
    trend: torch.Tensor  # final trend state
    season: torch.Tensor  # (m,) final seasonal buffer; [h % m] applies to step h+1
    fittedvalues: torch.Tensor  # (n,) one-step-ahead fitted values, original scale
    sse: torch.Tensor  # SSE on the (transformed) scale the fit ran on


def _boxcox(y, lam):
    return torch.where(lam.abs() < 1e-8, torch.log(y), (y ** lam - 1.0) / lam)


def _inv_boxcox(z, lam):
    return torch.where(lam.abs() < 1e-8, torch.exp(z),
                       torch.clamp_min(lam * z + 1.0, 1e-12) ** (1.0 / lam))


def boxcox_mle_lambda(y: torch.Tensor, lo: float = -1.0, hi: float = 2.0) -> torch.Tensor:
    """Golden-section maximizer of the concentrated Box-Cox likelihood
    over ``[lo, hi]``, 60 steps. ``y`` (1-D) must be positive (callers
    clamp)."""
    n = y.shape[0]
    logsum = torch.log(y).sum()

    def neg_llf(lam):  # lam [k] -> [k]
        z = _boxcox(y, lam[:, None])
        var = torch.clamp_min(z.var(-1, correction=0), 1e-300)
        return 0.5 * n * torch.log(var) - (lam - 1.0) * logsum

    a = torch.tensor(lo, dtype=y.dtype, device=y.device)
    b = torch.tensor(hi, dtype=y.dtype, device=y.device)
    for _ in range(60):
        c = b - _GOLDEN * (b - a)
        d = a + _GOLDEN * (b - a)
        f = neg_llf(torch.stack([c, d]))
        shrink_right = f[0] < f[1]
        a, b = torch.where(shrink_right, a, c), torch.where(shrink_right, d, b)
    return 0.5 * (a + b)


def _heuristic_init(z, m, seasonal):
    """Level, trend and seasonals from the first two complete seasons."""
    s1, s2 = z[:m], z[m:2 * m]
    l0 = s1.mean()
    b0 = (s2.mean() - s1.mean()) / m
    s0 = s1 / torch.clamp_min(l0, 1e-12) if seasonal == "mul" else s1 - l0
    return l0, b0, s0


def _smooth(z, params, init, m, seasonal, damped):
    """Run the recursions for a batch of parameter points.

    ``params`` is ``(alpha, beta, gamma, phi)``, each of one shape ``P``
    (scalars for one point); returns ``(sse [P], fitted [P, n], level [P],
    trend [P], season [P, m])`` with the season buffer in the JAX order
    (entry 0 applies to the next step)."""
    alpha, beta, gamma, phi = params
    l0, b0, s0 = init
    shape = torch.broadcast_shapes(alpha.shape, beta.shape, gamma.shape, phi.shape)
    level = l0.expand(shape)
    trend = b0.expand(shape)
    season = s0.expand(shape + (m,)).clone()
    fitted = []
    for t in range(z.shape[0]):
        z_t = z[t]
        pos = t % m  # the ring slot of s[0] in the JAX buffer
        s_old = season[..., pos]
        lb = level + phi * trend
        if seasonal == "mul":
            fit_t = lb * s_old
            l_new = alpha * (z_t / torch.where(s_old == 0, 1e-12, s_old)) + (1 - alpha) * lb
            s_new = gamma * (z_t / torch.clamp_min(lb, 1e-12)) + (1 - gamma) * s_old
        elif seasonal == "add":
            fit_t = lb + s_old
            l_new = alpha * (z_t - s_old) + (1 - alpha) * lb
            s_new = gamma * (z_t - lb) + (1 - gamma) * s_old
        else:
            fit_t = lb
            l_new = alpha * z_t + (1 - alpha) * lb
            s_new = s_old
        trend = beta * (l_new - level) + (1 - beta) * phi * trend
        level = l_new
        season[..., pos] = s_new
        fitted.append(fit_t)
    fitted = torch.stack(fitted, -1)
    sse = ((z - fitted) ** 2).sum(-1)
    season = torch.roll(season, -(z.shape[0] % m), -1)
    return sse, fitted, level, trend, season


def _unpack(theta, damped):
    """Unconstrained ``theta [..., 4]`` to ``(alpha, beta, gamma, phi)``:
    0 < beta < alpha, 0 < gamma < 1 - alpha, phi in (0.8, 0.998)."""
    alpha = torch.sigmoid(theta[..., 0])
    beta = torch.sigmoid(theta[..., 1]) * alpha
    gamma = torch.sigmoid(theta[..., 2]) * (1 - alpha)
    phi = 0.8 + 0.198 * torch.sigmoid(theta[..., 3]) if damped else torch.ones_like(alpha)
    return alpha, beta, gamma, phi


def holt_winters_fit(
    y: torch.Tensor,
    seasonal_periods: int,
    seasonal: str | None = "add",
    damped: bool = False,
    use_boxcox: bool = False,
    max_iter: int = 200,
) -> HoltWintersResult:
    """Fit additive-trend Holt-Winters to ``y`` (1-D, on its device and in
    its dtype) by SSE minimization: Nelder-Mead from ``[0, -1, -1, 0]``
    over the unconstrained parameters, ``xatol`` 1e-5, ``fatol`` 1e-6."""
    y = torch.as_tensor(y)
    m = seasonal_periods
    if y.shape[0] < 2 * m:
        raise ValueError(
            f"need >= 2 full seasons ({2 * m} points) to initialize, got {y.shape[0]}")
    if use_boxcox or seasonal == "mul":
        y = torch.clamp_min(y, 1e-6)  # Box-Cox / mul-seasonal need positive data
    lam = boxcox_mle_lambda(y) if use_boxcox else torch.tensor(1.0, dtype=y.dtype,
                                                                device=y.device)
    z = _boxcox(y, lam) if use_boxcox else y
    init = _heuristic_init(z, m, seasonal)

    def objective(theta):  # [1, k, 4] -> [1, k]
        return _smooth(z, _unpack(theta, damped), init, m, seasonal, damped)[0]

    theta0 = torch.tensor([[0.0, -1.0, -1.0, 0.0]], dtype=z.dtype, device=z.device)
    res = nelder_mead(objective, theta0, max_iter=max_iter, xatol=1e-5, fatol=1e-6)
    params = _unpack(res.x[0], damped)
    with torch.no_grad():
        sse, fitted, level, trend, season = _smooth(z, params, init, m, seasonal, damped)
    fitted_orig = _inv_boxcox(fitted, lam) if use_boxcox else fitted
    alpha, beta, gamma, phi = params
    return HoltWintersResult(alpha, beta, gamma, phi, lam, bool(use_boxcox),
                             _SEASONAL_CODES[seasonal], level, trend, season, fitted_orig, sse)


def holt_winters_forecast(result: HoltWintersResult, horizon: int) -> torch.Tensor:
    """Forecast ``horizon`` steps ahead, on the original scale; the
    variant (seasonal mode, Box-Cox) is the result's."""
    level = result.level
    h = torch.arange(1, horizon + 1, device=level.device)
    phi = torch.as_tensor(result.phi, dtype=level.dtype, device=level.device)
    # Damped trend accumulates sum_{j=1..h} phi^j; phi = 1 degenerates to h.
    bsum = torch.where((phi - 1.0).abs() < 1e-8, h.to(level.dtype),
                       phi * (1 - phi ** h) / (1 - phi + 1e-12))
    m = result.season.shape[-1]
    s = result.season[..., (h - 1) % m]
    base = level + bsum * result.trend
    if result.seasonal_code == 2:
        z = base * s
    elif result.seasonal_code == 1:
        z = base + s
    else:
        z = base
    if result.use_boxcox:
        return _inv_boxcox(z, torch.as_tensor(result.boxcox_lambda, dtype=z.dtype,
                                              device=z.device))
    return z
