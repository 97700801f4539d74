"""Host-side float64 SARIMAX polish for razor-thin optima.

Port of ``dss_ml_at_scale_tpu/ops/polish.py`` (plain NumPy and scipy, f64,
on the host; built on the port's :class:`.sarimax.SarimaxConfig`). The
batched fit (:func:`.sarimax.sarimax_fit`) is float32 by default: that is
what batches thousands of SKUs on the card. Its one documented concession
is the misspecified-order corner (d=0 asked of an integrated series): the
ML optimum there sits on an exact unit root with near-cancelling MA
structure, a basin too thin for f32 to resolve, which statsmodels (always
f64) reaches.

This closes that corner in double precision on the host: a plain-NumPy
f64 Kalman likelihood and a scipy Nelder-Mead polish *started from the
f32 fit*. Use it where single-fit quality matters (final refits, reported
likelihoods, model comparison), not inside the batched panel path. One
fit at a time, host CPU only.
"""

from __future__ import annotations

import numpy as np

from .sarimax import SarimaxConfig


def _f64_loglike(
    params: np.ndarray,
    y: np.ndarray,
    exog: np.ndarray,
    order: tuple[int, int, int],
    n_valid: int,
    kappa: float = 1e4,
) -> float:
    """Exact Kalman log-likelihood, float64, unpadded Harvey state space.

    Same model semantics as the f32 kernel (``ops/sarimax.py``): regress
    out exog, difference d times, ARMA(p, q) innovations, stationary
    Lyapunov initialization with approximate-diffuse fallback.
    """
    from scipy import linalg

    p, d, q = order
    k = exog.shape[1] if exog.ndim == 2 else 0
    beta = params[:k]
    phi = params[k : k + p]
    theta = params[k + p : k + p + q]
    sigma2 = float(np.exp(np.clip(params[-1], -30.0, 30.0)))

    u = y - (exog @ beta if k else 0.0)
    w = np.diff(u, n=d) if d else u.copy()
    w = np.concatenate([np.zeros(d), w])  # keep indexing aligned with t

    r = max(p, q + 1, 1)
    T = np.zeros((r, r))
    T[:p, 0] = phi
    T[: r - 1, 1:] += np.eye(r - 1)
    R = np.zeros((r, 1))
    R[0, 0] = 1.0
    R[1 : 1 + q, 0] = theta
    Z = np.zeros(r)
    Z[0] = 1.0
    RQR = sigma2 * (R @ R.T)

    diffuse = kappa * max(sigma2, 1.0)
    try:
        P = linalg.solve_discrete_lyapunov(T, RQR)
        P = 0.5 * (P + P.T)
        if not (
            np.all(np.isfinite(P))
            and np.all(np.diag(P) >= -1e-6)
            and np.max(np.abs(P)) < diffuse
        ):
            P = diffuse * np.eye(r)
    except Exception:
        P = diffuse * np.eye(r)

    a = np.zeros(r)
    ll = 0.0
    log2pi = float(np.log(2.0 * np.pi))
    for t in range(d, int(n_valid)):
        a = T @ a
        P = T @ P @ T.T + RQR
        v = w[t] - Z @ a
        F = max(float(Z @ P @ Z), 1e-300)
        if (
            not np.isfinite(v)
            or F > 1e280
            or abs(v) > 1e150  # v*v itself must not overflow...
            # ...and neither may the ratio v²/F (tiny-F case).
            or (abs(v) > 1.0 and 2.0 * np.log(abs(v)) - np.log(F) > 700.0)
        ):
            # A diverged candidate (explosive AR draw): reject it
            # outright instead of letting v*v/F overflow into inf/nan
            # arithmetic (nan would also confuse Nelder-Mead's ordering,
            # where -inf sorts cleanly worst). The log-space check bounds
            # v²/F below the float64 overflow threshold.
            return -np.inf
        ll += -0.5 * (log2pi + np.log(F) + v * v / F)
        K = P @ Z / F
        a = a + K * v
        P = P - np.outer(K, Z @ P)
        P = 0.5 * (P + P.T)
    return ll


def sarimax_polish(
    cfg: SarimaxConfig,
    params,
    y,
    exog,
    order,
    n_valid: int | None = None,
    *,
    max_iter: int = 4000,
) -> tuple[np.ndarray, float]:
    """Polish an f32 fit's packed params in float64 on the host.

    ``params`` is the packed vector :func:`sarimax_fit` returns
    (``[beta, phi(max_p), theta(max_q), log_sigma2]``); the polish
    optimizes only the active ``(p, d, q)`` coefficients and returns the
    re-packed vector plus the achieved f64 log-likelihood. Two chained
    scipy Nelder-Mead runs (restarted simplex) mirror the f32 fit's own
    chain, just in double precision.
    """
    from scipy import optimize

    y = np.asarray(y, float)
    exog = np.asarray(exog, float)
    params = np.asarray(params, float)
    p, d, q = (int(v) for v in np.asarray(order))
    k = cfg.k_exog
    n_valid = int(len(y) if n_valid is None else n_valid)

    # Unpad: pull the active coefficients out of the packed layout.
    x0 = np.concatenate(
        [
            params[:k],
            params[k : k + p],
            params[k + cfg.max_p : k + cfg.max_p + q],
            params[-1:],
        ]
    )

    def nll(x):
        ll = _f64_loglike(x, y, exog, (p, d, q), n_valid)
        return -ll if np.isfinite(ll) else 1e12

    opts = {"maxiter": max_iter, "xatol": 1e-6, "fatol": 1e-8}
    res = optimize.minimize(nll, x0, method="Nelder-Mead", options=opts)
    res = optimize.minimize(nll, res.x, method="Nelder-Mead", options=opts)
    # Keep the polish only if it actually improved (it starts at the f32
    # incumbent, so this is monotone by construction barring pathologies).
    if res.fun > nll(x0):
        res.x, res.fun = x0, nll(x0)

    out = params.copy()
    out[:k] = res.x[:k]
    out[k : k + cfg.max_p] = 0.0
    out[k : k + p] = res.x[k : k + p]
    out[k + cfg.max_p : k + cfg.max_p + cfg.max_q] = 0.0
    out[k + cfg.max_p : k + cfg.max_p + q] = res.x[k + p : k + p + q]
    out[-1] = res.x[-1]
    return out, -float(res.fun)
