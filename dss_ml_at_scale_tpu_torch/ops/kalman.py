"""Univariate linear-Gaussian Kalman filter over a batch of series.

Port of ``dss_ml_at_scale_tpu/ops/kalman.py``. The JAX filter is one
``lax.scan`` per series, ``vmap``-ed over thousands of series; here the
series are the leading batch axes of every argument and a Python loop over
time replaces the scan, so each time step is a handful of batched
operations over all series at once. Everything is differentiable with
``torch.autograd`` (BFGS takes the gradient of the SARIMAX likelihood
through it).

Model (time-invariant, scalar observation):

    y_t = Z a_t + eps_t,        eps_t ~ N(0, H)
    a_{t+1} = T a_t + R eta_t,  eta_t ~ N(0, Q)

A per-step ``mask`` marks valid observations: masked steps skip the
measurement update and add nothing to the log-likelihood, which is how
padded variable-length groups ride one fixed-shape batched filter.

Shapes: ``y`` ``[..., n]``, ``T`` ``[..., m, m]``, ``R`` ``[..., m, r]``,
``Q`` ``[..., r, r]``, ``Z`` ``[..., m]``, ``H`` ``[...]``, ``a0``
``[..., m]``, ``P0`` ``[..., m, m]``, ``mask`` ``[..., n]``; the batch axes
broadcast against each other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_LOG2PI = 1.8378770664093453


class KalmanFiltered(NamedTuple):
    loglike: torch.Tensor  # [...]: sum of masked per-step log-likelihoods
    pred_mean: torch.Tensor  # [..., n] one-step-ahead prediction Z a_{t|t-1}
    pred_var: torch.Tensor  # [..., n] one-step-ahead prediction variance F_t
    a_last: torch.Tensor  # [..., m] filtered state after the last step
    P_last: torch.Tensor  # [..., m, m] filtered covariance after the last step


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``A @ x``."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def kalman_filter(
    y: torch.Tensor,
    T: torch.Tensor,
    R: torch.Tensor,
    Q: torch.Tensor,
    Z: torch.Tensor,
    H: torch.Tensor,
    a0: torch.Tensor,
    P0: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> KalmanFiltered:
    """Run the filter over ``y``; return the likelihood and the predictions."""
    n = y.shape[-1]
    H = torch.as_tensor(H, dtype=y.dtype, device=y.device)
    RQR = R @ Q @ R.mT
    a, P = a0, P0
    lls, means, variances = [], [], []
    for t in range(n):
        # Predict.
        a_pred = _mv(T, a)
        P_pred = T @ P @ T.mT + RQR
        # Innovation.
        za = (Z * a_pred).sum(-1)
        v = y[..., t] - za
        PZ = _mv(P_pred, Z)
        F = (Z * PZ).sum(-1) + H
        F_safe = torch.clamp_min(F, 1e-12)
        # Update (skipped where masked).
        K = PZ / F_safe.unsqueeze(-1)
        a_upd = a_pred + K * v.unsqueeze(-1)
        ZP = (Z.unsqueeze(-2) @ P_pred).squeeze(-2)
        P_upd = P_pred - K.unsqueeze(-1) * ZP.unsqueeze(-2)
        if mask is None:
            a, P = a_upd, P_upd
        else:
            valid = mask[..., t]
            a = torch.where(valid.unsqueeze(-1), a_upd, a_pred)
            P = torch.where(valid[..., None, None], P_upd, P_pred)
        # Keep covariance symmetric against roundoff drift.
        P = 0.5 * (P + P.mT)
        ll = -0.5 * (_LOG2PI + torch.log(F_safe) + v * v / F_safe)
        lls.append(ll if mask is None else torch.where(mask[..., t], ll, 0.0))
        means.append(za)
        variances.append(F)
    return KalmanFiltered(torch.stack(lls, -1).sum(-1), torch.stack(means, -1),
                          torch.stack(variances, -1), a, P)


def kalman_filter_companion(
    y: torch.Tensor,
    phi: torch.Tensor,
    RQR: torch.Tensor,
    a0: torch.Tensor,
    P0: torch.Tensor,
    mask: torch.Tensor,
    *,
    with_loglike: bool = True,
) -> KalmanFiltered:
    """:func:`kalman_filter` for a companion transition and a first-state
    observation: ``T`` has ``phi`` (``[..., m]``) in its first column and
    ones on its superdiagonal, ``Z = e_0`` and ``H = 0``, with ``RQR =
    R Q R^T`` given (``[..., m, m]``). That is the Harvey representation
    of an ARMA model, and the same filter as the general one; the products
    with ``T`` are a row/column shift plus a rank-one term, so each step
    is a few elementwise operations on ``[..., m, m]`` instead of batched
    5 x 5 matrix products, and ``Z`` picks entries instead of multiplying.

    ``with_loglike=False`` skips the per-step likelihood (the returned
    ``loglike`` is then ``None``): the concentrated SARIMAX objective only
    reads the predictions.
    """
    n = y.shape[-1]
    phi_col = phi.unsqueeze(-1)
    phi_row = phi.unsqueeze(-2)
    a, P = a0, P0
    lls, means, variances = [], [], []
    for t in range(n):
        # Predict: a_pred = T a, P_pred = T P T^T + RQR. T shifts rows up
        # (its superdiagonal) and adds phi times the first row; the shifts
        # are added in place, which on the card beats out-of-place pads
        # (PERF.md section 6).
        a_pred = phi * a[..., :1]
        a_pred[..., :-1] += a[..., 1:]
        TP = phi_col * P[..., :1, :]
        TP[..., :-1, :] += P[..., 1:, :]
        P_pred = TP[..., :1] * phi_row + RQR
        P_pred[..., :-1] += TP[..., 1:]
        # Innovation: Z a_pred = a_pred[0], F = P_pred[0, 0].
        za = a_pred[..., 0]
        v = y[..., t] - za
        F = P_pred[..., 0, 0]
        F_safe = torch.clamp_min(F, 1e-12)
        # Update (skipped where masked).
        K = P_pred[..., :, 0] / F_safe.unsqueeze(-1)
        valid = mask[..., t]
        a = torch.where(valid.unsqueeze(-1), a_pred + K * v.unsqueeze(-1), a_pred)
        P = torch.where(valid[..., None, None],
                        P_pred - K.unsqueeze(-1) * P_pred[..., :1, :], P_pred)
        # Keep covariance symmetric against roundoff drift.
        P = 0.5 * (P + P.mT)
        if with_loglike:
            ll = -0.5 * (_LOG2PI + torch.log(F_safe) + v * v / F_safe)
            lls.append(torch.where(valid, ll, 0.0))
        means.append(za)
        variances.append(F)
    loglike = torch.stack(lls, -1).sum(-1) if with_loglike else None
    return KalmanFiltered(loglike, torch.stack(means, -1), torch.stack(variances, -1), a, P)


def kalman_forecast(
    a: torch.Tensor,
    P: torch.Tensor,
    steps: int,
    T: torch.Tensor,
    R: torch.Tensor,
    Q: torch.Tensor,
    Z: torch.Tensor,
    H: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Iterate the prediction step ``steps`` times from filtered ``(a, P)``.

    Returns ``(means, variances)`` of y_{n+1..n+steps}, each ``[..., steps]``.
    """
    RQR = R @ Q @ R.mT
    means, variances = [], []
    for _ in range(steps):
        a = _mv(T, a)
        P = T @ P @ T.mT + RQR
        means.append((Z * a).sum(-1))
        variances.append((Z * _mv(P, Z)).sum(-1) + H)
    return torch.stack(means, -1), torch.stack(variances, -1)
