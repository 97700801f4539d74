"""Byte-sized regression fixtures and the tune-alpha playbook, without
scikit-learn.

Port of ``dss_ml_at_scale_tpu/datagen/regression.py``, the utility trio of
the reference's ``hyperopt/2. hyperopt on diff sizes of data.py``:
``gen_data(bytes)`` (a synthetic regression sized to a byte budget),
``train_and_eval`` (a Lasso fit scored by R²) and ``tune_alpha`` (a 4-eval
TPE sweep at parallelism 2 on the device-pinned executor).

The JAX package calls scikit-learn for all three; the card's host may not
have it, so the port keeps its own copies:

- :func:`make_regression` and :func:`train_test_split` are scikit-learn's
  ``make_regression`` (its defaults: 10 informative features, no noise, no
  bias, shuffled) and ``train_test_split`` (a seeded permutation), as the
  same numpy ``RandomState`` draws in the same order: bit for bit the
  arrays scikit-learn returns.
- :func:`lasso_fit` is ``Lasso(alpha).fit``: cyclic coordinate descent in
  float64 on centred data, the L1 weight ``alpha * n_samples``, and the
  stop of ``sklearn/linear_model/_cd_fast.pyx``: when the largest
  coefficient step is under ``tol`` of the largest coefficient (or at the
  last sweep), the duality gap against ``tol * ||y||²`` (tol 1e-4,
  max_iter 1000). Its gap-safe screening only skips coordinates proven to
  be zero at the optimum, and is left out.
- :func:`r2_score` is ``1 - SS_res / SS_tot``.

The objective runs on the host in numpy, as the JAX package's does.
"""

from __future__ import annotations

import math

import numpy as np


N_INFORMATIVE = 10  # make_regression's default
MAX_ITER, TOL = 1000, 1e-4  # Lasso's defaults


def make_regression(n_samples: int, n_features: int = 100, *,
                    random_state: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``make_regression(n_samples, n_features,
    random_state=...)`` at its other defaults: X standard normal, the first
    10 true coefficients ``100 * U[0, 1)``, ``y = X @ coef``, then the rows
    and the columns shuffled."""
    rng = np.random.RandomState(random_state)
    X = rng.standard_normal(size=(n_samples, n_features))
    ground_truth = np.zeros((n_features, 1))
    ground_truth[:N_INFORMATIVE, :] = 100 * rng.uniform(size=(N_INFORMATIVE, 1))
    y = np.dot(X, ground_truth) + 0.0
    rows = np.arange(n_samples)
    rng.shuffle(rows)
    X, y = X[rows], y[rows]
    cols = np.arange(n_features)
    rng.shuffle(cols)
    X[:, :] = X[:, cols]
    return X, np.squeeze(y)


def train_test_split(X: np.ndarray, y: np.ndarray, *, test_size: float = 0.2,
                     random_state: int = 1):
    """scikit-learn's ``train_test_split(X, y, test_size=..., random_state=...)``:
    ``ceil(test_size * n)`` rows to the test split, by one seeded
    permutation; returns ``X_train, X_test, y_train, y_test``."""
    n = len(X)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return X[train], X[test], y[train], y[test]


def gen_data(n_bytes: int, n_features: int = 100):
    """Train/test split of a regression problem of about ``n_bytes``: float64
    rows of ``n_features + 1`` values, so ``bytes / ((F + 1) * 8)`` samples."""
    n_samples = int((1.0 * n_bytes / (n_features + 1)) / 8)
    X, y = make_regression(n_samples, n_features, random_state=0)
    return train_test_split(X, y, test_size=0.2, random_state=1)


def _duality_gap(X, y, w, R, l1) -> float:
    """scikit-learn's Lasso duality gap (``gap_enet``, formulation A, no L2)."""
    xtr = X.T @ R
    dual_norm = np.max(np.abs(xtr))
    r2, ry = R @ R, R @ y
    primal = 0.5 * r2 + l1 * np.sum(np.abs(w))
    scale = l1 / dual_norm if dual_norm > l1 else 1.0
    return primal - (-0.5 * scale ** 2 * r2 + scale * ry)


def lasso_fit(X: np.ndarray, y: np.ndarray, alpha: float) -> tuple[np.ndarray, float]:
    """``Lasso(alpha).fit(X, y)``: ``(coef, intercept)`` of
    ``1/(2n) ||y - Xw - b||² + alpha ||w||_1``, by cyclic coordinate descent
    on centred data (see the module docstring)."""
    n, p = X.shape
    x_mean, y_mean = X.mean(axis=0), y.mean()
    Xc = np.asfortranarray(X - x_mean)
    yc = y - y_mean
    l1 = alpha * n
    norm2 = np.einsum("ij,ij->j", Xc, Xc)
    w = np.zeros(p)
    R = yc.copy()
    tol_gap = TOL * (yc @ yc)
    if _duality_gap(Xc, yc, w, R, l1) > tol_gap:
        for sweep in range(MAX_ITER):
            w_max = d_w_max = 0.0
            for j in range(p):
                if norm2[j] == 0.0:
                    continue
                w_j = w[j]
                col = Xc[:, j]
                tmp = col @ R + w_j * norm2[j]
                w[j] = math.copysign(max(abs(tmp) - l1, 0.0), tmp) / norm2[j]
                if w[j] != w_j:
                    R += (w_j - w[j]) * col
                d_w_max = max(d_w_max, abs(w[j] - w_j))
                w_max = max(w_max, abs(w[j]))
            if (w_max == 0.0 or d_w_max / w_max <= TOL or sweep == MAX_ITER - 1) and \
                    _duality_gap(Xc, yc, w, R, l1) <= tol_gap:
                break
    return w, y_mean - x_mean @ w


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The coefficient of determination, ``1 - SS_res / SS_tot``."""
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot)


def train_and_eval(data, alpha: float) -> dict:
    """Lasso fit and R² score on the test split, the reference's objective
    body (its 'loss' is the R², as in the reference and the JAX package)."""
    X_train, X_test, y_train, y_test = data
    coef, intercept = lasso_fit(X_train, y_train, alpha)
    loss = r2_score(y_test, X_test @ coef + intercept)
    return {"loss": loss, "status": "ok"}


def tune_alpha(objective, parallelism: int = 2, max_evals: int = 4, tracker=None,
               trials=None, devices=None) -> float:
    """A ``max_evals``-eval TPE sweep of alpha over U[0, 10] on the parallel
    executor, seeded 0. ``trials`` (default: a fresh ``DeviceTrials`` over
    ``devices``, by default every card of the host) may be a pre-filled
    store: how ``hpo --resume-auto`` continues a killed sweep."""
    from ..hpo import fmin, hp
    from ..parallel.trials import DeviceTrials

    if trials is None:
        trials = DeviceTrials(parallelism=parallelism, devices=devices)
    best = fmin(objective, hp.uniform("alpha", 0.0, 10.0), max_evals=max_evals,
                trials=trials, rstate=np.random.default_rng(0), tracker=tracker)
    return best["alpha"]
