"""The ``hp.*`` space-construction namespace (hyperopt's names).

Port of ``dss_ml_at_scale_tpu/hpo/hp.py``.
"""

from __future__ import annotations

from .space import Param


def uniform(label: str, low: float, high: float) -> Param:
    return Param(label, "uniform", (low, high))


def loguniform(label: str, low: float, high: float) -> Param:
    """NOTE: bounds are the *value* bounds, not exponents (unlike hyperopt,
    which takes log-bounds; value bounds read better and convert trivially)."""
    if low <= 0:
        raise ValueError(f"loguniform({label!r}) needs low > 0, got {low}")
    return Param(label, "loguniform", (low, high))


def normal(label: str, mu: float, sigma: float) -> Param:
    return Param(label, "normal", (mu, sigma))


def lognormal(label: str, mu: float, sigma: float) -> Param:
    """exp(Normal(mu, sigma)), the reference's SVC-C prior."""
    return Param(label, "lognormal", (mu, sigma))


def quniform(label: str, low: float, high: float, q: float) -> Param:
    return Param(label, "quniform", (low, high, q))


def qloguniform(label: str, low: float, high: float, q: float) -> Param:
    if low <= 0:
        raise ValueError(f"qloguniform({label!r}) needs low > 0, got {low}")
    return Param(label, "qloguniform", (low, high, q))


def choice(label: str, options) -> Param:
    return Param(label, "choice", (tuple(options),))


def randint(label: str, upper: int) -> Param:
    """Uniform integer in [0, upper), modeled as a choice over the range so
    every value is equally likely (quniform with rounding would halve the
    endpoint probabilities)."""
    return Param(label, "choice", (tuple(range(upper)),))


class scope:
    """``scope.int(hp.quniform(...))``: the integer cast marker."""

    @staticmethod
    def int(param: Param) -> Param:
        return Param(param.label, param.kind, param.args, to_int=True)
