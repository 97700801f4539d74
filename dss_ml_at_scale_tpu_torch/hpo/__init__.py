"""Hyperparameter optimization: search spaces, TPE, fmin, trials.

Port of ``dss_ml_at_scale_tpu/hpo`` (host numpy; no device work): the
hyperopt-compatible surface the reference drives in its tracks, nested
inside the per-SKU UDF of the forecasting track among them: ``fmin`` +
``tpe.suggest`` + ``hp.*`` spaces + ``Trials`` + the ``STATUS_OK``
protocol, with a seeded ``rstate``. Concurrent trials (the SparkTrials
replacement) live in :mod:`dss_ml_at_scale_tpu_torch.parallel.trials` and
plug in as ``trials=``.
"""

from . import hp  # noqa: F401
from .fmin import (  # noqa: F401
    STATUS_FAIL,
    STATUS_OK,
    Trials,
    fmin,
)
from .space import sample_space, space_eval  # noqa: F401
from .tpe import TPE, random_suggest, tpe_suggest  # noqa: F401
