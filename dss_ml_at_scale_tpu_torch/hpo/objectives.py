"""Module-level demo objectives for distributed HPO.

Port of ``dss_ml_at_scale_tpu/hpo/objectives.py``. Remote trial workers
resolve an objective by its ``module:qualname`` reference
(:func:`dss_ml_at_scale_tpu_torch.parallel.trials.objective_ref`), so the
sweeps need importable functions: the counterpart of the reference's
notebook-global ``objective`` that SparkTrials pickles to executors. The
refs name this module, ``dss_ml_at_scale_tpu_torch.hpo.objectives``. The
JAX module's two group-apply demos are here too, over pyarrow groups (the
port has no pandas): importable functions for
``parallel.group_apply.group_apply(executor="process")``.
"""

from __future__ import annotations

import os
import time

from .shipping import Broadcast


def quadratic(args) -> float:
    """A smooth bowl with its minimum at x = 3."""
    return (args["x"] - 3.0) ** 2


def paced_quadratic(args) -> float:
    """:func:`quadratic` after a short sleep (``args['delay']``, default
    0.05 s), so that a sweep stays in flight while a worker dies and comes
    back."""
    time.sleep(float(args.get("delay", 0.05)))
    return quadratic(args)


def brittle_quadratic(args) -> float:
    """:func:`quadratic` that raises on half its domain: the failure-isolation
    probe."""
    if args["x"] < 0:
        raise RuntimeError(f"objective blew up at x={args['x']}")
    return (args["x"] - 3.0) ** 2


def group_pid_summary(group):
    """A per-group demo for ``group_apply(executor="process")``: the group's
    SKU, its mean demand and the worker's ``pid``. GIL-bound on purpose (a
    pure-Python loop, a stand-in for a statsmodels-style fit), and the pid
    lets a caller check that the group ran out of process."""
    import pyarrow as pa

    acc = 0.0
    for i in range(50_000):
        acc += (i % 7) * 0.5
    demand = group.column("Demand").to_numpy(zero_copy_only=False)
    return pa.table({"SKU": [group.column("SKU")[0].as_py()],
                     "mean": [float(demand.mean())], "pid": [os.getpid()]})


def brittle_group_head(group):
    """A group function that raises for one SKU (``SKU2``): the per-group
    failure-isolation probe. Other groups give their first row's SKU."""
    if group.column("SKU")[0].as_py() == "SKU2":
        raise RuntimeError("group blew up")
    return group.slice(0, 1).select(["SKU"])


# The broadcast regime (~100 MB). Workers import this module, so each
# worker process gets its own lazy Broadcast, built once there however many
# trials land on it; the build counter lets a sweep check that from outside.
_BROADCAST_BUILDS = 0


def _regression_broadcast_factory():
    global _BROADCAST_BUILDS
    _BROADCAST_BUILDS += 1
    from ..datagen.regression import gen_data

    # A sized-down stand-in by default, so the fast tests stay fast;
    # DSST_BROADCAST_BYTES sets the real ~100 MB. Deterministic either way,
    # so every worker builds the same dataset.
    return gen_data(int(os.environ.get("DSST_BROADCAST_BYTES", 1_000_000)))


REGRESSION_BROADCAST = Broadcast(factory=_regression_broadcast_factory)


def lasso_broadcast(args) -> dict:
    """A Lasso fit against the per-process broadcast dataset; the result
    carries the worker's pid and its factory-build count."""
    from ..datagen.regression import train_and_eval

    result = train_and_eval(REGRESSION_BROADCAST.value, args["alpha"])
    result["pid"] = os.getpid()
    result["broadcast_builds"] = _BROADCAST_BUILDS
    return result


def lasso_shared(args) -> dict:
    """A Lasso fit against a shared-filesystem dataset (the 1 GB regime):
    ``args['data_path']`` names an npz of :func:`..hpo.shipping.save_shared`,
    read once per process."""
    from ..datagen.regression import train_and_eval
    from .shipping import load_shared

    arrays = load_shared(args["data_path"])
    data = (arrays["X_train"], arrays["X_test"], arrays["y_train"], arrays["y_test"])
    return train_and_eval(data, args["alpha"])
