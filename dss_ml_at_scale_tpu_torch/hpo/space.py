"""Search-space primitives.

Port of ``dss_ml_at_scale_tpu/hpo/space.py`` (host numpy, the same
arithmetic, so a seeded generator draws the same points): the hyperopt
``hp.*`` surface the reference uses, ``hp.lognormal('C', 0, 1.0)``,
``hp.uniform('alpha', 0.0, 10.0)`` and ``scope.int(hp.quniform('p', 0, 4,
1))`` for SARIMAX orders.

A space is any nest of dict/list/tuple whose leaves may be :class:`Param`
nodes. Points are flat ``{label: value}`` dicts (what hyperopt's ``fmin``
returns); :func:`space_eval` substitutes a point back into the space.

Each param defines a bijection to an unconstrained "latent" space where
TPE models densities: uniform -> identity, loguniform -> log, etc.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    label: str
    kind: str  # uniform | loguniform | normal | lognormal | quniform | qloguniform | choice
    args: tuple
    to_int: bool = False

    # -- prior sampling ---------------------------------------------------

    def sample(self, rng: np.random.Generator):
        return self.from_latent(self.sample_latent(rng))

    def sample_latent(self, rng: np.random.Generator) -> float:
        k, a = self.kind, self.args
        if k in ("uniform", "quniform"):
            return float(rng.uniform(a[0], a[1]))
        if k in ("loguniform", "qloguniform"):
            return float(rng.uniform(math.log(a[0]), math.log(a[1])))
        if k == "normal":
            return float(rng.normal(a[0], a[1]))
        if k == "lognormal":
            return float(rng.normal(a[0], a[1]))  # latent is log-value
        if k == "choice":
            return int(rng.integers(len(a[0])))
        raise ValueError(f"unknown param kind {k}")

    # -- latent <-> value -------------------------------------------------

    def from_latent(self, z: float):
        k, a = self.kind, self.args
        if k == "uniform":
            v = float(np.clip(z, a[0], a[1]))
        elif k == "loguniform":
            v = float(np.exp(np.clip(z, math.log(a[0]), math.log(a[1]))))
        elif k == "normal":
            v = float(z)
        elif k == "lognormal":
            v = float(np.exp(z))
        elif k == "quniform":
            v = float(np.clip(round(z / a[2]) * a[2], a[0], a[1]))
        elif k == "qloguniform":
            v = float(np.clip(round(math.exp(z) / a[2]) * a[2], a[0], a[1]))
        elif k == "choice":
            v = int(np.clip(int(round(z)), 0, len(a[0]) - 1))
        else:
            raise ValueError(f"unknown param kind {k}")
        if self.to_int and k != "choice":
            return int(v)
        return v

    def to_latent(self, v) -> float:
        k, a = self.kind, self.args
        if k in ("uniform", "quniform", "normal"):
            return float(v)
        if k in ("loguniform", "qloguniform", "lognormal"):
            return math.log(max(float(v), 1e-300))
        if k == "choice":
            return float(v)
        raise ValueError(f"unknown param kind {k}")

    @property
    def latent_bounds(self) -> tuple[float, float]:
        k, a = self.kind, self.args
        if k in ("uniform", "quniform"):
            return float(a[0]), float(a[1])
        if k in ("loguniform", "qloguniform"):
            return math.log(a[0]), math.log(a[1])
        return -math.inf, math.inf

    @property
    def n_choices(self) -> int | None:
        return len(self.args[0]) if self.kind == "choice" else None

    def resolve(self, index_or_value):
        """Final user-facing value (choice params map index → option)."""
        if self.kind == "choice":
            return self.args[0][int(index_or_value)]
        return index_or_value


# -- traversal ---------------------------------------------------------------


def iter_params(space) -> list[Param]:
    out: dict[str, Param] = {}

    def walk(node):
        if isinstance(node, Param):
            if node.label in out and out[node.label] != node:
                raise ValueError(f"duplicate param label {node.label!r}")
            out[node.label] = node
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(space)
    return list(out.values())


def sample_space(space, rng: np.random.Generator) -> dict[str, Any]:
    """Sample a point (``{label: value}``) from the prior."""
    return {p.label: p.sample(rng) for p in iter_params(space)}


def space_eval(space, point: dict[str, Any]):
    """Substitute a point into the space structure (hyperopt's space_eval)."""

    def walk(node):
        if isinstance(node, Param):
            return node.resolve(point[node.label])
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(space)
