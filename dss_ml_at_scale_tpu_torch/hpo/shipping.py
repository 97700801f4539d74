"""How training data reaches distributed HPO objectives.

Port of ``dss_ml_at_scale_tpu/hpo/shipping.py``. The reference spends a
notebook on it (``hyperopt/2. hyperopt on diff sizes of data.py``): three
size regimes.

1. **Up to ~10 MB: closure capture.** Local trials run in threads of one
   process, so a closure ships by reference for free; nothing here.
2. **~100 MB: broadcast** (``sc.broadcast`` / ``.value``). :class:`Broadcast`
   is a once-per-process handle: define a module-level
   ``Broadcast(factory=...)`` beside a module-level objective
   (``hpo/objectives.py``: ``REGRESSION_BROADCAST``, ``lasso_broadcast``) and
   hand the objective by reference to
   :class:`~dss_ml_at_scale_tpu_torch.parallel.trials.HostTrials`: each
   worker process imports the module and builds the value on its first
   trial; every later trial there shares it. The factory ships, not the
   data.
3. **1 GB and up: a shared filesystem.** :func:`save_shared` and
   :func:`load_shared` are the ``save_to_dbfs``/``load`` pattern against
   any mounted path, cached once per process.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np


class Broadcast:
    """A once-per-process shared handle for a medium-sized object.

    ``Broadcast(factory=f)`` defers ``f()``; ``.value`` builds it once per
    process (thread-safe) and every trial of the process shares it.
    """

    def __init__(self, value=None, factory=None):
        if (value is None) == (factory is None):
            raise ValueError("pass exactly one of value / factory")
        self._value = value
        self._factory = factory
        self._lock = threading.Lock()

    @property
    def value(self):
        if self._value is None:
            with self._lock:
                if self._value is None:
                    self._value = self._factory()
        return self._value

    def unpersist(self) -> None:
        """Release the built value. Only a factory-backed handle can build
        it again; a value-backed one could not, so it refuses."""
        if self._factory is None:
            raise ValueError(
                "cannot unpersist a value-backed Broadcast (it could never be rebuilt); "
                "construct with factory= to make it releasable")
        with self._lock:
            self._value = None


def broadcast(value) -> Broadcast:
    return Broadcast(value=value)


_cache: dict[str, dict[str, np.ndarray]] = {}
_cache_lock = threading.Lock()
_key_locks: dict[str, threading.Lock] = {}


def save_shared(path: str | os.PathLike, **arrays: np.ndarray) -> str:
    """Write arrays to a shared location as one ``.npz``; returns its path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return str(path) if str(path).endswith(".npz") else str(path) + ".npz"


def load_shared(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Arrays saved by :func:`save_shared`, read once per process (a lock
    per path held across the read: of N trial threads racing on the first
    access, one pays the read and all share its dict)."""
    key = str(path)
    with _cache_lock:
        key_lock = _key_locks.setdefault(key, threading.Lock())
    with key_lock:
        with _cache_lock:
            if key in _cache:
                return _cache[key]
        with np.load(key) as npz:
            data = {name: npz[name] for name in npz.files}
        with _cache_lock:
            _cache[key] = data
        return data


def clear_shared_cache() -> None:
    with _cache_lock:
        _cache.clear()
        _key_locks.clear()
