"""Serving of the port: cross-request batching, admission, lifecycle, and
LM token serving.

Port of ``dss_ml_at_scale_tpu/serving``. The subsystem between the HTTP
layer (:mod:`..workloads.serving`) and the scorer. Pipeline per admitted
image::

    HTTP thread          decode pool          batcher (1 thread)
    -----------          -----------          ------------------
    admit (429 if full)  JPEG -> array        coalesce ACROSS requests
    enqueue + block      off the scorer       to the micro-batch
    ... wait ...         thread               (full OR window elapsed)
    respond <-------------------- results <-- score once, fan out rows

:class:`ServingScheduler` is the facade; :class:`SchedulerConfig` the
knobs (the ``serve`` command's flags map 1:1); :class:`Lifecycle` +
:class:`ServerHandle` the readiness/drain story; the exceptions the HTTP
status contract (QueueFull → 429, DeadlineExceeded/NotAccepting → 503).
:mod:`.lm` is the token-streaming tier.
"""

from __future__ import annotations

from .admission import (
    AdmissionController,
    DeadlineExceeded,
    NotAccepting,
    QueueFull,
    Request,
    SchedulerError,
    WorkItem,
)
from .batcher import Batcher, DecodePool
from .lifecycle import DRAINING, READY, STARTING, STOPPED, Lifecycle, ServerHandle
from .scheduler import SchedulerConfig, ServingScheduler

__all__ = [
    "AdmissionController",
    "Batcher",
    "DRAINING",
    "DeadlineExceeded",
    "DecodePool",
    "Lifecycle",
    "NotAccepting",
    "QueueFull",
    "READY",
    "Request",
    "STARTING",
    "STOPPED",
    "SchedulerConfig",
    "SchedulerError",
    "ServerHandle",
    "ServingScheduler",
    "WorkItem",
]
