"""Serving of the port: admission, lifecycle, and LM token serving.

Port of the parts of ``dss_ml_at_scale_tpu/serving`` that the LM path uses.
The image tier's scheduler, batcher and decode pool come with the
image-serving slice.
"""

from __future__ import annotations

from .admission import (
    AdmissionController,
    DeadlineExceeded,
    NotAccepting,
    QueueFull,
    SchedulerError,
)
from .lifecycle import DRAINING, READY, STARTING, STOPPED, Lifecycle, ServerHandle

__all__ = [
    "AdmissionController",
    "DRAINING",
    "DeadlineExceeded",
    "Lifecycle",
    "NotAccepting",
    "QueueFull",
    "READY",
    "STARTING",
    "STOPPED",
    "SchedulerError",
    "ServerHandle",
]
