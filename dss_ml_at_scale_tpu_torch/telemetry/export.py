"""Telemetry pulled over the RPC control plane.

Port of the two pull handlers of ``dss_ml_at_scale_tpu/telemetry/export.py``
(``rpc_handlers``) that a ``trial-worker`` serves, so a coordinator can read
the worker's counters and spans over the same connection it sends trials
on. The file exports and the coordinator's collection of remote snapshots
are not ported yet.
"""

from __future__ import annotations


def rpc_handlers() -> dict:
    """Handlers an :class:`~dss_ml_at_scale_tpu_torch.runtime.rpc.RpcServer`
    merges in: ``telemetry_snapshot`` (the process registry's snapshot) and
    ``telemetry_spans`` (the process span log's events)."""
    from . import get_registry, get_span_log

    return {"telemetry_snapshot": lambda _payload: get_registry().snapshot(),
            "telemetry_spans": lambda _payload: get_span_log().events()}
