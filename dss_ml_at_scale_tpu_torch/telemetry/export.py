"""Telemetry export: process-0 file writes + RPC pull of remote hosts.

Port of ``dss_ml_at_scale_tpu/telemetry/export.py``. Every process
*accumulates* telemetry, but only process 0 *writes* exports (the tracking
store's discipline); the other processes' snapshots travel over the
:mod:`..runtime.rpc` control plane instead: a ``trial-worker`` serves
:func:`rpc_handlers` beside its trials, and a coordinator pulls them with
:func:`collect_remote_snapshots`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path


def write_exports(directory: str | os.PathLike, *, registry=None,
                  span_log=None, coordinator_only: bool = True) -> list:
    """Write ``telemetry.json`` + ``metrics.prom`` + ``spans.jsonl`` +
    ``trace.json`` (Perfetto) under ``directory``.

    Returns the written paths; empty on a process other than 0 when
    ``coordinator_only`` (the default, as ``RunStore``).
    """
    if coordinator_only:
        from ..runtime import distributed as rt

        if rt.process_index() != 0:
            return []
    from . import get_registry, get_span_log
    from .spans import to_perfetto

    registry = registry if registry is not None else get_registry()
    span_log = span_log if span_log is not None else get_span_log()
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)

    written = []

    def _emit(name: str, text: str) -> None:
        path = directory / name
        path.write_text(text)
        written.append(path)

    _emit("telemetry.json", json.dumps(registry.snapshot(), indent=1))
    _emit("metrics.prom", registry.render_prometheus())
    events = span_log.events()
    _emit("spans.jsonl", "".join(json.dumps(e) + "\n" for e in events))
    _emit("trace.json", json.dumps(to_perfetto(events)))
    return written


def rpc_handlers(registry=None, span_log=None) -> dict:
    """Handlers an :class:`~dss_ml_at_scale_tpu_torch.runtime.rpc.RpcServer`
    merges in: ``telemetry_snapshot`` (the registry's snapshot) and
    ``telemetry_spans`` (the span log's events), of the process defaults
    unless others are given."""

    def _snapshot(_payload):
        from . import get_registry

        reg = registry if registry is not None else get_registry()
        return reg.snapshot()

    def _spans(_payload):
        from . import get_span_log

        log = span_log if span_log is not None else get_span_log()
        return log.events()

    return {"telemetry_snapshot": _snapshot, "telemetry_spans": _spans}


def collect_remote_snapshots(workers, *, secret=None, timeout: float = 30.0) -> dict:
    """Pull ``telemetry_snapshot`` from each ``host:port`` worker.

    Returns ``{address: snapshot_dict}``; an unreachable worker maps to
    ``{"error": "..."}`` instead of failing the whole collection (the
    coordinator is usually mid-teardown when it calls this).
    """
    from ..runtime.rpc import rpc_call

    out = {}
    for addr in workers:
        try:
            out[addr] = rpc_call(addr, "telemetry_snapshot", None, timeout=timeout,
                                 secret=secret)
        except Exception as e:  # one dead worker must not cost the others' snapshots
            out[addr] = {"error": f"{type(e).__name__}: {e}"}
    return out
