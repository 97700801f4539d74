"""Fleet federation: scrape N replicas' ``GET /telemetry``, merge into
one registry + SLO view.

Port copy of ``dss_ml_at_scale_tpu/telemetry/federation.py`` (the JAX
package's module imports nothing of JAX, but the port keeps its own copy).

Every observability tier below this one is process-local by design (the
registry, the windows, the SLO engine all meter ONE process); the
ROADMAP's router/autoscaler direction needs the *fleet* judged — "is
the service as a whole burning its error budget", not "is replica 3".
This module is that aggregation plane, shaped like the reference
paper's Spark coordinator, which never recomputes executor state: it
collects per-executor summaries and folds them (PAPER.md).

Mechanics:

- each replica serves its full registry (raw bucket counts, raw window
  digests) plus its SLO engine's measurement windows on
  ``GET /telemetry`` (:meth:`MetricsRegistry.wire_snapshot` +
  :meth:`SloEngine.wire_sources`);
- :class:`FleetAggregator` scrapes all endpoints concurrently with a
  bounded per-cycle budget — one dead or hung replica costs its column,
  never the cycle (scrape threads are daemons; the join honors the
  deadline and abandons stragglers);
- merges are *loud* on geometry mismatch (wire version, histogram
  buckets, window_s) — exactly the histogram-bucket contract the local
  registry enforces between two call sites — but a replica that fails
  to merge degrades to ``outcome="error"`` and the cycle continues
  with the rest of the fleet;
- the aggregator's own health is metered through the front door:
  ``fleet_scrape_total{endpoint,outcome}``, ``fleet_replicas_up``,
  ``fleet_scrape_staleness_seconds{endpoint}`` on the process-default
  registry (declared in KNOWN_METRICS);
- scrape cycles are journaled crash-durably
  (:func:`~dss_ml_at_scale_tpu_torch.resilience.durability.append_jsonl`,
  ``kind="fleet"``) so a post-mortem can answer "what did the fleet
  look like when the autoscaler acted".

The fleet SLO judgment reuses the unmodified :class:`SloEngine` state
machine over *merged* windows: sources are rebuilt each cycle
(:meth:`SloEngine.reset_sources` — windows are re-merged from fresh
replica snapshots), while alert states persist across cycles so
pending→firing debounce works at fleet scope too.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Sequence

from .registry import MetricsRegistry
from .slo import SloEngine

FEDERATION_SCHEMA_VERSION = 1

# Per-cycle scrape budget: generous against a LAN replica's ~1 ms
# response, tight enough that a dead endpoint costs one bounded wait.
DEFAULT_SCRAPE_TIMEOUT_S = 2.0


def parse_endpoint(url: str) -> tuple[str, int]:
    """``host:port`` / ``http://host:port`` -> ``(host, port)``.
    http-only, like every other scrape target of the CLI."""
    if "://" in url and not url.startswith("http://"):
        raise ValueError(f"only http:// URLs are supported, got {url!r}")
    hostport = url.removeprefix("http://").rstrip("/")
    host, _, port_s = hostport.partition(":")
    return host or "127.0.0.1", int(port_s or 8008)


def fetch_telemetry(endpoint: str, timeout_s: float) -> dict:
    """One replica's ``GET /telemetry`` document. Raises OSError /
    ValueError on anything short of a parsed 200 — the aggregator maps
    those to a per-replica outcome instead of letting them escape."""
    import http.client
    import json

    host, port = parse_endpoint(endpoint)
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", "/telemetry")
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise OSError(f"GET /telemetry -> HTTP {resp.status}")
    doc = json.loads(body)
    if not isinstance(doc, dict):
        raise ValueError(f"/telemetry returned {type(doc).__name__}")
    return doc


@dataclasses.dataclass
class ReplicaScrape:
    """One endpoint's outcome within one scrape cycle."""

    endpoint: str
    up: bool = False
    outcome: str = "down"  # ok | down | timeout | error
    error: str | None = None
    elapsed_s: float = 0.0
    staleness_s: float | None = None  # since last successful scrape
    doc: dict | None = None  # the raw /telemetry document when up


@dataclasses.dataclass
class FleetView:
    """One merged scrape cycle: the fleet registry + SLO judgment."""

    ts: float
    replicas: list[ReplicaScrape]
    registry: MetricsRegistry
    slo: dict  # the fleet SloEngine's render_status() document
    merged_series: int

    @property
    def up(self) -> int:
        return sum(1 for r in self.replicas if r.up)


# dsst: ignore[lock-discipline] scrape threads each write ONLY their own preallocated ReplicaScrape slot; join() is the sync point, and an abandoned straggler's late writes are inert (non-ok slots' docs are never read)
class FleetAggregator:
    """Scrape-and-merge over a fixed endpoint list.

    Hold one instance across cycles (``top --fleet`` / ``slo
    watch --fleet`` loops do): the fleet SLO alert state machine and
    the per-endpoint staleness clocks live here, so burn must persist
    across cycles to debounce into firing — exactly the per-process
    engine's contract, lifted to fleet scope.
    """

    def __init__(self, endpoints: Sequence[str], *,
                 timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S,
                 journal_path=None):
        if not endpoints:
            raise ValueError("need at least one endpoint")
        self.endpoints = tuple(endpoints)
        self.timeout_s = float(timeout_s)
        self.journal_path = (
            Path(journal_path).absolute() if journal_path else None
        )
        self._slo = SloEngine()
        self._created = time.time()
        self._last_ok: dict[str, float] = {}

    # -- one cycle ---------------------------------------------------------

    def scrape(self) -> FleetView:
        """One bounded fleet cycle: concurrent fetch, merge, judge,
        meter, journal. Never raises on replica failure and never
        blocks past ``timeout_s`` (+ scheduling slack) on a hung
        endpoint — stragglers are abandoned to their daemon threads
        and reported as ``outcome="timeout"``."""
        t0 = time.monotonic()
        slots: list[ReplicaScrape] = [
            ReplicaScrape(endpoint=e) for e in self.endpoints
        ]

        def _fetch(i: int, endpoint: str) -> None:
            start = time.monotonic()
            slot = slots[i]
            try:
                slot.doc = fetch_telemetry(endpoint, self.timeout_s)
            except (OSError, ValueError) as e:
                slot.outcome = "down"
                slot.error = str(e) or type(e).__name__
            finally:
                slot.elapsed_s = time.monotonic() - start

        threads = [
            threading.Thread(
                target=_fetch, args=(i, e), daemon=True,
                name=f"fleet-scrape-{i}",
            )
            for i, e in enumerate(self.endpoints)
        ]
        for t in threads:
            t.start()
        deadline = t0 + self.timeout_s + 0.25
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

        fleet_registry = MetricsRegistry()
        self._slo.reset_sources()
        merged_series = 0
        now = time.time()
        for t, slot in zip(threads, slots):
            if t.is_alive():
                # Abandoned straggler: its daemon thread may still
                # write its own slot fields, but nothing below reads
                # doc for a non-ok outcome, so a late finish is inert.
                slot.outcome = "timeout"
                slot.error = f"no response within {self.timeout_s}s"
            elif slot.doc is not None:
                try:
                    merged_series += fleet_registry.merge_wire_snapshot(
                        slot.doc
                    )
                    sources = slot.doc.get("slo_sources")
                    if sources is not None:
                        self._slo.merge_wire_sources(sources)
                    slot.up = True
                    slot.outcome = "ok"
                    self._last_ok[slot.endpoint] = now
                except (ValueError, KeyError, TypeError) as e:
                    # Geometry/version mismatch or malformed document:
                    # this replica's column is lost, the cycle is not.
                    slot.up = False
                    slot.outcome = "error"
                    slot.error = str(e) or type(e).__name__
            last = self._last_ok.get(slot.endpoint, self._created)
            slot.staleness_s = max(0.0, now - last)

        slo_doc = self._slo.render_status()
        view = FleetView(
            ts=now,
            replicas=slots,
            registry=fleet_registry,
            slo=slo_doc,
            merged_series=merged_series,
        )
        self._publish(view)
        self._journal(view)
        return view

    # -- self-metering / journaling ---------------------------------------

    def _publish(self, view: FleetView) -> None:
        """The aggregator's own health on the process-default registry
        (deferred import: telemetry/__init__ imports this module)."""
        from . import counter, gauge

        scrapes = counter(
            "fleet_scrape_total",
            "fleet /telemetry scrape attempts by outcome",
            labels=("endpoint", "outcome"),
        )
        staleness = gauge(
            "fleet_scrape_staleness_seconds",
            "seconds since the last successful scrape of each endpoint",
            labels=("endpoint",),
        )
        for r in view.replicas:
            scrapes.labels(endpoint=r.endpoint, outcome=r.outcome).inc()
            if r.staleness_s is not None:
                staleness.labels(endpoint=r.endpoint).set(r.staleness_s)
        gauge(
            "fleet_replicas_up",
            "replicas that answered the last fleet scrape cycle",
        ).set(view.up)

    def _journal(self, view: FleetView) -> None:
        if self.journal_path is None:
            return
        from ..resilience import durability

        row = {
            "ts": round(view.ts, 3),
            "kind": "fleet_scrape",
            "up": view.up,
            "replicas": [
                {
                    "endpoint": r.endpoint,
                    "outcome": r.outcome,
                    "elapsed_ms": round(r.elapsed_s * 1000, 1),
                    "staleness_s": (
                        round(r.staleness_s, 1)
                        if r.staleness_s is not None else None
                    ),
                    **({"error": r.error} if r.error else {}),
                }
                for r in view.replicas
            ],
            "merged_series": view.merged_series,
            "firing": view.slo.get("firing", []),
            "ok": view.slo.get("ok", True),
        }
        try:
            durability.append_jsonl(self.journal_path, [row], kind="fleet")
        except OSError:
            pass  # a full disk degrades the journal, never the view


def burning(slo_doc: dict) -> list[str]:
    """Objectives currently burning at fleet scope: firing, plus any
    whose BOTH windows exceed the threshold right now. A one-shot
    ``slo check --fleet`` judges a freshly merged view — its
    state machine has had no cycles to debounce pending→firing, so the
    raw two-window condition is the honest one-shot signal."""
    out = set(slo_doc.get("firing", []))
    for o in slo_doc.get("objectives", []):
        thr = o.get("burn_threshold")
        if (
            thr
            and o.get("burn_fast", 0.0) >= thr
            and o.get("burn_slow", 0.0) >= thr
        ):
            out.add(o["name"])
    return sorted(out)


def read_fleet_journal(path) -> list[dict]:
    """Parse a fleet scrape journal, tolerating a torn last line (the
    same contract as the SLO alert journal readback)."""
    import json

    path = Path(path)
    out: list[dict] = []
    if not path.exists():
        return out
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn append
        if isinstance(obj, dict) and obj.get("kind") == "fleet_scrape":
            out.append(obj)
    return out
