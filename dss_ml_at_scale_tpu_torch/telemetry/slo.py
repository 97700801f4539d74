"""Live SLO engine: declared objectives + multi-window burn-rate alerts.

Port copy of ``dss_ml_at_scale_tpu/telemetry/slo.py`` (the JAX package's
module imports nothing of JAX, but the port keeps its own copy), whole:
the six objectives (serving latency and errors, feeder stall, train-step
p95, TTFT, inter-token gap), the two-window burn-rate state machine, the
alert journal (:meth:`SloEngine.attach_journal`, :func:`firing_at_death`)
and the wire merge the fleet aggregator folds replicas with.

Every observability tier so far *describes* the runtime (counters,
histograms, traces, post-hoc attribution); none of it *judges* it. An
SLO is the judging layer: a declared objective ("99% of admitted
requests settle inside the deadline budget", "feeder stall stays under
1%"), measured over sliding windows (:mod:`.windows`), with an SRE-style
multi-window burn-rate alert when the error budget is being spent too
fast to last.

Design points:

- **Objectives are code, not config**: :data:`~.catalog.KNOWN_SLOS`
  declares every objective name (the port's catalog test holds the two
  to each other, as it does KNOWN_METRICS/KNOWN_SPANS), and
  :func:`default_objectives` is the one place their semantics live —
  ``slo check`` needs no baseline file because the objective IS
  the baseline.
- **Multi-window burn rate**: an alert needs BOTH the fast window
  (reacts in seconds, noisy alone) and the slow window (confirms the
  spend is sustained) burning above ``burn_threshold`` — the classic
  two-window page condition. The state machine is
  ``ok → pending → firing → resolved(ok)``: pending debounces
  (``pending_for_s`` of continuous exceedance before firing), resolved
  requires ``clear_for_s`` of calm.
- **Transitions are journaled** through
  :func:`~dss_ml_at_scale_tpu_torch.resilience.durability.append_jsonl`
  (``kind="slo"`` — the same torn-tail-healing appender the run journal
  uses), so the alert history survives SIGKILL and ``runs doctor``
  can surface "these alerts were firing when the run died".
- **Transitions are spans**: each one emits a ``slo.alert`` span
  *under the worst offender's trace id* (the windows remember the
  trace of their worst sample), so a firing alert shows up in
  ``trace tail`` and draws a Perfetto flow arrow to the very
  request/step that blew the budget.

Evaluation is inline and throttled: sources call
:meth:`SloEngine.maybe_evaluate` after feeding (at most one evaluation
per second — tens of microseconds, no background thread to leak), and
every read path (``/slo``, ``slo``, ``top``) evaluates on
demand.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

from . import tracecontext
from .windows import SlidingQuantile, WindowedCounter

SLO_SCHEMA_VERSION = 1

# The latency budget a request is judged against when serving runs
# without a configured deadline (`serve --deadline-ms 0`): the CLI
# default deadline, so the objective still means something in
# embedding/test setups.
DEFAULT_LATENCY_BUDGET_S = 2.0

# Evaluation throttle for the inline maybe_evaluate() path.
_EVAL_EVERY_S = 1.0


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared service-level objective.

    ``kind`` picks the measurement:

    - ``"events"`` — good/bad event counts; burn rate is the windowed
      bad fraction over the allowed budget ``1 - target`` (``target``
      is the minimum good fraction, e.g. 0.99).
    - ``"fraction"`` — a direct windowed fraction (stall seconds per
      wall second); burn rate is ``value / target``.
    - ``"quantile"`` — a windowed quantile of a sketch; burn rate is
      ``value / target`` (``target`` in the value's own unit; ``None``
      leaves the objective informational until armed via
      :meth:`SloEngine.set_target`).
    """

    name: str
    description: str
    kind: str
    target: float | None
    quantile: float | None = None
    unit: str = "fraction"
    fast_window_s: float = 30.0
    slow_window_s: float = 300.0
    burn_threshold: float = 6.0
    pending_for_s: float = 10.0
    clear_for_s: float = 30.0
    min_samples: int = 20

    def __post_init__(self):
        if self.kind not in ("events", "fraction", "quantile"):
            raise ValueError(
                f"objective {self.name!r}: kind must be events|fraction|"
                f"quantile, got {self.kind!r}"
            )
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(
                f"objective {self.name!r}: fast window must be shorter "
                "than the slow window"
            )


def default_objectives() -> tuple[Objective, ...]:
    """The declared objectives — the SLO catalog's one source of
    semantics (names held to KNOWN_SLOS by the catalog test)."""
    return (
        Objective(
            name="serving_latency_p99",
            description="admitted requests settle inside the latency "
            "budget (the configured deadline); value is the live "
            "windowed p99 in seconds",
            kind="events",
            target=0.99,
            quantile=0.99,
            unit="s",
        ),
        Objective(
            name="serving_error_rate",
            description="requests answered without 429/503/5xx; value "
            "is the windowed bad fraction",
            kind="events",
            target=0.99,
        ),
        Objective(
            name="feeder_stall_fraction",
            description="fraction of wall time the training step loop "
            "spends blocked on the feeder queue (over the window)",
            kind="fraction",
            target=0.01,
        ),
        Objective(
            name="train_step_p95",
            description="windowed p95 train-step seconds vs the armed "
            "step budget (informational until a budget is set)",
            kind="quantile",
            target=None,
            quantile=0.95,
            unit="s",
        ),
        Objective(
            name="ttft_p99",
            description="windowed p99 time-to-first-token (admit -> "
            "first streamed chunk) vs the armed TTFT budget; the LM "
            "engine arms it with its request deadline",
            kind="quantile",
            target=None,
            quantile=0.99,
            unit="s",
        ),
        Objective(
            name="inter_token_p99",
            description="windowed p99 gap between consecutive streamed "
            "tokens vs the armed per-token budget (informational until "
            "armed via --inter-token-budget-ms)",
            kind="quantile",
            target=None,
            quantile=0.99,
            unit="s",
        ),
    )


def classify_request(
    status: int, dur_s: float, budget_s: float
) -> tuple[bool | None, bool | None, str | None]:
    """THE per-request SLO classification: ``(error_ok, latency_ok,
    verdict)``.

    One definition shared by :meth:`SloEngine.note_request` (what the
    windowed objectives aggregate) and the serving access log's
    per-row ``slo`` field (the journaled ground truth) — two copies of
    "which statuses count, against what budget" would drift exactly
    like two quantile definitions did.

    - ``error_ok``: None for client-attributable outcomes (4xx other
      than 429), else whether the service answered without
      429/503/5xx.
    - ``latency_ok``: only requests carried to a scoring verdict are
      judged — a 200 against the budget, a 503 is a miss by
      construction, everything else None.
    - ``verdict``: ``"ok"``/``"breach"``/None — breach if either
      judged dimension failed.
    """
    if status == 200:
        error_ok: bool | None = True
        latency_ok: bool | None = dur_s <= budget_s
    elif status in (429, 503) or status >= 500:
        error_ok = False
        latency_ok = False if status == 503 else None
    else:
        error_ok = None
        latency_ok = None
    if error_ok is False or latency_ok is False:
        verdict: str | None = "breach"
    elif status == 200:
        verdict = "ok"
    else:
        verdict = None
    return error_ok, latency_ok, verdict


class _AlertState:
    """Mutable per-objective alert state (owned under the engine lock)."""

    __slots__ = ("state", "since", "exceeded_since", "calm_since")

    def __init__(self):
        self.state = "ok"
        self.since: float | None = None
        self.exceeded_since: float | None = None
        self.calm_since: float | None = None


class _EventSource:
    """Good/bad counters per window plus a value sketch (fast window)."""

    __slots__ = ("good_f", "bad_f", "good_s", "bad_s", "sketch",
                 "_clock", "_window_s", "_offender", "_offender_ts")

    def __init__(self, obj: Objective, clock):
        self.good_f = WindowedCounter(obj.fast_window_s, clock=clock)
        self.bad_f = WindowedCounter(obj.fast_window_s, clock=clock)
        self.good_s = WindowedCounter(obj.slow_window_s, clock=clock)
        self.bad_s = WindowedCounter(obj.slow_window_s, clock=clock)
        self.sketch = SlidingQuantile(
            window_s=obj.fast_window_s, clock=clock
        )
        self._clock = clock
        self._window_s = obj.fast_window_s
        # The most recent bad event's trace — what an alert's flow
        # arrow points at. Plain assignments (single writer per event,
        # forensic value only — a torn read costs one arrow).
        self._offender: str | None = None
        self._offender_ts = -math.inf

    def note(self, ok: bool, value: float | None = None,
             trace: str | None = None) -> None:
        (self.good_f if ok else self.bad_f).add()
        (self.good_s if ok else self.bad_s).add()
        if not ok and trace is not None:
            self._offender = trace
            self._offender_ts = self._clock()
        if value is not None:
            self.sketch.observe(value, trace=None if ok else trace)

    def offender(self) -> str | None:
        """Trace id of the most recent bad event still inside the fast
        window, else the sketch's worst sample."""
        if (self._offender is not None
                and self._clock() - self._offender_ts <= self._window_s):
            return self._offender
        return self.sketch.worst_trace()

    def bad_fraction(self, fast: bool) -> tuple[float | None, int]:
        good = (self.good_f if fast else self.good_s).total()
        bad = (self.bad_f if fast else self.bad_s).total()
        n = int(good + bad)
        return ((bad / n) if n else None), n

    def to_wire(self) -> dict:
        return {
            "kind": "events",
            "good_f": self.good_f.to_wire(),
            "bad_f": self.bad_f.to_wire(),
            "good_s": self.good_s.to_wire(),
            "bad_s": self.bad_s.to_wire(),
            "sketch": self.sketch.to_wire(),
        }

    def merge_wire(self, wire: dict) -> None:
        if not isinstance(wire, dict) or wire.get("kind") != "events":
            raise ValueError(
                f"SLO source wire kind mismatch: expected 'events', "
                f"got {wire.get('kind') if isinstance(wire, dict) else wire!r}"
            )
        self.good_f.merge_wire(wire["good_f"])
        self.bad_f.merge_wire(wire["bad_f"])
        self.good_s.merge_wire(wire["good_s"])
        self.bad_s.merge_wire(wire["bad_s"])
        self.sketch.merge_wire(wire["sketch"])


class _FractionSource:
    """A windowed seconds-per-second fraction (stall time)."""

    __slots__ = ("f", "s")

    def __init__(self, obj: Objective, clock):
        self.f = WindowedCounter(obj.fast_window_s, clock=clock)
        self.s = WindowedCounter(obj.slow_window_s, clock=clock)

    def note(self, seconds: float) -> None:
        self.f.add(seconds)
        self.s.add(seconds)

    def value(self, fast: bool) -> float:
        # Accumulated seconds over the FULL window span, not the
        # covered age: on a young series an age denominator inflates
        # the fraction (one 5s warmup stall 10s after boot would read
        # as 50% on BOTH windows, collapsing the two-window
        # confirmation into a false firing alert). Dividing by the
        # full span under-reports while the series is younger than the
        # window — the conservative direction — and is exact once the
        # window has filled.
        w = self.f if fast else self.s
        return w.total() / w.window_s

    def to_wire(self) -> dict:
        return {
            "kind": "fraction",
            "f": self.f.to_wire(),
            "s": self.s.to_wire(),
        }

    def merge_wire(self, wire: dict) -> None:
        if not isinstance(wire, dict) or wire.get("kind") != "fraction":
            raise ValueError(
                f"SLO source wire kind mismatch: expected 'fraction', "
                f"got {wire.get('kind') if isinstance(wire, dict) else wire!r}"
            )
        self.f.merge_wire(wire["f"])
        self.s.merge_wire(wire["s"])


class _QuantileSource:
    """Fast+slow sketches of one measured duration."""

    __slots__ = ("f", "s")

    def __init__(self, obj: Objective, clock):
        self.f = SlidingQuantile(window_s=obj.fast_window_s, clock=clock)
        self.s = SlidingQuantile(window_s=obj.slow_window_s, clock=clock)

    def note(self, seconds: float, trace: str | None = None) -> None:
        self.f.observe(seconds, trace=trace)
        self.s.observe(seconds, trace=trace)

    def to_wire(self) -> dict:
        return {
            "kind": "quantile",
            "f": self.f.to_wire(),
            "s": self.s.to_wire(),
        }

    def merge_wire(self, wire: dict) -> None:
        if not isinstance(wire, dict) or wire.get("kind") != "quantile":
            raise ValueError(
                f"SLO source wire kind mismatch: expected 'quantile', "
                f"got {wire.get('kind') if isinstance(wire, dict) else wire!r}"
            )
        self.f.merge_wire(wire["f"])
        self.s.merge_wire(wire["s"])


class SloEngine:
    """The process SLO evaluator: sources in, alert transitions out.

    Construction is cheap and allocation-only; tests build private
    engines with a fake ``clock`` and tiny windows to drive the state
    machine deterministically. The process-default engine
    (:func:`get_engine`) is what serving/feeder/trainer feed.
    """

    # Lock contract: alert state,
    # journal target, and runtime targets are shared by every feeding
    # thread family plus the /slo readers; the windows/sketches carry
    # their own locks (engine lock -> window lock, never the reverse).
    # _last_eval is deliberately NOT listed: the throttle reads it
    # lock-free on every note_* hot path (a stale read only costs one
    # benign duplicate evaluation).
    _guarded_by_lock = ("_alerts", "_journal_path",
                        "_latency_budget_s", "_targets")

    def __init__(self, objectives: Iterable[Objective] | None = None,
                 clock: Callable[[], float] | None = None):
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        objs = tuple(objectives) if objectives is not None \
            else default_objectives()
        self._objectives: dict[str, Objective] = {o.name: o for o in objs}
        self._sources: dict[str, object] = {}
        for o in objs:
            if o.kind == "events":
                self._sources[o.name] = _EventSource(o, self._clock)
            elif o.kind == "fraction":
                self._sources[o.name] = _FractionSource(o, self._clock)
            else:
                self._sources[o.name] = _QuantileSource(o, self._clock)
        self._alerts: dict[str, _AlertState] = {
            o.name: _AlertState() for o in objs
        }
        self._targets: dict[str, float | None] = {}
        self._latency_budget_s = DEFAULT_LATENCY_BUDGET_S
        self._journal_path: Path | None = None
        self._last_eval = 0.0

    # -- configuration -----------------------------------------------------

    def set_latency_budget(self, seconds: float) -> None:
        """Arm the serving latency objective with the real deadline
        budget (the scheduler calls this from its configured
        ``deadline_ms``)."""
        with self._lock:
            self._latency_budget_s = float(seconds)

    def set_target(self, name: str, target: float | None) -> None:
        """Override an objective's declared target at runtime (e.g. arm
        ``train_step_p95`` with a measured step budget)."""
        if name not in self._objectives:
            raise KeyError(f"unknown SLO {name!r}")
        with self._lock:
            self._targets[name] = target

    def attach_journal(self, path) -> Path:
        """Journal alert transitions to ``path`` (``alerts.jsonl`` in a
        run directory). One journal at a time; the newest attach wins.

        Alerts already burning at attach time are snapshotted into the
        new journal (state carried, ``prev`` == state): a run that
        starts under an alert and dies without further transitions
        must still show it in ``firing_at_death`` — surfacing exactly
        that is the journal's purpose. The file exists from the attach on
        (empty until a transition), so every run directory shows its
        journal; the JAX engine creates it at the first append.
        """
        path = Path(path).absolute()
        now = self._clock()
        with self._lock:
            self._journal_path = path
            carried = [
                {"ts": round(time.time(), 3), "slo": name,
                 "state": st.state, "prev": st.state,
                 "carried": True,
                 "since_s": (
                     round(now - st.since, 1)
                     if st.since is not None else None
                 )}
                for name, st in self._alerts.items()
                if st.state != "ok"
            ]
        from ..resilience import durability

        try:
            if carried:
                durability.append_jsonl(path, carried, kind="slo")
            else:
                path.touch()
        except OSError:
            pass  # a full disk degrades the journal, never the run
        return path

    @property
    def journal_path(self) -> Path | None:
        with self._lock:
            return self._journal_path

    def detach_journal(self, path=None) -> None:
        """Stop journaling. With ``path`` given, detach only if the
        engine still targets that file (a finished run must not switch
        off a newer run's journal — the flight-recorder discipline)."""
        with self._lock:
            if path is not None and \
                    self._journal_path != Path(path).absolute():
                return
            self._journal_path = None

    def reset(self) -> None:
        """Clear windows and alert states (test isolation; the journal
        attachment survives — it is scoped by attach/detach)."""
        with self._lock:
            objs = self._objectives
            for o in objs.values():
                if o.kind == "events":
                    self._sources[o.name] = _EventSource(o, self._clock)
                elif o.kind == "fraction":
                    self._sources[o.name] = _FractionSource(o, self._clock)
                else:
                    self._sources[o.name] = _QuantileSource(o, self._clock)
            self._alerts = {n: _AlertState() for n in objs}
            self._targets = {}
            self._latency_budget_s = DEFAULT_LATENCY_BUDGET_S
            self._last_eval = 0.0

    def reset_sources(self) -> None:
        """Clear the measurement windows only, KEEPING alert states,
        targets, budget, and journal — what a fleet aggregator does
        between scrape cycles: each cycle re-merges fresh per-replica
        windows, but the fleet alert state machine must persist across
        cycles or nothing ever debounces from pending to firing."""
        with self._lock:
            objs = self._objectives
            for o in objs.values():
                if o.kind == "events":
                    self._sources[o.name] = _EventSource(o, self._clock)
                elif o.kind == "fraction":
                    self._sources[o.name] = _FractionSource(o, self._clock)
                else:
                    self._sources[o.name] = _QuantileSource(o, self._clock)

    # -- federation wire form ----------------------------------------------

    def wire_sources(self) -> dict:
        """The engine's measurement state as a mergeable wire document
        (the ``slo_sources`` half of ``GET /telemetry``): every
        objective's raw windows/sketches plus the latency budget a
        receiver needs to judge seconds-unit objectives."""
        return {
            "version": SLO_SCHEMA_VERSION,
            "latency_budget_s": self.latency_budget,
            "sources": {
                name: src.to_wire()
                for name, src in self._sources.items()
            },
        }

    def merge_wire_sources(self, doc: dict) -> int:
        """Fold a peer engine's :meth:`wire_sources` into this one's
        windows. Unknown objective names are skipped (a newer replica
        may declare objectives this aggregator doesn't know); geometry
        or kind mismatches on known names raise loudly. Returns the
        number of sources merged."""
        if not isinstance(doc, dict):
            raise ValueError(f"slo_sources must be a dict, got {type(doc)}")
        if doc.get("version") != SLO_SCHEMA_VERSION:
            raise ValueError(
                f"slo_sources version mismatch: expected "
                f"{SLO_SCHEMA_VERSION}, got {doc.get('version')!r}"
            )
        merged = 0
        for name, wire in (doc.get("sources") or {}).items():
            src = self._sources.get(name)
            if src is None:
                continue
            src.merge_wire(wire)
            merged += 1
        # Adopt the strictest (smallest) armed latency budget seen
        # across the fleet, so a fleet judgment is never laxer than
        # the tightest replica's own.
        budget = doc.get("latency_budget_s")
        if isinstance(budget, (int, float)) and budget > 0:
            with self._lock:
                if budget < self._latency_budget_s:
                    self._latency_budget_s = float(budget)
        return merged

    # -- sources -----------------------------------------------------------

    @property
    def latency_budget(self) -> float:
        with self._lock:
            return self._latency_budget_s

    def note_request(
        self, dur_s: float, status: int, trace_id: str | None = None
    ) -> tuple[bool | None, bool | None, str | None]:
        """One served HTTP request: feeds the latency and error
        objectives through the one shared classification
        (:func:`classify_request`) and returns it — callers that also
        need the verdict (the access-log row) reuse this result
        instead of classifying (and taking the budget lock) twice."""
        classified = classify_request(status, dur_s, self.latency_budget)
        error_ok, latency_ok, _ = classified
        err = self._sources.get("serving_error_rate")
        lat = self._sources.get("serving_latency_p99")
        if err is not None and error_ok is not None:
            err.note(error_ok, trace=trace_id)
        if lat is not None and latency_ok is not None:
            lat.note(latency_ok, value=dur_s, trace=trace_id)
        self.maybe_evaluate()
        return classified

    def note_feeder_wait(self, wait_s: float) -> None:
        src = self._sources.get("feeder_stall_fraction")
        if src is not None:
            src.note(wait_s)
        self.maybe_evaluate()

    def note_train_step(self, dur_s: float,
                        trace_id: str | None = None) -> None:
        src = self._sources.get("train_step_p95")
        if src is not None:
            src.note(dur_s, trace=trace_id)
        self.maybe_evaluate()

    def note_ttft(self, dur_s: float,
                  trace_id: str | None = None) -> None:
        """Admit -> first streamed chunk, fed per LM admission."""
        src = self._sources.get("ttft_p99")
        if src is not None:
            src.note(dur_s, trace=trace_id)
        self.maybe_evaluate()

    def note_inter_token(self, dur_s: float,
                         trace_id: str | None = None) -> None:
        """Gap between consecutive streamed chunks of one generation."""
        src = self._sources.get("inter_token_p99")
        if src is not None:
            src.note(dur_s, trace=trace_id)
        self.maybe_evaluate()

    # -- evaluation --------------------------------------------------------

    def _measure(self, obj: Objective, targets: dict,
                 latency_budget_s: float) -> dict:
        """Value + per-window burn rates for one objective.

        ``targets``/``latency_budget_s`` are snapshots the caller read
        under the engine lock; window reads below take only the
        window's own lock (engine lock → window lock, never reversed).
        """
        src = self._sources[obj.name]
        target = targets.get(obj.name, obj.target)
        out: dict = {"value": None, "burn_fast": 0.0, "burn_slow": 0.0,
                     "samples": 0, "budget": None, "trace": None}
        if obj.kind == "events":
            # target=None disarms the objective (informational), same
            # as the fraction/quantile kinds — it must never collapse
            # the allowed budget to ~0 and fire on a single bad event.
            allowed = (
                max(1.0 - target, 1e-9) if target is not None else None
            )
            frac_f, n_f = src.bad_fraction(fast=True)
            frac_s, n_s = src.bad_fraction(fast=False)
            out["samples"] = n_f
            if obj.quantile is not None:
                # Duration-flavored events objective (declared by its
                # quantile field, not by name): the headline value is
                # the windowed quantile of the observed durations, and
                # a seconds-unit objective is judged against the
                # engine's latency budget.
                out["value"] = src.sketch.quantile(obj.quantile)
                out["budget"] = (
                    latency_budget_s if obj.unit == "s" else allowed
                )
            else:
                out["value"] = frac_f
                out["budget"] = allowed
            if allowed is not None:
                if n_f >= obj.min_samples and frac_f is not None:
                    out["burn_fast"] = frac_f / allowed
                if n_s >= obj.min_samples and frac_s is not None:
                    out["burn_slow"] = frac_s / allowed
            out["trace"] = src.offender()
        elif obj.kind == "fraction":
            v_f, v_s = src.value(fast=True), src.value(fast=False)
            out["value"] = v_f
            out["budget"] = target
            if target:
                out["burn_fast"] = v_f / target
                out["burn_slow"] = v_s / target
        else:  # quantile
            q = obj.quantile or 0.95
            v_f = src.f.quantile(q)
            v_s = src.s.quantile(q)
            out["value"] = v_f
            out["budget"] = target
            out["samples"] = src.f.count()
            out["trace"] = src.f.worst_trace()
            if target and out["samples"] >= obj.min_samples:
                if v_f is not None:
                    out["burn_fast"] = v_f / target
                if v_s is not None:
                    out["burn_slow"] = v_s / target
        return out

    def maybe_evaluate(self) -> None:
        """The inline hot-path hook: evaluates at most once per
        second, so feeding stays at window-observe cost. The throttle
        read is lock-free on purpose — a torn/stale read costs at
        worst one extra evaluation, not correctness — so the hot path
        does not serialize every handler/feeder/trainer thread on the
        engine lock."""
        if self._clock() - self._last_eval < _EVAL_EVERY_S:
            return
        self.evaluate()

    def evaluate(self) -> list[dict]:
        """Run every objective's state machine; returns (and journals,
        counts, and span-emits) the transitions that happened."""
        transitions, _ = self._evaluate()
        return transitions

    def _evaluate(self) -> tuple[list[dict], dict[str, dict]]:
        """One measurement pass feeding both the state machine and the
        status document — ``render_status`` must not fold every window
        twice per /slo scrape. Returns ``(transitions, report)`` where
        ``report[name]`` carries the measurement plus the post-machine
        alert state snapshot."""
        now = self._clock()
        transitions: list[dict] = []
        report: dict[str, dict] = {}
        with self._lock:
            self._last_eval = now
            jpath = self._journal_path
            targets = dict(self._targets)
            budget_s = self._latency_budget_s
            firing = 0
            for name, obj in self._objectives.items():
                m = self._measure(obj, targets, budget_s)
                st = self._alerts[name]
                exceeded = (
                    m["burn_fast"] >= obj.burn_threshold
                    and m["burn_slow"] >= obj.burn_threshold
                )

                def _move(new_state: str, label: str) -> None:
                    transitions.append({
                        "ts": round(time.time(), 3),
                        "slo": name,
                        "state": label,
                        "prev": st.state,
                        "value": m["value"],
                        "burn_fast": round(m["burn_fast"], 4),
                        "burn_slow": round(m["burn_slow"], 4),
                        "trace": m["trace"],
                    })
                    st.state = new_state
                    st.since = now

                if st.state == "ok":
                    if exceeded:
                        st.exceeded_since = now
                        st.calm_since = None
                        _move("pending", "pending")
                elif st.state == "pending":
                    since = (
                        st.exceeded_since
                        if st.exceeded_since is not None else now
                    )
                    if not exceeded:
                        _move("ok", "resolved")
                    elif now - since >= obj.pending_for_s:
                        _move("firing", "firing")
                elif st.state == "firing":
                    if m["burn_fast"] < obj.burn_threshold:
                        if st.calm_since is None:
                            st.calm_since = now
                        elif now - st.calm_since >= obj.clear_for_s:
                            _move("ok", "resolved")
                    else:
                        st.calm_since = None
                if st.state == "firing":
                    firing += 1
                report[name] = {
                    "obj": obj,
                    "m": m,
                    "state": st.state,
                    "since": st.since,
                }
        for t in transitions:
            self._emit_transition(t, jpath)
        self._publish_gauges(firing, transitions)
        return transitions, report

    def _emit_transition(self, t: dict, jpath: Path | None) -> None:
        """Journal + trace one transition (outside the engine lock —
        fsync and span emission must never stall the feeders)."""
        if jpath is not None:
            from ..resilience import durability

            try:
                durability.append_jsonl(jpath, [t], kind="slo")
            except OSError:
                pass  # a full disk degrades the journal, never serving
        # The transition as a span, under the worst offender's trace id
        # when the window remembered one: `trace tail` shows the
        # alert next to the request/step that blew the budget, and the
        # Perfetto export draws the flow arrow between them.
        from . import span

        ctx = (
            tracecontext.TraceContext(
                t["trace"], tracecontext.new_span_id(), "alert"
            )
            if t.get("trace") else None
        )
        with tracecontext.Handoff(ctx).activate():
            with span("slo.alert", slo=t["slo"], state=t["state"],
                      prev=t["prev"], burn_fast=t["burn_fast"],
                      burn_slow=t["burn_slow"]):
                pass

    def _publish_gauges(self, firing: int, transitions: list[dict]) -> None:
        from . import counter, gauge

        gauge(
            "slo_alerts_firing",
            "objectives currently in the firing alert state",
        ).set(firing)
        fam = counter(
            "slo_alert_transitions_total",
            "burn-rate alert state transitions",
            labels=("slo", "state"),
        )
        for t in transitions:
            fam.labels(slo=t["slo"], state=t["state"]).inc()

    # -- status ------------------------------------------------------------

    def render_status(self) -> dict:
        """The ``/slo`` document (schema v1): every objective's live
        value, burn rates, alert state, and budget remaining — built
        from the same single measurement pass that ran the state
        machine."""
        _, report = self._evaluate()
        now = self._clock()
        objectives = []
        for name, entry in report.items():
            obj, m = entry["obj"], entry["m"]
            burn = m["burn_slow"]
            budget_remaining = None
            if m["budget"]:
                if obj.kind == "events":
                    budget_remaining = round(1.0 - burn, 4)
                elif m["value"] is not None:
                    budget_remaining = round(
                        1.0 - m["value"] / m["budget"], 4
                    )
            objectives.append({
                "name": name,
                "description": obj.description,
                "kind": obj.kind,
                "unit": obj.unit,
                "value": m["value"],
                "budget": m["budget"],
                "budget_remaining": budget_remaining,
                "burn_fast": round(m["burn_fast"], 4),
                "burn_slow": round(m["burn_slow"], 4),
                "burn_threshold": obj.burn_threshold,
                "fast_window_s": obj.fast_window_s,
                "slow_window_s": obj.slow_window_s,
                "samples": m["samples"],
                "state": entry["state"],
                "since_s": (
                    round(now - entry["since"], 1)
                    if entry["since"] is not None else None
                ),
            })
        firing = sorted(
            name for name, entry in report.items()
            if entry["state"] == "firing"
        )
        return {
            "version": SLO_SCHEMA_VERSION,
            "ts": round(time.time(), 3),
            "objectives": objectives,
            "firing": firing,
            "ok": not firing,
        }


_engine = SloEngine()


def get_engine() -> SloEngine:
    """The process-default engine every wiring point feeds."""
    return _engine


def reset() -> None:
    _engine.reset()


# -- journal readback ---------------------------------------------------------


def read_alert_journal(path) -> list[dict]:
    """Parse an ``alerts.jsonl``, tolerating a torn last line (a kill
    mid-append is the condition the journal exists for)."""
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
        if isinstance(obj, dict) and "slo" in obj:
            out.append(obj)
    return out


def firing_at_death(path) -> list[str]:
    """Objectives whose LAST journaled transition left them firing —
    what ``runs doctor`` surfaces for an interrupted run."""
    last: dict[str, str] = {}
    for t in read_alert_journal(path):
        last[t["slo"]] = t.get("state", "")
    return sorted(n for n, s in last.items() if s == "firing")
