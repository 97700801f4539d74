"""Live SLO engine: the LM serving objectives and their burn-rate alerts.

Port copy of ``dss_ml_at_scale_tpu/telemetry/slo.py``, cut to what the
serving paths feed and read: the image tier's events objectives
``serving_latency_p99`` and ``serving_error_rate`` (fed per ``/predict``
through :func:`classify_request`, the latency judged against the budget
the scheduler arms from its deadline), the LM tier's quantile objectives
``ttft_p99`` and ``inter_token_p99`` (armed by the engine from its
deadline and per-token budget), the two-window burn-rate alert state
machine (``ok -> pending -> firing -> resolved``), the ``/slo`` status
document and the raw ``slo_sources`` half of ``GET /telemetry``. The
feeder and train-step objectives, the alert journal and the fleet merge
are not ported yet.

Evaluation is inline and throttled: sources call
:meth:`SloEngine.maybe_evaluate` after feeding (at most once per second),
and ``/slo`` evaluates on demand. Each alert transition is a ``slo.alert``
span under the trace id of the window's worst sample.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Iterable

from . import tracecontext
from .windows import SlidingQuantile, WindowedCounter

SLO_SCHEMA_VERSION = 1

# The serving latency budget before a scheduler arms its deadline.
DEFAULT_LATENCY_BUDGET_S = 2.0

# Evaluation throttle for the inline maybe_evaluate() path.
_EVAL_EVERY_S = 1.0


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared objective. ``kind`` "quantile": a windowed quantile of
    a measured duration against ``target`` seconds (``None`` leaves it
    informational until :meth:`SloEngine.set_target` arms it); burn rate
    is ``value / target``. ``kind`` "events": good/bad events against a
    ``target`` good fraction; burn rate is the bad fraction over the
    allowed ``1 - target``."""

    name: str
    description: str
    target: float | None
    quantile: float | None = None
    unit: str = "s"
    kind: str = "quantile"
    fast_window_s: float = 30.0
    slow_window_s: float = 300.0
    burn_threshold: float = 6.0
    pending_for_s: float = 10.0
    clear_for_s: float = 30.0
    min_samples: int = 20

    def __post_init__(self):
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(
                f"objective {self.name!r}: fast window must be shorter "
                "than the slow window"
            )


def default_objectives() -> tuple[Objective, ...]:
    """The serving objectives (same names and semantics as the JAX
    package's catalog)."""
    return (
        Objective(
            name="serving_latency_p99",
            description="admitted requests settle inside the latency "
            "budget (the configured deadline); value is the live "
            "windowed p99 in seconds",
            kind="events",
            target=0.99,
            quantile=0.99,
        ),
        Objective(
            name="serving_error_rate",
            description="requests answered without 429/503/5xx; value "
            "is the windowed bad fraction",
            kind="events",
            target=0.99,
        ),
        Objective(
            name="ttft_p99",
            description="windowed p99 time-to-first-token (admit -> "
            "first streamed chunk) vs the armed TTFT budget; the LM "
            "engine arms it with its request deadline",
            target=None,
            quantile=0.99,
        ),
        Objective(
            name="inter_token_p99",
            description="windowed p99 gap between consecutive streamed "
            "tokens vs the armed per-token budget (informational until "
            "armed via --inter-token-budget-ms)",
            target=None,
            quantile=0.99,
        ),
    )


def classify_request(status: int, dur_s: float,
                     budget_s: float) -> tuple[bool | None, bool | None, str | None]:
    """The per-request SLO classification ``(error_ok, latency_ok,
    verdict)``, shared by :meth:`SloEngine.note_request` and the access
    log's ``slo`` field:

    - ``error_ok``: None for client-attributable outcomes (4xx other than
      429), else whether the service answered without 429/503/5xx;
    - ``latency_ok``: a 200 against the budget, a 503 is a miss, anything
      else None (never carried to a scoring verdict);
    - ``verdict``: "breach" if either judged dimension failed, "ok" for a
      200, else None.
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
        return {"kind": "quantile", "f": self.f.to_wire(), "s": self.s.to_wire()}


class _EventSource:
    """Good/bad counters per window plus a value sketch (fast window)."""

    __slots__ = ("good_f", "bad_f", "good_s", "bad_s", "sketch", "_clock", "_window_s",
                 "_offender", "_offender_ts")

    def __init__(self, obj: Objective, clock):
        self.good_f = WindowedCounter(obj.fast_window_s, clock=clock)
        self.bad_f = WindowedCounter(obj.fast_window_s, clock=clock)
        self.good_s = WindowedCounter(obj.slow_window_s, clock=clock)
        self.bad_s = WindowedCounter(obj.slow_window_s, clock=clock)
        self.sketch = SlidingQuantile(window_s=obj.fast_window_s, clock=clock)
        self._clock = clock
        self._window_s = obj.fast_window_s
        # The latest bad event's trace: what an alert points at.
        self._offender: str | None = None
        self._offender_ts = -math.inf

    def note(self, ok: bool, value: float | None = None, trace: str | None = None) -> None:
        (self.good_f if ok else self.bad_f).add()
        (self.good_s if ok else self.bad_s).add()
        if not ok and trace is not None:
            self._offender = trace
            self._offender_ts = self._clock()
        if value is not None:
            self.sketch.observe(value, trace=None if ok else trace)

    def offender(self) -> str | None:
        """The latest bad event's trace inside the fast window, else the
        sketch's worst sample."""
        if self._offender is not None and self._clock() - self._offender_ts <= self._window_s:
            return self._offender
        return self.sketch.worst_trace()

    def bad_fraction(self, fast: bool) -> tuple[float | None, int]:
        good = (self.good_f if fast else self.good_s).total()
        bad = (self.bad_f if fast else self.bad_s).total()
        n = int(good + bad)
        return ((bad / n) if n else None), n

    def to_wire(self) -> dict:
        return {"kind": "events", "good_f": self.good_f.to_wire(),
                "bad_f": self.bad_f.to_wire(), "good_s": self.good_s.to_wire(),
                "bad_s": self.bad_s.to_wire(), "sketch": self.sketch.to_wire()}


class SloEngine:
    """The process SLO evaluator: sources in, alert transitions out."""

    # Alert state and runtime targets are shared by the engine thread
    # and the /slo readers; _last_eval is read lock-free by the throttle
    # on purpose (a stale read costs one duplicate evaluation).
    _guarded_by_lock = ("_alerts", "_latency_budget_s", "_targets")

    def __init__(self, objectives: Iterable[Objective] | None = None,
                 clock: Callable[[], float] | None = None):
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        objs = tuple(objectives) if objectives is not None \
            else default_objectives()
        self._objectives: dict[str, Objective] = {o.name: o for o in objs}
        self._sources = {o.name: (_EventSource if o.kind == "events" else _QuantileSource)(
            o, self._clock) for o in objs}
        self._alerts = {o.name: _AlertState() for o in objs}
        self._targets: dict[str, float | None] = {}
        self._latency_budget_s = DEFAULT_LATENCY_BUDGET_S
        self._last_eval = 0.0

    def set_latency_budget(self, seconds: float) -> None:
        """Arm the serving latency objective with the deadline budget (the
        image scheduler calls this from its ``deadline_ms``)."""
        with self._lock:
            self._latency_budget_s = float(seconds)

    @property
    def latency_budget(self) -> float:
        with self._lock:
            return self._latency_budget_s

    def set_target(self, name: str, target: float | None) -> None:
        """Arm (or disarm, with None) an objective's budget at runtime."""
        if name not in self._objectives:
            raise KeyError(f"unknown SLO {name!r}")
        with self._lock:
            self._targets[name] = target

    def wire_sources(self) -> dict:
        """The raw measurement windows (the ``slo_sources`` half of
        ``GET /telemetry``)."""
        return {
            "version": SLO_SCHEMA_VERSION,
            "sources": {
                name: src.to_wire() for name, src in self._sources.items()
            },
        }

    # -- sources -----------------------------------------------------------

    def note_request(self, dur_s: float, status: int,
                     trace_id: str | None = None) -> tuple[bool | None, bool | None, str | None]:
        """One served ``/predict``: feeds the latency and error objectives
        through :func:`classify_request` and returns the classification
        (the access-log row reuses it)."""
        classified = classify_request(status, dur_s, self.latency_budget)
        error_ok, latency_ok, _ = classified
        if error_ok is not None:
            self._sources["serving_error_rate"].note(error_ok, trace=trace_id)
        if latency_ok is not None:
            self._sources["serving_latency_p99"].note(latency_ok, value=dur_s, trace=trace_id)
        self.maybe_evaluate()
        return classified

    def note_ttft(self, dur_s: float, trace_id: str | None = None) -> None:
        """Admit -> first streamed chunk, fed per LM admission."""
        self._sources["ttft_p99"].note(dur_s, trace=trace_id)
        self.maybe_evaluate()

    def note_inter_token(self, dur_s: float,
                         trace_id: str | None = None) -> None:
        """Gap between consecutive streamed chunks of one generation."""
        self._sources["inter_token_p99"].note(dur_s, trace=trace_id)
        self.maybe_evaluate()

    # -- evaluation --------------------------------------------------------

    def _measure(self, obj: Objective, targets: dict, latency_budget_s: float) -> dict:
        src = self._sources[obj.name]
        target = targets.get(obj.name, obj.target)
        if obj.kind == "events":
            # target None disarms the objective (informational).
            allowed = max(1.0 - target, 1e-9) if target is not None else None
            frac_f, n_f = src.bad_fraction(fast=True)
            frac_s, n_s = src.bad_fraction(fast=False)
            out = {"value": frac_f, "burn_fast": 0.0, "burn_slow": 0.0, "samples": n_f,
                   "budget": allowed, "trace": src.offender()}
            if obj.quantile is not None:
                # A duration-flavoured events objective: its value is the
                # windowed quantile, judged against the latency budget.
                out["value"] = src.sketch.quantile(obj.quantile)
                out["budget"] = latency_budget_s if obj.unit == "s" else allowed
            if allowed is not None:
                if n_f >= obj.min_samples and frac_f is not None:
                    out["burn_fast"] = frac_f / allowed
                if n_s >= obj.min_samples and frac_s is not None:
                    out["burn_slow"] = frac_s / allowed
            return out
        v_f = src.f.quantile(obj.quantile)
        v_s = src.s.quantile(obj.quantile)
        out = {"value": v_f, "burn_fast": 0.0, "burn_slow": 0.0,
               "samples": src.f.count(), "budget": target,
               "trace": src.f.worst_trace()}
        if target and out["samples"] >= obj.min_samples:
            if v_f is not None:
                out["burn_fast"] = v_f / target
            if v_s is not None:
                out["burn_slow"] = v_s / target
        return out

    def maybe_evaluate(self) -> None:
        """At most one evaluation per second from the feeding hot path."""
        if self._clock() - self._last_eval < _EVAL_EVERY_S:
            return
        self.evaluate()

    def evaluate(self) -> list[dict]:
        """Run every objective's state machine; returns (and span-emits
        and counts) the transitions that happened."""
        transitions, _ = self._evaluate()
        return transitions

    def _evaluate(self) -> tuple[list[dict], dict[str, dict]]:
        now = self._clock()
        transitions: list[dict] = []
        report: dict[str, dict] = {}
        with self._lock:
            self._last_eval = now
            targets = dict(self._targets)
            budget = self._latency_budget_s
            firing = 0
            for name, obj in self._objectives.items():
                m = self._measure(obj, targets, budget)
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
                    "obj": obj, "m": m, "state": st.state, "since": st.since,
                }
        for t in transitions:
            self._emit_transition(t)
        self._publish_gauges(firing, transitions)
        return transitions, report

    def _emit_transition(self, t: dict) -> None:
        """One transition as a span, under the worst offender's trace id."""
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
        """The ``/slo`` document (schema v1)."""
        _, report = self._evaluate()
        now = self._clock()
        objectives = []
        for name, entry in report.items():
            obj, m = entry["obj"], entry["m"]
            budget_remaining = None
            if m["budget"] and m["value"] is not None:
                budget_remaining = round(1.0 - m["value"] / m["budget"], 4)
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
    """The process-default engine the serving tiers feed."""
    return _engine
