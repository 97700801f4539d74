"""Lightweight experiment tracking (the MLflow-wiring replacement).

Port of ``dss_ml_at_scale_tpu/tracking/store.py``, on the same on-disk
layout, so each package's :func:`classify_run`, :func:`list_runs` and
``runs doctor`` read the other's run directories. Every run enables the
flight recorder (``flightrec.jsonl``) and the SLO alert journal
(``alerts.jsonl``) in its directory and registers both in its journal
(the ``trace`` and ``slo_journal`` events), as the JAX package's does.

The reference threads MLflow through every track: experiment pinning, a
host/token env relay so Spark workers can log, ``MLFlowLogger`` for
Lightning, and autologged HPO trials (reference
``deep_learning/2.distributed-data-loading-petastorm.py:56-75,357-365``,
``hyperopt/1. hyperopt.py:130-136``, ``group_apply/_resources/00-setup.py:71``).

Here tracking is a plain directory store — no server, no token relay:

    <root>/<experiment>/<run_id>/
        meta.json       run name/status/times
        params.json     flat key->value
        metrics.jsonl   {"name","value","step","ts"} per line
        artifacts/      files

Multi-process discipline: the trainer reduces metrics over the ranks
before logging them, so **only process 0 writes**
(``runtime.process_index()``); the other processes get a no-op store. An optional
``to_mlflow`` export bridges to a real MLflow server when the client
library is installed.

**Crash-only discipline** (the gap the original design left open:
``finish()`` never runs on a hard kill, so killed runs sat RUNNING
forever): every ``*.json`` publish is durable-atomic
(``resilience.durability``), and each run keeps an intent log —
``journal.jsonl`` — recording the writer's PID + boot id, the invoking
command line, every committed checkpoint step, and the terminal status.
A fresh process can therefore classify any run on disk
(:func:`classify_run`): FINISHED / FAILED / INTERRUPTED (meta says
RUNNING but the recorded PID is dead or from another boot) / RUNNING
(PID alive, same boot). ``runs doctor``
(:func:`sweep_interrupted`) sweeps a store root, durably marks dead
runs INTERRUPTED, clears stranded tmp files, and reports which runs
have a resumable checkpoint — the entry point a watchdog or arbiter
uses to converge the store after any number of kills.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Mapping

from ..resilience import durability
from ..runtime import distributed as rt

JOURNAL_NAME = "journal.jsonl"
TERMINAL_STATUSES = ("FINISHED", "FAILED", "INTERRUPTED")

# Journal heartbeat throttle: log_metrics touches the journal's mtime at
# most this often, so "heartbeat age" stays meaningful without an fsync
# per metric line.
_HEARTBEAT_EVERY_S = 5.0

# The argv of the current CLI invocation, stashed by the CLI so the
# journal's start event records a replayable command line (what
# `runs doctor --resume` re-executes with --resume-auto).
_run_cmdline: list[str] | None = None


def set_run_cmdline(argv: list[str] | None) -> None:
    global _run_cmdline
    _run_cmdline = list(argv) if argv is not None else None


def _now() -> float:
    return time.time()


def boot_id() -> str:
    """Kernel boot identity, so a recycled PID on a rebooted host can
    never masquerade as a live run."""
    try:
        return Path(
            "/proc/sys/kernel/random/boot_id"
        ).read_text().strip()
    except OSError:
        return ""


def pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return False
    return True


class RunStore:
    """One run's param/metric/artifact sink. Cheap, append-only, crash-safe.

    ``_last_heartbeat`` and ``_closed`` sit under ``_journal_lock``: the
    fit thread logs metrics while an exit path may race :meth:`finish`.
    """

    def __init__(
        self,
        root: str | os.PathLike,
        experiment: str,
        run_id: str | None = None,
        run_name: str | None = None,
        *,
        coordinator_only: bool = True,
        resume: bool = False,
    ):
        self.active = not coordinator_only or rt.process_index() == 0
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.path = Path(root) / experiment / self.run_id
        self._closed = False
        if not self.active:
            return
        if self.path.exists() and not resume and run_id is not None:
            raise FileExistsError(f"run already exists: {self.path}")
        (self.path / "artifacts").mkdir(parents=True, exist_ok=True)
        self._metrics = open(self.path / "metrics.jsonl", "a", encoding="utf-8")
        meta = {"experiment": experiment, "run_id": self.run_id,
                "run_name": run_name or self.run_id, "status": "RUNNING",
                "start_time": _now()}
        self._write_json("meta.json", meta)
        # Intent log: who is writing this run, from which boot, launched
        # how. The journal is what lets a FUTURE process classify this
        # run after a hard kill — meta.json alone can only ever say
        # RUNNING.
        self._journal_lock = threading.Lock()
        self._last_heartbeat = 0.0
        start_event: dict[str, Any] = {
            "event": "start", "pid": os.getpid(), "boot_id": boot_id(),
            "cwd": os.getcwd(),
        }
        if _run_cmdline is not None:
            start_event["cmdline"] = list(_run_cmdline)
        self.journal_event(**start_event)
        # Always-on flight recorder: this run's span begin/end events go to
        # a crash-durable tail in the run directory, so the last events of
        # a SIGKILLed run, the spans open at the kill included, can be
        # rebuilt (``trace tail``). Registered in the journal so
        # classify_run and the doctor can point at the file.
        from ..telemetry import flightrec

        self._trace_path = flightrec.enable(self.path / "flightrec.jsonl")
        self.journal_event("trace", path=str(self._trace_path))
        # SLO alert transitions journal into the run directory through the
        # same crash-durable appender: if this run dies with an alert
        # firing, the doctor can say so from disk alone.
        from ..telemetry import slo as slo_mod

        self._alerts_path = slo_mod.get_engine().attach_journal(self.path / "alerts.jsonl")
        self.journal_event("slo_journal", path=str(self._alerts_path))

    # -- logging ----------------------------------------------------------

    def log_params(self, params: Mapping[str, Any]) -> None:
        if not self.active:
            return
        merged = {}
        f = self.path / "params.json"
        if f.exists():
            merged = json.loads(f.read_text())
        merged.update({k: _jsonable(v) for k, v in params.items()})
        self._write_json("params.json", merged)

    def log_metrics(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        if not self.active:
            return
        ts = _now()
        lines = "".join(
            json.dumps({"name": name, "value": float(value), "step": step,
                        "ts": ts}) + "\n"
            for name, value in metrics.items()
        )
        with self._journal_lock:
            # finish() flips _closed and closes the handle under this
            # lock; a fit thread logging during shutdown drops the lines
            # instead of writing to a closed file.
            if self._closed:
                return
            self._metrics.write(lines)
            self._metrics.flush()
        self._heartbeat(ts)

    def _heartbeat(self, ts: float) -> None:
        """Throttled journal mtime touch: liveness evidence for the
        doctor without an fsync per metric line."""
        with self._journal_lock:
            if ts - self._last_heartbeat < _HEARTBEAT_EVERY_S:
                return
            self._last_heartbeat = ts
        try:
            os.utime(self.path / JOURNAL_NAME)
        except OSError:
            pass

    # -- the run journal (intent log) -------------------------------------

    def journal_event(self, event: str, **fields: Any) -> None:
        """Durably append one intent-log line (``journal.jsonl``).

        Events the port writes: ``start`` (pid/boot_id/cmdline/cwd),
        ``config`` (the checkpoint dir, before any training), ``resume``
        (restored checkpoint step), ``checkpoint`` (manifest-committed
        step + dir), ``finish`` (terminal status), ``interrupted``
        (doctor verdict). Foreign events are fine: readers ignore what
        they don't know.
        """
        if not self.active:
            return
        obj = {"event": event, "time": _now(), **fields}
        with self._journal_lock:
            durability.append_jsonl(
                self.path / JOURNAL_NAME, [obj], kind="journal"
            )

    def journal_checkpoint(self, step: int, checkpoint_dir: str) -> None:
        """Record a manifest-committed checkpoint step — the journal's
        'last committed step' the doctor reports as resumable."""
        self.journal_event(
            "checkpoint", step=int(step),
            checkpoint_dir=str(Path(checkpoint_dir).absolute()),
        )

    def log_artifact(self, src: str | os.PathLike, name: str | None = None) -> None:
        if not self.active:
            return
        src = Path(src)
        shutil.copy2(src, self.path / "artifacts" / (name or src.name))

    def log_text(self, text: str, name: str) -> None:
        if not self.active:
            return
        (self.path / "artifacts" / name).write_text(text)

    def log_telemetry(self, snapshot: Mapping[str, Any] | None = None) -> None:
        """Archive a telemetry snapshot as this run's ``telemetry.json``.

        ``snapshot`` defaults to the process registry's current state
        (:func:`..telemetry.snapshot`) so callers at run end archive
        their final counters with one call.
        """
        if not self.active:
            return
        if snapshot is None:
            from .. import telemetry

            snapshot = telemetry.snapshot()
        self._write_json("telemetry.json", snapshot)

    def finish(self, status: str = "FINISHED") -> None:
        """Close the run. Idempotent: a second finish (e.g. the crash
        handler racing a normal close) is a no-op instead of a
        double-close of the metrics handle."""
        if not self.active:
            return
        with self._journal_lock:
            if self._closed:
                return
            self._closed = True
        self.journal_event("finish", status=status)
        meta = json.loads((self.path / "meta.json").read_text())
        meta.update(status=status, end_time=_now())
        self._write_json("meta.json", meta)
        self._metrics.close()
        # Stop recording into a finished run, but only if the recorder and
        # the alert journal still target this run's files (a newer run may
        # have re-targeted them already; then both calls are no-ops).
        from ..telemetry import flightrec
        from ..telemetry import slo as slo_mod

        flightrec.disable(self._trace_path)
        slo_mod.get_engine().detach_journal(self._alerts_path)

    # -- context manager (finish() may never run on a hard crash; `with`
    # scopes the metrics handle to the block and stamps the outcome) ------

    def __enter__(self) -> "RunStore":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.finish("FAILED" if exc_type is not None else "FINISHED")
        return False

    # -- reading back -----------------------------------------------------

    def metrics(self) -> list[dict]:
        if not self.active:
            return []
        with self._journal_lock:
            if not self._closed:
                # Read-back while the append handle is still open: flush
                # so the reader sees every logged line. Under the lock:
                # finish() may close the handle between an unlocked
                # check and the flush.
                self._metrics.flush()
        with open(self.path / "metrics.jsonl", encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]

    def params(self) -> dict:
        f = self.path / "params.json"
        return json.loads(f.read_text()) if self.active and f.exists() else {}

    def _write_json(self, name: str, obj) -> None:
        # Durable atomic publish: meta.json flipping to FINISHED (or a
        # params/telemetry rewrite) must survive a power cut and can
        # never be read torn.
        durability.durable_write_json(
            self.path / name, obj, indent=2, kind="run_json"
        )

    # -- optional MLflow bridge ------------------------------------------

    def to_mlflow(self, tracking_uri: str | None = None) -> None:
        """Export this run to an MLflow server, if mlflow is installed."""
        if not self.active:
            return
        import mlflow  # optional dependency, import deferred: raises where it is missing

        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        meta = json.loads((self.path / "meta.json").read_text())
        mlflow.set_experiment(meta["experiment"])
        with mlflow.start_run(run_name=meta["run_name"]):
            mlflow.log_params(self.params())
            for m in self.metrics():
                mlflow.log_metric(m["name"], m["value"], step=m["step"] or 0)


def read_journal(run_dir: str | os.PathLike) -> list[dict]:
    """Parse a run's ``journal.jsonl``, tolerating a torn last line
    (a kill mid-append is exactly the condition the journal exists
    for)."""
    return _read_jsonl(Path(run_dir) / JOURNAL_NAME, "event")


def _read_jsonl(path: Path, key: str) -> list[dict]:
    """The dict lines of a JSONL file that carry ``key``; torn or
    foreign lines are skipped, a missing file is empty."""
    if not path.exists():
        return []
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return []
    out: list[dict] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn append: skip, never crash the classifier
        if isinstance(obj, dict) and key in obj:
            out.append(obj)
    return out


def classify_run(run_dir: str | os.PathLike) -> dict:
    """Journal-based status of one run directory, judged from disk.

    Returns a dict with (at least): ``status`` (the stored meta
    status), ``effective_status`` (FINISHED / FAILED / INTERRUPTED /
    RUNNING / UNKNOWN), ``live`` (pid alive, same boot), ``pid``,
    ``last_step`` + ``checkpoint_dir`` (newest journaled checkpoint
    commit), ``heartbeat_age_s``, and ``cmdline`` (the recorded CLI
    invocation, for doctor --resume).
    """
    run_dir = Path(run_dir)
    out: dict[str, Any] = {
        "run_dir": str(run_dir),
        "run_id": run_dir.name,
        "experiment": run_dir.parent.name,
        "status": None,
        "effective_status": "UNKNOWN",
        "live": False,
        "pid": None,
        "last_step": None,
        "checkpoint_dir": None,
        "cmdline": None,
        "cwd": None,
        "trace_file": None,
        "alerts_file": None,
        "firing_alerts": [],
        "heartbeat_age_s": None,
    }
    try:
        meta = json.loads((run_dir / "meta.json").read_text())
    except (OSError, json.JSONDecodeError):
        return out
    out["status"] = meta.get("status")
    out["start_time"] = meta.get("start_time")
    events = read_journal(run_dir)
    for e in events:
        if e["event"] == "start":
            out["pid"] = e.get("pid")
            out["boot_id"] = e.get("boot_id", "")
            if e.get("cmdline"):
                out["cmdline"] = e["cmdline"]
            if e.get("cwd"):
                out["cwd"] = e["cwd"]
        elif e["event"] == "config":
            if e.get("checkpoint_dir"):
                out["checkpoint_dir"] = e["checkpoint_dir"]
        elif e["event"] == "trace":
            # The flight-recorder tail this run's writer recorded into —
            # where a dead run's last (and in-flight) spans live.
            out["trace_file"] = e.get("path")
        elif e["event"] == "slo_journal":
            out["alerts_file"] = e.get("path")
        elif e["event"] in ("checkpoint", "manifest_repair"):
            out["last_step"] = e.get("step")
            out["checkpoint_dir"] = e.get("checkpoint_dir")
    journal = run_dir / JOURNAL_NAME
    try:
        out["heartbeat_age_s"] = round(_now() - journal.stat().st_mtime, 1)
    except OSError:
        pass
    if out["alerts_file"]:
        # Alerts whose LAST journaled transition left them firing: for
        # a dead run this is "what was burning when it died"; for a
        # live one, what is burning now.
        from ..telemetry import slo as slo_mod

        out["firing_alerts"] = slo_mod.firing_at_death(out["alerts_file"])
    if out["status"] in TERMINAL_STATUSES:
        out["effective_status"] = out["status"]
        return out
    if out["status"] != "RUNNING":
        return out
    if out["pid"] is None:
        # A pre-journal (or torn-at-birth) RUNNING run: nothing can
        # vouch for a live writer, so it is interrupted by default.
        out["effective_status"] = "INTERRUPTED"
        return out
    same_boot = (not out.get("boot_id")) or out["boot_id"] == boot_id()
    out["live"] = same_boot and pid_alive(int(out["pid"]))
    out["effective_status"] = "RUNNING" if out["live"] else "INTERRUPTED"
    return out


def sweep_interrupted(root, experiment: str | None = None, *,
                      mark: bool = True) -> list[dict]:
    """The ``runs doctor`` core: classify every run under ``root``.

    Dead-PID RUNNING runs are (with ``mark=True``) durably flipped to
    INTERRUPTED in ``meta.json``, journaled (``interrupted`` event),
    counted on ``runs_interrupted_total``, and swept of stranded
    ``*.tmp`` files. Each returned entry additionally carries
    ``resumable_step``: the newest manifest-intact (or unverified)
    checkpoint step under the run's journaled checkpoint dir, or None.
    """
    from .. import telemetry
    from ..resilience import checkpoint as integrity

    interrupted = telemetry.counter(
        "runs_interrupted_total",
        "dead-PID RUNNING runs marked INTERRUPTED by the doctor sweep",
    )
    root = Path(root)
    report: list[dict] = []
    experiments = (
        [root / experiment] if experiment
        else sorted(p for p in root.iterdir() if p.is_dir())
        if root.is_dir() else []
    )
    for exp_dir in experiments:
        if not exp_dir.is_dir():
            continue
        for run_dir in sorted(p for p in exp_dir.iterdir() if p.is_dir()):
            cls = classify_run(run_dir)
            if cls["status"] is None:
                continue  # foreign/unreadable directory: not a run
            newly_marked = (
                mark
                and cls["status"] == "RUNNING"
                and cls["effective_status"] == "INTERRUPTED"
            )
            if newly_marked:
                try:
                    meta = json.loads((run_dir / "meta.json").read_text())
                    meta.update(
                        status="INTERRUPTED",
                        end_time=(run_dir / JOURNAL_NAME).stat().st_mtime
                        if (run_dir / JOURNAL_NAME).exists() else _now(),
                        interrupted_by="runs doctor",
                    )
                    durability.durable_write_json(
                        run_dir / "meta.json", meta, indent=2,
                        kind="run_json",
                    )
                    durability.append_jsonl(
                        run_dir / JOURNAL_NAME,
                        [{"event": "interrupted", "time": _now(),
                          "by": "runs doctor",
                          "dead_pid": cls["pid"]}],
                        kind="journal",
                    )
                except OSError as e:
                    # The mark did NOT land: report and count nothing —
                    # a "marked" claim the next sweep repeats would
                    # double-count forever and lie to the operator.
                    cls["mark_error"] = str(e)
                else:
                    interrupted.inc()
                    cls["marked"] = True
                    swept = durability.sweep_stranded_tmp(run_dir)
                    cls["swept_tmp"] = [str(p) for p in swept]
            cls["resumable_step"] = None
            if (
                cls["effective_status"] == "INTERRUPTED"
                and cls["checkpoint_dir"]
                and Path(cls["checkpoint_dir"]).is_dir()
            ):
                for step in sorted(
                    integrity.list_steps(cls["checkpoint_dir"]), reverse=True
                ):
                    status, _ = integrity.verify_step(
                        Path(cls["checkpoint_dir"]) / str(step)
                    )
                    if status in ("intact", "unverified"):
                        cls["resumable_step"] = step
                        break
            report.append(cls)
    return report


def list_runs(root, experiment: str | None = None) -> list[dict]:
    """Run summaries under a store root, newest first.

    The read side of the store (the ``mlflow ui`` browsing equivalent
    for a plain-FS root): each entry is the run's ``meta.json`` plus a
    ``wall_seconds`` convenience — metadata only, so listing stays O(1)
    per run regardless of metric volume (``load_run`` reads the
    metrics). Unreadable/foreign directories are skipped, not fatal.
    """
    root = Path(root)
    out: list[dict] = []
    experiments = (
        [root / experiment] if experiment else
        sorted(p for p in root.iterdir() if p.is_dir()) if root.is_dir()
        else []
    )
    for exp_dir in experiments:
        if not exp_dir.is_dir():
            continue
        for run_dir in sorted(p for p in exp_dir.iterdir() if p.is_dir()):
            meta_file = run_dir / "meta.json"
            try:
                meta = json.loads(meta_file.read_text())
            except (OSError, json.JSONDecodeError):
                continue
            if meta.get("end_time") and meta.get("start_time"):
                meta["wall_seconds"] = round(
                    meta["end_time"] - meta["start_time"], 1
                )
            if meta.get("status") == "RUNNING":
                # Journal-truth rendering: a RUNNING run whose recorded
                # PID is dead shows as INTERRUPTED in listings even
                # before a doctor sweep rewrites its meta (the listing
                # itself never writes).
                cls = classify_run(run_dir)
                meta["live"] = cls["live"]
                if cls["effective_status"] == "INTERRUPTED":
                    meta["status"] = "INTERRUPTED"
            out.append(meta)
    out.sort(key=lambda m: m.get("start_time", 0.0), reverse=True)
    return out


def load_run(root, experiment: str, run_id: str) -> dict:
    """Full record of one run: meta, params, the last value of every
    metric (with its step), and artifact names."""
    path = Path(root) / experiment / run_id
    meta = json.loads((path / "meta.json").read_text())
    params_file = path / "params.json"
    params = (
        json.loads(params_file.read_text()) if params_file.exists() else {}
    )
    last: dict[str, dict] = {}
    n_points = 0
    metrics_file = path / "metrics.jsonl"
    if metrics_file.exists():
        with open(metrics_file, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                m = json.loads(line)
                last[m["name"]] = {"value": m["value"], "step": m["step"]}
                n_points += 1
    artifacts_dir = path / "artifacts"
    artifacts = (
        sorted(p.name for p in artifacts_dir.iterdir())
        if artifacts_dir.is_dir() else []
    )
    return {
        "meta": meta,
        "params": params,
        "last_metrics": last,
        "metric_points": n_points,
        "artifacts": artifacts,
    }


@contextlib.contextmanager
def start_run(root, experiment, **kwargs):
    """``with start_run(...) as run:`` — mirrors ``mlflow.start_run()``."""
    run = RunStore(root, experiment, **kwargs)
    try:
        yield run
        run.finish("FINISHED")
    except BaseException:
        run.finish("FAILED")
        raise


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)
