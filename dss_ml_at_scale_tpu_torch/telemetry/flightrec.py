"""Always-on flight recorder: span begin/end events on a crash-durable tail.

Port copy of ``dss_ml_at_scale_tpu/telemetry/flightrec.py`` (the JAX
package's module imports nothing of JAX, but the port keeps its own copy):
the same events, tail file, ring, fsync throttle and rotation, so each
package's ``trace tail`` reads the other's run directories.

The span log records a span only at *exit* — a span open when the
process is SIGKILLed (the step that was running, the checkpoint that was
half-committed) simply never existed as far as the archive is concerned.
That is exactly backwards for crash forensics: the in-flight work is the
most interesting record a dead run leaves.

The flight recorder fixes the ordering: every span emits a **begin**
event the moment it opens (and an end event when it closes), each event
goes to a per-thread in-memory ring buffer (bounded live view) AND is
written through to an append-only JSONL tail via
:func:`~dss_ml_at_scale_tpu_torch.resilience.durability.append_jsonl` — the
same torn-tail-healing appender the run journal uses, so a kill
mid-append can never corrupt an earlier record. fsync is throttled
(every :data:`_FSYNC_EVERY` events or :data:`_FSYNC_EVERY_S` seconds):
a SIGKILL loses nothing that reached the page cache, and a power cut
loses at most one throttle window.

``RunStore`` enables the recorder for every tracked run (one
``flightrec.jsonl`` per run directory, registered in the run journal so
``runs doctor`` can point at it), and ``trace tail`` rebuilds
the last events of a dead run — including the begin-only spans that were
open at the kill — from the tail alone.

Event shape (one JSON object per line)::

    {"ph": "B"|"E"|"X", "name", "ts", "pid", "tid", "thread",
     "trace", "span", "parent", "kind", "args", "dur"(E/X only)}

``trace``/``parent``/``kind`` appear only under an active
:mod:`~dss_ml_at_scale_tpu_torch.telemetry.tracecontext`; ``span`` is always
present so B/E pairs match.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from pathlib import Path

from ..resilience.durability import append_jsonl

# fsync throttle: durability against power loss is best-effort between
# these marks; SIGKILL durability (the chaos soak's threat model) needs
# only the write-through, which happens per event.
_FSYNC_EVERY = 64
_FSYNC_EVERY_S = 2.0

# Rotation bound: one tail file never grows past this; the previous
# generation is kept as <path>.1 so "the last N events" always spans at
# least max_bytes of history.
_MAX_BYTES = 16 * 1024 * 1024

_RING_SIZE = 512


_bytes_handle = None


def _bytes_counter():
    global _bytes_handle
    if _bytes_handle is None:
        # Local import: telemetry/__init__ imports this module. Cached:
        # this sits on the span hot path under the recorder lock, so a
        # registry lookup per event would be pure contention.
        from . import counter

        _bytes_handle = counter(
            "flight_recorder_bytes_total",
            "bytes appended to the flight-recorder tail",
        )
    return _bytes_handle


class FlightRecorder:
    """Per-thread ring buffers plus one write-through JSONL tail.

    Two locks on purpose: the ring registry lives under ``_lock`` (pure
    memory — ring appends and :meth:`tail` snapshots never wait on
    disk), while the tail-file state (``_path``, byte/fsync accounting)
    lives under ``_io_lock``, so a throttled fsync stalls only writers
    racing for the same file, never a thread that only needs its ring.
    """

    # Lock contract: emitters run on
    # every thread family in the process; the ring registry is only
    # touched under _lock (the tail-file state is serialized by the
    # dedicated _io_lock inside emit()/enable()/disable()).
    _guarded_by_lock = ("_rings",)

    def __init__(self, ring_size: int = _RING_SIZE,
                 max_bytes: int = _MAX_BYTES):
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._path: Path | None = None
        self._ring_size = ring_size
        self._max_bytes = max_bytes
        self._rings: dict[int, collections.deque] = {}
        self._since_fsync = 0
        self._last_fsync = 0.0
        self._tail_bytes = 0

    # -- lifecycle ---------------------------------------------------------

    @property
    def path(self) -> Path | None:
        with self._io_lock:
            return self._path

    def enable(self, path: str | os.PathLike) -> Path:
        """Start (or re-target) recording onto ``path``. The first
        append heals any torn tail a killed predecessor left."""
        path = Path(path).absolute()
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {
            "ph": "M", "name": "recorder_start", "ts": time.time(),
            "pid": os.getpid(),
            "args": {"argv": list(sys.argv)},
        }
        with self._io_lock:
            self._path = path
            self._tail_bytes = path.stat().st_size if path.exists() else 0
            self._tail_bytes += self._append([meta], fsync=True)
            self._since_fsync = 0
            self._last_fsync = time.monotonic()
        return path

    def disable(self, path: str | os.PathLike | None = None) -> None:
        """Stop recording. With ``path`` given, stop only if the
        recorder still targets that file — a finished run must not
        switch off the recorder a newer run already re-targeted."""
        with self._io_lock:
            if path is not None and self._path != Path(path).absolute():
                return
            self._path = None

    @property
    def enabled(self) -> bool:
        with self._io_lock:
            return self._path is not None

    # -- emit --------------------------------------------------------------

    def emit(self, event: dict) -> None:
        """Record one event: ring always, tail when enabled."""
        tid = threading.get_ident()
        with self._lock:
            ring = self._rings.get(tid)
            if ring is None:
                ring = self._rings[tid] = collections.deque(
                    maxlen=self._ring_size
                )
            ring.append(event)
        with self._io_lock:
            if self._path is None:
                return
            self._since_fsync += 1
            now = time.monotonic()
            do_fsync = (
                self._since_fsync >= _FSYNC_EVERY
                or now - self._last_fsync >= _FSYNC_EVERY_S
            )
            if do_fsync:
                self._since_fsync = 0
                self._last_fsync = now
            self._tail_bytes += self._append([event], fsync=do_fsync)
            if self._tail_bytes >= self._max_bytes:
                self._rotate()

    def _append(self, events: list[dict], *, fsync: bool) -> int:
        """Write-through; reached only from emit()/enable() with
        _io_lock already held. Returns bytes added (append_jsonl
        serializes exactly once and reports what it wrote)."""
        try:
            n = append_jsonl(self._path, events, kind="flightrec",
                             fsync=fsync)
            _bytes_counter().inc(n)
            return n
        except OSError:
            # A full disk or yanked mount must degrade recording, never
            # fail the workload being recorded.
            return 0

    def _rotate(self) -> None:
        """Recycle the tail: current file becomes ``<path>.1`` (replacing
        the previous generation), recording continues on a fresh file.
        Called with _io_lock held."""
        try:
            # dsst: ignore[durable-write] log recycling, not a publish: both generations are append-only forensics
            os.replace(self._path, self._path.with_name(self._path.name + ".1"))
        except OSError:
            return
        self._tail_bytes = 0

    # -- live view ---------------------------------------------------------

    def tail(self, n: int = 64) -> list[dict]:
        """The last ``n`` in-memory events across every thread ring,
        oldest first — the live-process view (``trace tail`` reads
        the FILE for dead processes). Never waits on tail-file I/O."""
        with self._lock:
            events = [e for ring in self._rings.values() for e in ring]
        events.sort(key=lambda e: e.get("ts", 0.0))
        return events[-n:]


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def enable(path: str | os.PathLike) -> Path:
    return _recorder.enable(path)


def disable(path: str | os.PathLike | None = None) -> None:
    _recorder.disable(path)


def emit(event: dict) -> None:
    _recorder.emit(event)


# -- reading a tail back ------------------------------------------------------


def read_raw(path: str | os.PathLike) -> list[dict]:
    """Every parseable JSON-object line of ``path``'s rotation chain
    (``<path>.1`` first when present, then ``path``), tolerating a torn
    last line (the file's whole purpose is to outlive a SIGKILL
    mid-append). The one JSONL reader every trace consumer shares —
    ``trace export`` must see the same history ``tail`` does."""
    out: list[dict] = []
    path = Path(path)
    for p in (path.with_name(path.name + ".1"), path):
        if not p.exists():
            continue
        try:
            text = p.read_text(encoding="utf-8")
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line
            if isinstance(obj, dict):
                out.append(obj)
    return out


def read_events(path: str | os.PathLike) -> list[dict]:
    """The flight-recorder events of ``path``'s rotation chain (lines
    bearing a ``ph`` phase; plain span-log rows are not recorder
    events)."""
    return [e for e in read_raw(path) if "ph" in e]


def reconstruct(events: list[dict]) -> tuple[list[dict], list[dict]]:
    """Match B/E pairs → ``(complete, open_spans)``.

    ``complete`` holds span-log-shaped dicts (name/ts/dur/ids — "X"
    events pass through; E events close their B); ``open_spans`` holds
    the begin events that never closed — the in-flight work at the kill,
    newest last.

    B/E pairing keys on ``(trace, span)``: span ids are unique only
    within a trace (32 random bits — a long tail holds enough spans
    that bare-id collisions across traces are a birthday certainty),
    and an E must never close another trace's B.
    """
    open_by_span: dict[tuple, dict] = {}
    complete: list[dict] = []
    for e in events:
        ph = e.get("ph")
        if ph == "B" and e.get("span"):
            open_by_span[(e.get("trace"), e["span"])] = e
        elif ph == "E" and e.get("span"):
            b = open_by_span.pop((e.get("trace"), e["span"]), None)
            start = b if b is not None else e
            done = dict(start)
            done.pop("ph", None)
            done["dur"] = e.get("dur", 0.0)
            complete.append(done)
        elif ph == "X":
            done = dict(e)
            done.pop("ph", None)
            complete.append(done)
    opens = sorted(open_by_span.values(), key=lambda e: e.get("ts", 0.0))
    complete.sort(key=lambda e: e.get("ts", 0.0))
    return complete, opens
