"""Poison-batch provenance and the quarantine blocklist.

Port of ``dss_ml_at_scale_tpu/resilience/rollback.py``. The file format is
the JAX package's, line for line, so either package reads a blocklist the
other wrote.

Rollback-and-skip recovery (PaLM's manual "rewind past the loss spike
and skip the offending batches", done automatically by the training
health supervisor) needs two pieces of bookkeeping that live here:

- **Batch provenance**: the streaming reader tags every emitted batch
  with the exact rows that built it — a list of :class:`RowRange`
  ``(shard path, row group, [row_lo, row_hi))`` segments, carried under
  the :data:`PROVENANCE_KEY` side-channel key and stripped by the
  Trainer before device transfer. Without it, "exclude the batch that
  blew up the gradients" is not an expressible operation.
- **The quarantine list**: an append-only JSONL blocklist of quarantined
  row ranges. The supervisor appends the provenance of every discarded
  batch; the reader consults the list when (re)starting a stream, so a
  replay or ``--resume`` never feeds the poison rows again. JSONL keeps
  it human-greppable and append-crash-safe (a truncated last line is
  skipped with a warning, never a crashed run); ``quarantine
  list|clear`` is the operator face.

Exclusion is row-exact: the reader drops precisely the quarantined rows
and repacks the surviving stream into batches at the same boundaries,
which is what makes "a run that skipped batch k" and "a run whose
reader excluded batch k's rows" produce bitwise-identical update
sequences (the deterministic-rollback-parity property the tests hold).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from . import durability

log = logging.getLogger(__name__)

# Side-channel batch key the reader attaches provenance under; consumers
# that ship batches to devices must pop it first (the Trainer does).
PROVENANCE_KEY = "_provenance"


@dataclasses.dataclass(frozen=True)
class RowRange:
    """A half-open row interval within one Parquet row group."""

    path: str
    row_group: int
    row_lo: int
    row_hi: int

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "row_group": self.row_group,
            "row_lo": self.row_lo,
            "row_hi": self.row_hi,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "RowRange":
        return cls(
            path=str(obj["path"]),
            row_group=int(obj["row_group"]),
            row_lo=int(obj["row_lo"]),
            row_hi=int(obj["row_hi"]),
        )

    @property
    def num_rows(self) -> int:
        return self.row_hi - self.row_lo


def compress_rows(path: str, row_group: int,
                  rows: Sequence[int]) -> list[RowRange]:
    """Sorted-or-not row indices → minimal list of contiguous RowRanges."""
    if len(rows) == 0:
        return []
    idx = np.sort(np.asarray(rows, dtype=np.int64))
    # Boundaries where consecutive indices break contiguity.
    breaks = np.flatnonzero(np.diff(idx) != 1) + 1
    out = []
    for seg in np.split(idx, breaks):
        out.append(RowRange(path, row_group, int(seg[0]), int(seg[-1]) + 1))
    return out


class QuarantineList:
    """Append-only JSONL blocklist of quarantined row ranges.

    One JSON object per line::

        {"path": ..., "row_group": 3, "row_lo": 16, "row_hi": 32,
         "reason": "nonfinite grads at step 7", "step": 7, "time": ...}

    Thread-safe: reader decode workers call :meth:`keep_mask`
    concurrently with the supervisor's :meth:`add`. The in-memory index
    reflects the file as of the last :meth:`refresh` plus everything
    added through this instance; a fresh reader iteration refreshes, so
    replay/resume always sees the full blocklist.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._entries: list[dict] = []
        # (path, row_group) -> [(lo, hi), ...]
        self._index: dict[tuple[str, int], list[tuple[int, int]]] = {}
        self.refresh()

    # -- persistence ------------------------------------------------------

    def refresh(self) -> None:
        """Re-read the blocklist file (tolerating a truncated tail)."""
        entries: list[dict] = []
        if self.path.exists():
            for lineno, line in enumerate(
                self.path.read_text().splitlines(), start=1
            ):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                    RowRange.from_json(obj)  # validates the range fields
                except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                    # A torn append (crash mid-write) or a foreign line
                    # must not wedge every future run of this dataset.
                    log.warning(
                        "quarantine list %s:%d unreadable; skipping line",
                        self.path, lineno,
                    )
                    continue
                entries.append(obj)
        with self._lock:
            self._entries = entries
            self._index = _build_index(entries)

    def add(self, ranges: Iterable[RowRange], *, reason: str = "",
            step: int | None = None) -> int:
        """Append ranges to the file and the live index; returns count.

        Paths are stored absolute: the blocklist must keep matching when
        a replay/resume is invoked from a different cwd or with a
        different spelling of the dataset path.
        """
        new_entries = []
        for r in ranges:
            obj = r.to_json()
            obj["path"] = _norm_path(obj["path"])
            obj["reason"] = reason
            if step is not None:
                obj["step"] = int(step)
            obj["time"] = time.time()
            new_entries.append(obj)
        if not new_entries:
            return 0
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            # Durable append (fsynced): "these rows are excluded from
            # replay/resume" is a promise to FUTURE processes — a
            # power cut right after the discard must not let the poison
            # rows back in.
            durability.append_jsonl(
                self.path, new_entries, kind="quarantine"
            )
            self._entries.extend(new_entries)
            for obj in new_entries:
                self._index.setdefault(
                    (_norm_path(obj["path"]), int(obj["row_group"])), []
                ).append((int(obj["row_lo"]), int(obj["row_hi"])))
        return len(new_entries)

    def clear(self) -> int:
        """Remove every entry (and the file); returns how many were held."""
        with self._lock:
            n = len(self._entries)
            self._entries = []
            self._index = {}
            self.path.unlink(missing_ok=True)
        return n

    # -- queries ----------------------------------------------------------

    @property
    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keep_mask(self, path: str, row_group: int,
                  num_rows: int) -> np.ndarray | None:
        """Boolean keep-mask for one row group, or None when untouched.

        None is the fast path: the caller skips the fancy-index copy
        entirely for the (overwhelmingly common) unquarantined group.
        """
        with self._lock:
            spans = self._index.get((_norm_path(path), int(row_group)))
        if not spans:
            return None
        mask = np.ones(num_rows, bool)
        for lo, hi in spans:
            mask[max(lo, 0):min(hi, num_rows)] = False
        return mask


def _norm_path(path) -> str:
    """Index key for a shard path: absolute, so 'data/x.parquet' from one
    invocation and '/abs/data/x.parquet' from the next hit the same
    blocklist entry (pre-normalization entries in an existing file are
    re-normalized on read)."""
    return str(Path(path).absolute())


def _build_index(entries: list[dict]) -> dict:
    index: dict[tuple[str, int], list[tuple[int, int]]] = {}
    for obj in entries:
        index.setdefault(
            (_norm_path(obj["path"]), int(obj["row_group"])), []
        ).append((int(obj["row_lo"]), int(obj["row_hi"])))
    return index
