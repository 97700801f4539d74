"""One locked append-and-flush JSONL writer, shared by every tee file.

The span log's tee, the serving access log — any "one JSON object per
line, flushed as it happens, closed once at exit" stream — share the
same mechanics: parent dir created, append handle, per-line
serialize+write+flush under a lock, idempotent close hooked to
``atexit`` (the interpreter never runs ``__del__`` reliably for
module-lifetime objects, and an unclosed append handle can lose its
last buffered lines). Keeping one implementation means a policy fix
(flush discipline, atexit bookkeeping) reaches every stream.

This is operational evidence, NOT durable state: a crash loses at most
the in-flight line. (Port copy of ``dss_ml_at_scale_tpu/utils/jsonl.py``;
the crash-durable appender of the JAX package is not ported yet.)
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from pathlib import Path


class JsonlWriter:
    """Append one JSON object per line to ``path``, flushed per line."""

    # Lock contract: writers run on
    # arbitrary threads (span log: every instrumented thread family;
    # access log: every HTTP handler thread).
    _guarded_by_lock = ("_file",)

    def __init__(self, path: str | os.PathLike):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._file = open(path, "a", encoding="utf-8")
        atexit.register(self.close)

    def write(self, row: dict) -> None:
        # Serialize outside the lock — only the file touch is guarded,
        # so a slow disk never blocks the serialization of other rows.
        line = json.dumps(row) + "\n"
        with self._lock:
            if self._file is not None:
                self._file.write(line)
                self._file.flush()

    def close(self) -> None:
        """Idempotent; also unhooks the atexit registration so a closed
        writer doesn't stay pinned for the process lifetime."""
        with self._lock:
            if self._file is None:
                return
            self._file.close()
            self._file = None
        atexit.unregister(self.close)
