"""Crash-only durable publishes: write tmp → fsync → rename → fsync dir.

Every other resilience layer in this package assumes that what was
"written" is actually on disk: the checkpoint manifest that proves a
step intact, the run-store ``meta.json`` that says FINISHED, the
quarantine blocklist that keeps poison rows out of a replay. None of
that holds across a hard kill (``kill -9``, OOM-kill, power cut)
without the full durable-publish sequence — a bare ``write_text`` +
``rename`` can leave a *published* file whose pages never hit the
platter, or a torn tmp that the next reader trips over.

The contract every helper here implements:

1. write the payload to ``<target>.tmp`` **in the same directory**
   (same filesystem, so the rename is atomic);
2. ``fsync`` the tmp file (the payload is on disk before anything
   points at it);
3. ``os.replace`` tmp → target (atomic: readers see old-or-new, never
   torn);
4. ``fsync`` the parent directory (the *rename itself* is on disk).

A crash at any point leaves either the old target, or the old target
plus a stray ``*.tmp`` — never a torn target. Stray tmps are garbage,
not damage; :func:`sweep_stranded_tmp` (run by ``runs doctor`` and
by the Trainer's resume path) collects them.

Fault sites (seeded via ``--fault-plan``, names in
``resilience.faults.KNOWN_SITES``) tear each stage exactly like a power
cut would: ``fs.torn_write.<kind>`` leaves a truncated tmp and fails
before publish, ``fs.crash_after_tmp.<kind>`` leaves a complete tmp and
never publishes, ``fs.fsync.<kind>`` raises at the fsync (EIO-style).
Armed as ``kN`` entries they SIGKILL the process *inside* the write
window instead. ``<kind>`` is the publish point's label (``manifest``,
``checkpoint``, ``run_json``, ``journal``, ``quarantine``, ``bundle``) so
a plan can target one publish family without tearing every write in the
process. The time spent in fsync accumulates on
``fsync_seconds_total``.

Port of ``dss_ml_at_scale_tpu/resilience/durability.py``. The one
difference is what :func:`find_stranded_tmp` treats as a stray
directory: the port stages a checkpoint step in ``<step>.tmp-<pid>/``
(the JAX package's orbax leaves ``*orbax*tmp*`` directories instead).
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Iterable

from .faults import InjectedFault, fault_fires, maybe_fail

log = logging.getLogger(__name__)

TMP_SUFFIX = ".tmp"


def _fsync_seconds():
    from .. import telemetry

    return telemetry.counter(
        "fsync_seconds_total",
        "wall seconds spent in fsync by durable publishes",
    )


def _fsync_fd(fd: int, kind: str) -> None:
    maybe_fail(f"fs.fsync.{kind}")
    t0 = time.perf_counter()
    os.fsync(fd)
    _fsync_seconds().inc(time.perf_counter() - t0)


def fsync_dir(path: str | os.PathLike, *, kind: str = "dir") -> None:
    """fsync a directory so a just-committed rename survives power loss.

    Filesystems that refuse directory fsync (some network mounts) are
    tolerated — the rename is still atomic, just not provably durable —
    but an injected ``fs.fsync`` fault always surfaces.
    """
    maybe_fail(f"fs.fsync.{kind}")
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        t0 = time.perf_counter()
        os.fsync(fd)
        _fsync_seconds().inc(time.perf_counter() - t0)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_write_bytes(path: str | os.PathLike, data: bytes, *,
                        kind: str = "file") -> Path:
    """Atomically and durably publish ``data`` at ``path``."""
    path = Path(path)
    tmp = path.with_name(path.name + TMP_SUFFIX)
    if fault_fires(f"fs.torn_write.{kind}"):
        # The power-cut-mid-write twin: a truncated tmp hits the disk,
        # nothing is published, and the caller sees a hard failure.
        tmp.write_bytes(data[: max(1, len(data) // 2)])
        raise InjectedFault(
            f"injected torn write publishing {path.name} (kind={kind})"
        )
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        _fsync_fd(f.fileno(), kind)
    if fault_fires(f"fs.crash_after_tmp.{kind}"):
        # Crash between stage and publish: a complete tmp is stranded.
        raise InjectedFault(
            f"injected crash before publishing {path.name} (kind={kind})"
        )
    os.replace(tmp, path)
    fsync_dir(path.parent, kind=kind)
    return path


def durable_write_text(path: str | os.PathLike, text: str, *,
                       kind: str = "file") -> Path:
    return durable_write_bytes(path, text.encode("utf-8"), kind=kind)


def durable_write_json(path: str | os.PathLike, obj, *,
                       indent: int | None = None,
                       kind: str = "file") -> Path:
    return durable_write_bytes(
        path, json.dumps(obj, indent=indent).encode("utf-8"), kind=kind
    )


def durable_replace(tmp: str | os.PathLike, dst: str | os.PathLike, *,
                    kind: str = "file") -> Path:
    """Durably publish an already-staged tmp file (fsync → rename →
    fsync dir), for payloads written by another writer (``torch.save``)
    that cannot stream through :func:`durable_write_bytes`."""
    tmp, dst = Path(tmp), Path(dst)
    fd = os.open(tmp, os.O_RDONLY)
    try:
        _fsync_fd(fd, kind)
    finally:
        os.close(fd)
    if fault_fires(f"fs.crash_after_tmp.{kind}"):
        raise InjectedFault(
            f"injected crash before publishing {dst.name} (kind={kind})"
        )
    os.replace(tmp, dst)
    fsync_dir(dst.parent, kind=kind)
    return dst


def append_jsonl(path: str | os.PathLike, objs: Iterable[dict], *,
                 kind: str = "journal", fsync: bool = True) -> int:
    """Durably append one JSON line per object (intent-log discipline).

    Appends are crash-safe by construction when readers tolerate a torn
    last line (the journal and quarantine readers do); ``fsync=True``
    additionally guarantees the lines survive power loss before the
    caller acts on them. Returns the number of bytes appended (the
    flight recorder's rotation accounting — serialized once, here).
    """
    path = Path(path)
    lines = [json.dumps(o) for o in objs]
    if not lines:
        return 0
    payload = "\n".join(lines) + "\n"
    # Heal a torn tail: a previous writer killed mid-append can leave a
    # final line with no newline — gluing onto it would corrupt BOTH
    # records. A leading newline re-opens a fresh line (readers skip the
    # blank when the file happened to end cleanly... it never does: we
    # check).
    try:
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                payload = "\n" + payload
    except (OSError, ValueError):
        pass  # missing or empty file: nothing to heal

    if fault_fires(f"fs.torn_write.{kind}"):
        with open(path, "a", encoding="utf-8") as f:
            f.write(payload[: max(1, len(payload) // 2)])
        raise InjectedFault(
            f"injected torn append to {path.name} (kind={kind})"
        )
    with open(path, "a", encoding="utf-8") as f:
        f.write(payload)
        f.flush()
        if fsync:
            _fsync_fd(f.fileno(), kind)
    return len(payload)


def find_stranded_tmp(root: str | os.PathLike, *,
                      exclude_substr: tuple[str, ...] = (".corrupt",),
                      ) -> list[Path]:
    """Locate crash strays under ``root``: ``*.tmp`` files from durable
    publishes that never completed, plus checkpoint steps staged in a
    ``<step>.tmp-<pid>`` directory whose rename never happened (a kill
    inside the save window strands one; it is not a step, since the step
    walks take numeric names only, but it is disk ballast). Paths whose
    components contain any of ``exclude_substr`` (quarantined
    ``*.corrupt`` forensics by default) are spared.
    """
    root = Path(root)
    if not root.exists():
        return []

    def excluded(p: Path) -> bool:
        return any(s in part for part in p.parts for s in exclude_substr)

    staged = [
        p for p in sorted(root.rglob(f"*{TMP_SUFFIX}-*"))
        if p.is_dir() and not excluded(p)
    ]
    found = [
        p for p in sorted(root.rglob(f"*{TMP_SUFFIX}"))
        if p.is_file() and not excluded(p)
        and not any(d in p.parents for d in staged)
    ]
    return found + staged


def sweep_stranded_tmp(root: str | os.PathLike, *,
                       exclude_substr: tuple[str, ...] = (".corrupt",),
                       ) -> list[Path]:
    """Remove what :func:`find_stranded_tmp` locates; returns the
    removed paths.

    Safe only under the single-sweeper assumption the checkpoint and
    run layouts already carry: call it at *recovery* points (resume
    start on process 0, ``runs doctor``), never concurrently with an
    active writer or another sweeper.
    """
    import shutil

    removed: list[Path] = []
    for p in find_stranded_tmp(root, exclude_substr=exclude_substr):
        try:
            if p.is_dir():
                shutil.rmtree(p)
            else:
                p.unlink()
            removed.append(p)
        except FileNotFoundError:
            pass  # nested tmp already gone with its swept parent dir
        except OSError as e:
            log.warning("could not remove stranded tmp %s: %s", p, e)
    return removed
