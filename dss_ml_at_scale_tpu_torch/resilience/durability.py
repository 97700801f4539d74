"""Crash-only durable publishes: write tmp → fsync → rename → fsync dir.

Port of ``dss_ml_at_scale_tpu/resilience/durability.py`` (the publish
helpers; the JAX module's fault-injection sites are not ported). The
contract every helper here implements:

1. write the payload to ``<target>.tmp`` **in the same directory**
   (same filesystem, so the rename is atomic);
2. ``fsync`` the tmp file (the payload is on disk before anything
   points at it);
3. ``os.replace`` tmp → target (atomic: readers see old-or-new, never
   torn);
4. ``fsync`` the parent directory (the *rename itself* is on disk).

A crash at any point leaves either the old target, or the old target
plus a stray ``*.tmp`` — never a torn target.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

TMP_SUFFIX = ".tmp"


def fsync_dir(path: str | os.PathLike) -> None:
    """fsync a directory so a just-committed rename survives power loss.

    Filesystems that refuse directory fsync (some network mounts) are
    tolerated: the rename is still atomic, just not provably durable.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_write_bytes(path: str | os.PathLike, data: bytes) -> Path:
    """Atomically and durably publish ``data`` at ``path``."""
    path = Path(path)
    tmp = path.with_name(path.name + TMP_SUFFIX)
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return path


def durable_write_text(path: str | os.PathLike, text: str) -> Path:
    return durable_write_bytes(path, text.encode("utf-8"))


def durable_write_json(path: str | os.PathLike, obj, *, indent: int | None = None) -> Path:
    return durable_write_bytes(path, json.dumps(obj, indent=indent).encode("utf-8"))


def durable_replace(tmp: str | os.PathLike, dst: str | os.PathLike) -> Path:
    """Durably publish an already-staged tmp file (fsync → rename → fsync
    dir), for payloads written by another writer (``torch.save``)."""
    tmp, dst = Path(tmp), Path(dst)
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst)
    fsync_dir(dst.parent)
    return dst
