"""Checkpoint integrity: per-step content-checksum manifests.

Port of ``dss_ml_at_scale_tpu/resilience/checkpoint.py``. A preempted
host, a full disk or a flaky network filesystem can leave the newest step
truncated, and a restore that crashes on it loses the whole run though an
older intact step sits right next to it. The contract here:

- :func:`write_manifest` runs after a step is fully committed and
  records every file's size + SHA-256 in ``dsst_manifest.json`` inside
  the step directory (so retention pruning removes it with the step);
- :func:`verify_step` re-hashes against the manifest and classifies the
  step ``intact`` / ``corrupt`` / ``unverified`` (pre-manifest steps
  stay restorable — absence of proof is not proof of corruption);
- restore paths walk newest → oldest and fall back past corrupt steps,
  counting each skip on ``checkpoint_fallback_total``.
"""

from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path

from .. import telemetry
from . import durability

log = logging.getLogger(__name__)

MANIFEST_NAME = "dsst_manifest.json"
_HASH_CHUNK = 1 << 20


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with path.open("rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def write_manifest(step_dir: str | Path) -> dict:
    """Checksum every file under a committed step dir into its manifest."""
    step_dir = Path(step_dir)
    files = {}
    for p in sorted(step_dir.rglob("*")):
        if p.is_file() and p.name not in (MANIFEST_NAME, MANIFEST_NAME + durability.TMP_SUFFIX):
            files[str(p.relative_to(step_dir))] = {
                "sha256": _sha256(p),
                "bytes": p.stat().st_size,
            }
    manifest = {"version": 1, "files": files}
    # A crash mid-write must leave NO manifest (the step stays
    # "unverified" and restorable), never a truncated one, which would read
    # as "corrupt" and roll an intact step back.
    durability.durable_write_json(step_dir / MANIFEST_NAME, manifest, kind="manifest")
    return manifest


def verify_step(step_dir: str | Path) -> tuple[str, list[str]]:
    """``("intact"|"corrupt"|"unverified", problems)`` for one step dir.

    ``unverified`` means no manifest (a pre-manifest checkpoint, or a
    foreign writer): restorable, just not provably intact. Files not
    listed in the manifest are ignored: side-channel metadata written
    after the manifest must not fail verification.
    """
    step_dir = Path(step_dir)
    mf = step_dir / MANIFEST_NAME
    if not mf.exists():
        return "unverified", []
    try:
        manifest = json.loads(mf.read_text())
        entries = manifest["files"].items()
    except (json.JSONDecodeError, KeyError, TypeError, AttributeError) as e:
        return "corrupt", [f"unreadable manifest: {type(e).__name__}: {e}"]
    problems = []
    for rel, want in entries:
        p = step_dir / rel
        if not p.is_file():
            problems.append(f"missing file {rel}")
            continue
        size = p.stat().st_size
        if size != want["bytes"]:
            problems.append(f"{rel}: size {size} != manifest {want['bytes']}")
            continue
        if _sha256(p) != want["sha256"]:
            problems.append(f"{rel}: checksum mismatch")
    return ("corrupt", problems) if problems else ("intact", [])


def list_steps(checkpoint_dir: str | Path) -> list[int]:
    """Step numbers under a checkpoint dir (numeric child dirs), ascending."""
    root = Path(checkpoint_dir)
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir() if p.is_dir() and p.name.isdigit())


def verify_checkpoint_dir(checkpoint_dir: str | Path) -> list[dict]:
    """Per-step verification report, newest first."""
    root = Path(checkpoint_dir)
    report = []
    for step in sorted(list_steps(root), reverse=True):
        status, problems = verify_step(root / str(step))
        report.append({"step": step, "status": status, "problems": problems})
    return report


def quarantine_step(step_dir: str | Path) -> Path | None:
    """Rename a corrupt/unusable step dir aside (``<step>.corrupt[-N]``).

    Leaving a skipped step in place would keep it the latest step: a
    resumed run re-reaching that step number would find it already there.
    Renaming (not deleting) keeps the bytes for forensics while freeing
    the step number. Returns the new path, or None if the rename failed
    (logged).
    """
    step_dir = Path(step_dir)
    target = step_dir.with_name(step_dir.name + ".corrupt")
    n = 0
    while target.exists():
        n += 1
        target = step_dir.with_name(f"{step_dir.name}.corrupt-{n}")
    try:
        step_dir.rename(target)
    except OSError as e:
        log.warning("could not quarantine %s: %s", step_dir, e)
        return None
    log.warning("quarantined corrupt checkpoint step: %s -> %s", step_dir.name, target.name)
    return target


def record_fallback(step, reason: str) -> None:
    """Log + meter one skipped-corrupt-step event on the restore path."""
    telemetry.counter(
        "checkpoint_fallback_total",
        "restores that skipped a corrupt checkpoint step",
    ).inc()
    log.warning("checkpoint step %s unusable (%s); falling back to an older step", step, reason)
