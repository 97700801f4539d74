"""Minimal Delta-Lake transaction-log reader and writer (no Spark, no JVM).

Port copy of ``dss_ml_at_scale_tpu/data/delta.py`` (pure Python over
pyarrow; the port keeps its own copy and imports nothing of the JAX
package).

The reference reads Delta tables two ways: through Spark
(``spark.read.format("delta")``) and — for the training data path, to avoid
the JVM entirely — through deltalake-rs:
``DeltaTable(path).file_uris()`` for the physical Parquet file list and
``get_add_actions()`` for per-file ``num_records`` stats (reference
``deep_learning/2.distributed-data-loading-petastorm.py:99-112``). The row
counts feed steps-per-epoch; the file list feeds the sharded reader.

Since the Delta log is just JSON-lines commits plus optional Parquet
checkpoints, a small pure-Python reader (over pyarrow for checkpoints)
covers the capability. The writer emits spec-compliant commits with
``numRecords`` stats so tables round-trip through real Delta readers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import uuid
from pathlib import Path
from typing import Iterable, Mapping

import pyarrow as pa
import pyarrow.parquet as pq

_LOG_DIR = "_delta_log"


@dataclasses.dataclass(frozen=True)
class AddAction:
    path: str
    size: int
    num_records: int | None
    partition_values: Mapping[str, str]


class DeltaTable:
    """Read-side view of a Delta table's latest snapshot."""

    def __init__(self, table_path: str | os.PathLike):
        self.path = Path(table_path)
        log_dir = self.path / _LOG_DIR
        if not log_dir.is_dir():
            raise FileNotFoundError(f"not a Delta table (no {_LOG_DIR}): {self.path}")
        self._adds, self._version, self._metadata = self._replay(log_dir)

    # -- snapshot construction -------------------------------------------

    def _replay(self, log_dir: Path):
        adds: dict[str, AddAction] = {}
        metadata: dict = {}
        start_version = 0

        ckpt_version = self._last_checkpoint_version(log_dir)
        if ckpt_version is not None:
            for action in self._read_checkpoint(log_dir, ckpt_version):
                self._apply(action, adds, metadata)
            start_version = ckpt_version + 1

        versions = sorted(
            int(p.stem)
            for p in log_dir.glob("*.json")
            if p.stem.isdigit() and int(p.stem) >= start_version
        )
        for v in versions:
            commit = log_dir / f"{v:020d}.json"
            with open(commit, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._apply(json.loads(line), adds, metadata)
        version = versions[-1] if versions else (ckpt_version or 0)
        return adds, version, metadata

    @staticmethod
    def _last_checkpoint_version(log_dir: Path) -> int | None:
        marker = log_dir / "_last_checkpoint"
        if not marker.exists():
            return None
        return int(json.loads(marker.read_text())["version"])

    @staticmethod
    def _read_checkpoint(log_dir: Path, version: int) -> Iterable[dict]:
        # Single-part checkpoints only (multi-part is a large-table
        # optimization this framework's writer never produces).
        ckpt = log_dir / f"{version:020d}.checkpoint.parquet"
        table = pq.read_table(ckpt)
        for row in table.to_pylist():
            for key in ("add", "remove", "metaData", "protocol"):
                if row.get(key) is not None:
                    yield {key: row[key]}

    @staticmethod
    def _apply(action: dict, adds: dict, metadata: dict) -> None:
        if "add" in action and action["add"] is not None:
            a = action["add"]
            stats = a.get("stats")
            num_records = None
            if stats:
                if isinstance(stats, str):
                    stats = json.loads(stats)
                num_records = stats.get("numRecords")
            adds[a["path"]] = AddAction(
                path=a["path"],
                size=a.get("size", 0),
                num_records=num_records,
                partition_values=a.get("partitionValues", {}) or {},
            )
        elif "remove" in action and action["remove"] is not None:
            adds.pop(action["remove"]["path"], None)
        elif "metaData" in action and action["metaData"] is not None:
            metadata.update(action["metaData"])

    # -- public surface (parity with deltalake usage in the reference) ---

    def file_uris(self) -> list[str]:
        """Absolute paths of the parquet files in the current snapshot."""
        return [str(self.path / a.path) for a in self._sorted_adds()]

    def get_add_actions(self) -> list[AddAction]:
        return self._sorted_adds()

    def num_records(self) -> int:
        """Total rows from add-action stats (the steps-per-epoch input)."""
        total = 0
        for a in self._adds.values():
            if a.num_records is None:
                raise ValueError(f"add action for {a.path} carries no numRecords stats")
            total += a.num_records
        return total

    def version(self) -> int:
        return self._version

    def schema_json(self) -> dict | None:
        raw = self._metadata.get("schemaString")
        return json.loads(raw) if raw else None

    def _sorted_adds(self) -> list[AddAction]:
        return sorted(self._adds.values(), key=lambda a: a.path)


def write_delta(
    table: pa.Table,
    table_path: str | os.PathLike,
    *,
    mode: str = "error",
    max_rows_per_file: int | None = None,
    compression: str = "none",
) -> DeltaTable:
    """Write an Arrow table as a Delta table (parquet files + JSON log).

    Defaults mirror the reference's ingestion choices: uncompressed parquet
    (``deep_learning/1.data-preparation.py:191,200`` sets
    ``parquet.compression.codec=uncompressed`` so the training-path reader
    spends no CPU on decompression — JPEG bytes don't compress anyway).

    ``mode``: "error" | "overwrite" | "append".
    """
    if mode not in ("error", "overwrite", "append"):
        raise ValueError(f"mode must be 'error', 'overwrite' or 'append', got {mode!r}")
    path = Path(table_path)
    log_dir = path / _LOG_DIR
    exists = log_dir.is_dir()
    if exists and mode == "error":
        raise FileExistsError(f"Delta table already exists: {path}")
    path.mkdir(parents=True, exist_ok=True)
    log_dir.mkdir(exist_ok=True)

    actions: list[dict] = []
    next_version = 0
    if exists and mode in ("overwrite", "append"):
        prior = DeltaTable(path)
        next_version = prior.version() + 1
        if mode == "overwrite":
            actions += [
                {"remove": {"path": a.path, "deletionTimestamp": 0, "dataChange": True}}
                for a in prior.get_add_actions()
            ]
    if next_version == 0:
        actions.append({"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}})
    if next_version == 0 or mode == "overwrite":
        # Overwrites refresh the schema too — the new snapshot must
        # describe the new files, not the replaced table's.
        actions.append(
            {
                "metaData": {
                    "id": str(uuid.uuid4()),
                    "format": {"provider": "parquet", "options": {}},
                    "schemaString": json.dumps(_arrow_schema_to_delta(table.schema)),
                    "partitionColumns": [],
                    "configuration": {},
                    "createdTime": 0,
                }
            }
        )

    chunks = (
        [table]
        if not max_rows_per_file
        else [
            table.slice(i, max_rows_per_file)
            for i in range(0, len(table), max_rows_per_file)
        ]
    )
    for chunk in chunks:
        fname = f"part-{uuid.uuid4().hex}.parquet"
        fpath = path / fname
        pq.write_table(chunk, fpath, compression=compression)
        actions.append(
            {
                "add": {
                    "path": fname,
                    "partitionValues": {},
                    "size": fpath.stat().st_size,
                    "modificationTime": 0,
                    "dataChange": True,
                    "stats": json.dumps({"numRecords": len(chunk)}),
                }
            }
        )

    commit = log_dir / f"{next_version:020d}.json"
    with open(commit, "w", encoding="utf-8") as f:
        for action in actions:
            f.write(json.dumps(action) + "\n")
    return DeltaTable(path)


_ARROW_TO_DELTA = {
    pa.int8(): "byte",
    pa.int16(): "short",
    pa.int32(): "integer",
    pa.int64(): "long",
    pa.float32(): "float",
    pa.float64(): "double",
    pa.bool_(): "boolean",
    pa.string(): "string",
    pa.large_string(): "string",
    pa.binary(): "binary",
    pa.large_binary(): "binary",
    pa.date32(): "date",
}


def _arrow_schema_to_delta(schema: pa.Schema) -> dict:
    fields = []
    for f in schema:
        if isinstance(f.type, pa.TimestampType):
            delta_type = "timestamp"
        else:
            delta_type = _ARROW_TO_DELTA.get(f.type, "string")
        fields.append(
            {"name": f.name, "type": delta_type, "nullable": f.nullable, "metadata": {}}
        )
    return {"type": "struct", "fields": fields}
