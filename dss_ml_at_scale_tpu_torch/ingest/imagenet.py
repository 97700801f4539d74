"""ImageNet-style ingestion: image tree -> Delta table of binary rows.

Port of ``dss_ml_at_scale_tpu/ingest/imagenet.py``, which rebuilds the
reference's ``deep_learning/1.data-preparation.py`` without Spark: a
threaded parallel copy (``copy_parallel``), a recursive binary-file scan
(the ``binaryFile`` reader), XML annotation -> JSON and label extraction
(stdlib ``xml.etree`` in place of xmltodict, in the same
``{"annotation": {"object": ...}}`` shape), stable monotonic ``id``s (the
``zipWithIndex`` trick) and an uncompressed-parquet Delta write through the
port's :mod:`..data.delta`. The table is the JAX package's, column for
column, and each package's reader reads the other's. Plain host code: no
device is involved.
"""

from __future__ import annotations

import json
import os
import shutil
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Sequence

import pyarrow as pa

from .. import telemetry
from ..data.delta import DeltaTable, write_delta

SCHEMA = pa.schema([
    ("path", pa.string()),
    ("modificationTime", pa.int64()),
    ("length", pa.int64()),
    ("content", pa.binary()),
    ("annotation", pa.string()),
    ("object_id", pa.string()),
    ("label_index", pa.int64()),
    ("id", pa.int64()),
])


def copy_parallel(src: str | os.PathLike, dest: str | os.PathLike, file_pattern: str = "*",
                  n_workers: int = 100) -> int:
    """Threaded recursive copy; returns the number of files copied.

    Keeps the relative directory layout under ``dest`` (an ImageNet tree
    has one directory per wnid with file names repeated across them, so
    flattening would drop copies).
    """
    src, dest = Path(src), Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    files = [p for p in sorted(src.rglob(file_pattern)) if p.is_file()]

    def _copy(p: Path) -> None:
        target = dest / p.relative_to(src)
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(p, target)

    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        list(pool.map(_copy, files))
    return len(files)


def scan_binary_files(root: str | os.PathLike, file_pattern: str = "*.JPEG") -> Iterator[dict]:
    """Recursive binary-file scan, one dict per file (path, modificationTime
    in ms, length, content), in sorted path order. A generator, so a large
    tree streams through bounded memory."""
    for p in sorted(Path(root).rglob(file_pattern)):
        stat = p.stat()
        yield {
            "path": str(p),
            "modificationTime": int(stat.st_mtime * 1000),
            "length": stat.st_size,
            "content": p.read_bytes(),
        }


def _etree_to_dict(node: ET.Element):
    """xmltodict-shaped dict: a leaf is its text, repeated children a list."""
    children = list(node)
    if not children:
        return node.text
    out: dict = {}
    for child in children:
        val = _etree_to_dict(child)
        if child.tag in out:
            if not isinstance(out[child.tag], list):
                out[child.tag] = [out[child.tag]]
            out[child.tag].append(val)
        else:
            out[child.tag] = val
    return out


def xml_annotation_to_json(img_path: str, data_dir: str = "Data",
                           annotations_dir: str = "Annotations") -> str:
    """JSON annotation of an image path: the sibling ``Annotations`` tree
    holds one ``.xml`` per ``.JPEG``; a missing file gives ``"{}"``."""
    xml_path = Path(img_path.replace(f"/{data_dir}/", f"/{annotations_dir}/")
                    .replace(".JPEG", ".xml"))
    if not xml_path.exists():
        return "{}"
    root = ET.parse(xml_path).getroot()
    return json.dumps({root.tag: _etree_to_dict(root)})


def extract_object(annotation_json: str) -> str | None:
    """The first object's label of an annotation, or None."""
    objects = json.loads(annotation_json).get("annotation", {}).get("object")
    if objects is None:
        return None
    if isinstance(objects, dict):
        return objects.get("name")
    return objects[0].get("name")


def object_id_from_path(path: str) -> str:
    """Train-split label from the file name: ``n02007558_10693.JPEG`` ->
    ``n02007558``."""
    return Path(path).name.split("_")[0]


def _next_id(table_path) -> int:
    """The id after the largest in an existing table, from the parquet
    footers' statistics (no data page read; a file without them has its id
    column read). Refuses a table ingested before ``label_index`` existed:
    mixing schemas would break every whole-table read mid-epoch."""
    import pyarrow.parquet as pq

    uris = DeltaTable(table_path).file_uris()
    if uris and "label_index" not in set(pq.ParquetFile(uris[0]).schema_arrow.names):
        raise ValueError(
            f"{table_path} was ingested by an older version without the label_index "
            "column; re-ingest it (mode='overwrite') before appending")
    id_start = 0
    for uri in uris:
        meta = pq.ParquetFile(uri).metadata
        col = meta.schema.to_arrow_schema().get_field_index("id")
        for rg in range(meta.num_row_groups):
            stats = meta.row_group(rg).column(col).statistics
            if stats is not None and stats.has_min_max:
                id_start = max(id_start, stats.max + 1)
            else:
                ids = pq.read_table(uri, columns=["id"])["id"]
                if len(ids):
                    id_start = max(id_start, int(ids.to_numpy().max()) + 1)
                break
    return id_start


def ingest_image_dataset(
    data_root: str | os.PathLike,
    table_path: str | os.PathLike,
    *,
    file_pattern: str = "*.JPEG",
    label_from: str = "path",
    annotations_dir: str = "Annotations",
    data_dir: str = "Data",
    rows_per_fragment: int = 1024,
    mode: str = "overwrite",
    on_missing_label: str = "error",
) -> DeltaTable:
    """Scan -> annotate -> label -> write Delta with a stable ``id`` column.

    Streams in fragments of ``rows_per_fragment`` rows, so the content
    bytes never all sit in memory; ids are contiguous across fragments and,
    with ``mode="append"``, continue the existing table's. ``label_from``
    is the reference's two splits: ``"path"`` (train, the label parsed from
    the file name) or ``"annotation"`` (val, from the XML). Each new
    ``object_id`` gets the next ``label_index`` on first encounter, in the
    scan's sorted order; the vocabulary is kept as ``labels.json`` beside
    the table (an append reloads and extends it, renumbering nothing).

    A row whose label cannot be determined raises by default, since a
    silent sentinel would corrupt the training loss downstream;
    ``on_missing_label="keep"`` ingests it with ``label_index=-1``.
    """
    if label_from not in ("path", "annotation"):
        raise ValueError(f"label_from must be 'path' or 'annotation', got {label_from!r}")
    if on_missing_label not in ("error", "keep"):
        raise ValueError(f"on_missing_label must be 'error' or 'keep', got {on_missing_label!r}")
    appending = mode == "append" and Path(table_path, "_delta_log").exists()
    id_start = _next_id(table_path) if appending else 0
    vocab: dict[str, int] = {}
    labels_path = Path(table_path) / "labels.json"
    if mode == "append" and labels_path.exists():
        vocab = json.loads(labels_path.read_text())

    def rows() -> Iterator[dict]:
        for i, rec in enumerate(scan_binary_files(data_root, file_pattern), start=id_start):
            ann = xml_annotation_to_json(rec["path"], data_dir, annotations_dir)
            rec["annotation"] = ann
            rec["object_id"] = (object_id_from_path(rec["path"]) if label_from == "path"
                                else extract_object(ann))
            if rec["object_id"] is None:
                if on_missing_label == "error":
                    raise ValueError(
                        f"no label for {rec['path']} (label_from={label_from!r}); fix the "
                        "annotation or pass on_missing_label='keep' to ingest it with "
                        "label_index=-1")
                rec["label_index"] = -1
            else:
                rec["label_index"] = vocab.setdefault(rec["object_id"], len(vocab))
            rec["id"] = i
            yield rec

    rows_total = telemetry.counter("ingest_rows_total", "rows written by ingest_image_dataset")
    bytes_total = telemetry.counter("ingest_bytes_total",
                                    "content bytes written by ingest_image_dataset")

    def flush(batch: Sequence[dict], first: bool) -> None:
        write_delta(pa.Table.from_pylist(list(batch), schema=SCHEMA), table_path,
                    mode=mode if first else "append")
        rows_total.inc(len(batch))
        bytes_total.inc(sum(r["length"] for r in batch))

    written = False
    batch: list[dict] = []
    with telemetry.span("ingest", root=str(data_root)):
        for rec in rows():
            batch.append(rec)
            if len(batch) >= rows_per_fragment:
                flush(batch, not written)
                written = True
                batch = []
        if batch or not written:
            flush(batch, not written)
    labels_path.write_text(json.dumps(vocab))
    return DeltaTable(table_path)
