"""The reader's decode-pipeline series on the port: ``reader_queue_depth``
(gauge) and ``reader_stall_seconds_total`` (counter), as
``dss_ml_at_scale_tpu/data/reader.py`` emits them.

A CPU ``train`` run writes them to its run's ``telemetry.json``; a reader
iterated on its own moves them; and both packages declare them alike.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from dss_ml_at_scale_tpu.telemetry import catalog as jax_catalog
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.telemetry import catalog, flightrec

NAMES = {"reader_queue_depth": "gauge", "reader_stall_seconds_total": "counter"}


def _metrics(snapshot: dict) -> dict:
    return {m["name"]: m for m in snapshot["metrics"] if not m.get("labels")}


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    from dss_ml_at_scale_tpu_torch.datagen.images import write_image_delta

    work = tmp_path_factory.mktemp("reader_metrics")
    write_image_delta(work / "data", 32, classes=4, size=32, seed=0, mode="overwrite",
                      max_rows_per_file=8)
    return work


def test_both_packages_declare_the_reader_series_alike():
    for name, kind in NAMES.items():
        assert catalog.KNOWN_METRICS[name] == jax_catalog.KNOWN_METRICS[name] == kind


def test_a_cpu_train_run_writes_them_to_its_telemetry_json(table):
    telemetry.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["train", "--data", str(table / "data"), "--model", "tiny",
                   "--num-classes", "4", "--crop", "32", "--batch-size", "8",
                   "--epochs", "1", "--workers", "1", "--no-shuffle",
                   "--tracking-root", str(table / "runs"), "--device", "cpu"])
    flightrec.disable()
    assert rc == 0, out.getvalue()
    run_dir = next((table / "runs" / "imagenet").iterdir())
    snap = _metrics(json.loads((run_dir / "telemetry.json").read_text()))
    assert snap["reader_queue_depth"]["type"] == "gauge"
    assert snap["reader_queue_depth"]["value"] >= 0
    assert snap["reader_stall_seconds_total"]["type"] == "counter"
    assert snap["reader_stall_seconds_total"]["value"] > 0
    telemetry.reset()


def test_a_reader_alone_moves_them(table):
    from dss_ml_at_scale_tpu_torch.data import DeltaTable
    from dss_ml_at_scale_tpu_torch.data.reader import ParquetShardReader

    telemetry.reset()
    reader = ParquetShardReader(DeltaTable(str(table / "data")).file_uris(), batch_size=8,
                                workers_count=2, results_queue_size=2, num_epochs=1)
    with reader:
        batches = list(reader)
    assert len(batches) == 4
    snap = _metrics(telemetry.snapshot())
    assert snap["reader_stall_seconds_total"]["value"] > 0
    assert 0 <= snap["reader_queue_depth"]["value"] <= 2
    telemetry.reset()
