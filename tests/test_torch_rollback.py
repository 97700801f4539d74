"""Quarantine, the resilient reader and the rollback/abort rungs of the
port vs the JAX package (``resilience/rollback.py``, ``data/reader.py``,
``parallel/trainer.py``; ``tests/test_health.py``, ``tests/test_reader.py``).

- A ``quarantine.jsonl`` either package writes, the other reads, with the
  same keep masks.
- On the same Delta table, with a blocklist, ``on_corrupt="quarantine"``
  and a ``sample.corrupt`` fault, the port's reader yields the JAX
  reader's rows (bit for bit), provenance and quarantine entries.
- ``reader.next=2`` is retried (``retry_total{site="reader.next"}``).
- Under ``rollback`` a fit restores the newest intact step (falling back
  past one whose restore raises), moves newer steps aside, and finishes at
  the clean run's step count; under ``abort``, or with the rollbacks
  spent, it raises with a durable diagnostic bundle.
"""

import json

import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.data import batch_loader as jax_batch_loader
from dss_ml_at_scale_tpu.data.transform import imagenet_transform_spec as jax_spec
from dss_ml_at_scale_tpu.resilience import faults as jax_faults
from dss_ml_at_scale_tpu.resilience.rollback import QuarantineList as JaxQuarantine
from dss_ml_at_scale_tpu.resilience.rollback import RowRange as JaxRowRange
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.data import batch_loader
from dss_ml_at_scale_tpu_torch.data.transform import imagenet_transform_spec
from dss_ml_at_scale_tpu_torch.datagen import write_image_delta
from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, Trainer, TrainerConfig
from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity
from dss_ml_at_scale_tpu_torch.resilience import faults
from dss_ml_at_scale_tpu_torch.resilience.health import HealthConfig, TrainingHealthError
from dss_ml_at_scale_tpu_torch.resilience.rollback import (
    PROVENANCE_KEY,
    QuarantineList,
    RowRange,
    compress_rows,
)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jax_faults.clear()


def _counter(name, **labels):
    for m in telemetry.snapshot()["metrics"]:
        if m["name"] == name and (m.get("labels") or {}) == labels:
            return m["value"]
    return 0.0


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = tmp_path_factory.mktemp("images") / "t"
    write_image_delta(path, 24, classes=3, size=40, seed=4, max_rows_per_file=8)
    return str(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quarantine_files_cross_read(tmp_path, writer):
    path = tmp_path / "quarantine.jsonl"
    ranges = [("/data/a.parquet", 0, 2, 5), ("/data/a.parquet", 0, 9, 10),
              ("/data/b.parquet", 3, 0, 4)]
    if writer == "jax":
        JaxQuarantine(path).add([JaxRowRange(*r) for r in ranges], reason="nonfinite", step=7)
    else:
        QuarantineList(path).add([RowRange(*r) for r in ranges], reason="nonfinite", step=7)
    with open(path, "a") as f:
        f.write('{"path": "/data/c.parq')  # a torn tail both readers skip
    port, ref = QuarantineList(path), JaxQuarantine(path)
    assert port.entries == ref.entries and len(port) == 3
    for p, rg in (("/data/a.parquet", 0), ("/data/b.parquet", 3), ("/data/b.parquet", 1)):
        got, want = port.keep_mask(p, rg, 12), ref.keep_mask(p, rg, 12)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    assert port.clear() == 3 and not path.exists()


def test_compress_rows_is_jaxs():
    from dss_ml_at_scale_tpu.resilience.rollback import compress_rows as jax_compress

    rows = [9, 3, 4, 5, 11, 12, 0]
    assert [r.to_json() for r in compress_rows("p", 2, rows)] == [
        r.to_json() for r in jax_compress("p", 2, rows)]


def _read(loader, spec, table, quarantine):
    with loader(table, batch_size=5, num_epochs=1, workers_count=1, transform_spec=spec,
                shuffle_row_groups=False, quarantine=quarantine, emit_provenance=True,
                on_corrupt="quarantine") as reader:
        return list(reader)


def test_reader_with_quarantine_and_corrupt_samples_is_jaxs(table, tmp_path):
    from dss_ml_at_scale_tpu_torch.data import DeltaTable

    first = DeltaTable(table).file_uris()[0]
    seeds = [RowRange(first, 0, 2, 4)]
    QuarantineList(tmp_path / "port.jsonl").add(seeds, reason="seeded")
    JaxQuarantine(tmp_path / "jax.jsonl").add(
        [JaxRowRange(first, 0, 2, 4)], reason="seeded")
    kw = dict(crop=24, resize=32)
    faults.install_from_spec("sample.corrupt=1@1")
    jax_faults.install_from_spec("sample.corrupt=1@1")
    got = _read(batch_loader, imagenet_transform_spec(backend="pil", **kw), table,
                tmp_path / "port.jsonl")
    want = _read(jax_batch_loader, jax_spec(backend="pil", **kw), table,
                 tmp_path / "jax.jsonl")
    # 24 rows, 2 quarantined, 1 corrupt: 21 rows, 4 batches of 5.
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert [r.to_json() for r in g[PROVENANCE_KEY]] == [
            r.to_json() for r in w[PROVENANCE_KEY]]
    strip = [{k: v for k, v in e.items() if k != "time"}
             for e in QuarantineList(tmp_path / "port.jsonl").entries]
    assert strip == [{k: v for k, v in e.items() if k != "time"}
                     for e in JaxQuarantine(tmp_path / "jax.jsonl").entries]
    assert len(strip) == 2 and "undecodable sample" in strip[1]["reason"]
    rows = {(r["path"], r["row_group"], i) for r in strip for i in range(r["row_lo"], r["row_hi"])}
    seen = {(p.path, p.row_group, i) for b in got for p in b[PROVENANCE_KEY]
            for i in range(p.row_lo, p.row_hi)}
    assert not rows & seen and len(seen) == 20  # the partial tail batch is dropped


def test_transient_read_failures_are_retried(table):
    before = _counter("retry_total", site="reader.next")
    faults.install_from_spec("reader.next=2")
    with batch_loader(table, batch_size=8, num_epochs=1, workers_count=1,
                      shuffle_row_groups=False) as reader:
        batches = list(reader)
    assert len(batches) == 3
    assert _counter("retry_total", site="reader.next") - before == 2
    faults.install_from_spec("reader.next=3")  # past the two retries: the read fails
    with batch_loader(table, batch_size=8, num_epochs=1, workers_count=1) as reader:
        with pytest.raises(RuntimeError, match="reader worker failed"):
            list(reader)


def test_corrupt_sample_raises_without_quarantine(table):
    # A truncated image fails to decode with an OSError, which the read
    # retries twice (as the JAX reader does); the third corrupt read fails.
    faults.install_from_spec("sample.corrupt=3")
    spec = imagenet_transform_spec(backend="pil", crop=24, resize=32)
    with batch_loader(table, batch_size=8, num_epochs=1, workers_count=1,
                      transform_spec=spec) as reader:
        with pytest.raises(RuntimeError, match="reader worker failed"):
            list(reader)


def _task():
    from dss_ml_at_scale_tpu_torch.models.convert import seeded_resnet
    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock

    model = seeded_resnet(0, device="cpu", stage_sizes=[1, 1], num_filters=8,
                          block_cls=BottleneckBlock, num_classes=4, fused_bn="pallas",
                          dtype=torch.float32)
    return ClassifierTask(model=model, learning_rate=1e-2)


def _batches(n, provenance=False):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        b = {"image": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 4, 4).astype(np.int32)}
        if provenance:
            b[PROVENANCE_KEY] = [RowRange("mem://train", i, 0, 4)]
        out.append(b)
    return out


def _fit(batches, health_cfg, **cfg):
    return Trainer(TrainerConfig(log_every_steps=1000, health=health_cfg, **cfg),
                   device="cpu").fit(_task(), iter(batches))


def test_rollback_restores_the_newest_intact_step_and_moves_newer_aside(tmp_path):
    """Two poisoned steps after step 5 escalate (one skip tolerated); the
    restore of step 4 raises, so the run falls back to step 2, moves 4
    aside, and re-runs steps 3-6."""
    ckpt = tmp_path / "ckpt"
    before = _counter("health_rollbacks_total")
    faults.install_from_spec("grads.nonfinite=2@5;checkpoint.restore=1")
    result = _fit(_batches(16), HealthConfig(policy="rollback", max_consecutive_skips=1),
                  max_epochs=3, steps_per_epoch=2, checkpoint_dir=str(ckpt))
    assert result.steps == 6 and result.health_rollbacks == 1 and result.skipped_steps == 2
    assert _counter("health_rollbacks_total") - before == 1
    assert integrity.list_steps(ckpt) == [2, 6] and (ckpt / "4.corrupt").is_dir()
    assert all(r["status"] == "intact" for r in integrity.verify_checkpoint_dir(ckpt))
    assert [h["epoch"] for h in result.history] == [0, 1, 2]


def test_rollback_then_abort_after_the_budget_writes_a_bundle(tmp_path):
    ckpt = tmp_path / "ckpt"
    nf_before = _counter("nonfinite_steps_total")
    faults.install_from_spec("grads.nonfinite=100@4")
    with pytest.raises(TrainingHealthError) as exc_info:
        _fit(_batches(14), HealthConfig(policy="rollback", max_consecutive_skips=1,
                                        max_rollbacks=1),
             max_epochs=3, steps_per_epoch=2, checkpoint_dir=str(ckpt))
    # skip, skip (-> rollback), skip, skip (-> abort): 4 discarded updates.
    assert _counter("nonfinite_steps_total") - nf_before == 4
    assert exc_info.value.bundle_path == str(ckpt / "health_abort_step5.json")
    bundle = json.loads((ckpt / "health_abort_step5.json").read_text())
    assert bundle["rollbacks"] == 1 and bundle["policy"] == "rollback"
    assert bundle["recent_incidents"][-1]["verdict"] == "nonfinite"
    assert bundle["recent_incidents"][-1]["loss"] == "nan"  # strict JSON
    assert bundle["fault_plan_stats"]["grads.nonfinite"]["fired"] == 4
    assert (ckpt / "4").is_dir()


def test_abort_policy_stops_on_the_first_bad_step():
    faults.install_from_spec("grads.nonfinite=1@1")
    with pytest.raises(TrainingHealthError) as exc_info:
        _fit(_batches(6), HealthConfig(policy="abort"), max_epochs=1, steps_per_epoch=4)
    assert exc_info.value.bundle_path is None


def test_rollback_without_a_checkpoint_dir_aborts():
    faults.install_from_spec("grads.nonfinite=100")
    with pytest.raises(TrainingHealthError, match="no checkpoint_dir"):
        _fit(_batches(8), HealthConfig(policy="rollback", max_consecutive_skips=1),
             max_epochs=1, steps_per_epoch=4)


def test_discarded_batch_provenance_is_quarantined(tmp_path):
    q = QuarantineList(tmp_path / "quarantine.jsonl")
    before = _counter("quarantined_batches_total")
    faults.install_from_spec("grads.nonfinite=1@2")
    result = _fit(_batches(6, provenance=True), HealthConfig(policy="skip", quarantine=q),
                  max_epochs=1, steps_per_epoch=4)
    assert result.steps == 4 and result.skipped_steps == 1
    assert _counter("quarantined_batches_total") - before == 1
    entry = QuarantineList(tmp_path / "quarantine.jsonl").entries[0]
    assert entry["row_group"] == 2 and entry["step"] == 3 and "nonfinite" in entry["reason"]
    assert JaxQuarantine(tmp_path / "quarantine.jsonl").entries[0]["row_group"] == 2
