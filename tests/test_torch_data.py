"""The port's data path vs the JAX package's: the same Delta table gives the
same batches.

A table of synthetic JPEGs is written once; the JAX reader and the port's
reader (both transforms on ``backend="pil"``) read it with the same
settings, one decode worker so the row-group order is exact, with row
groups shuffled and not, across two epochs. Images and labels must be
equal, bit for bit. The port's generator, Delta log, shard assignment,
decode-backend resolution and CPU feeder are checked on their own as well
(the native decoder against the JAX package's in ``test_torch_native.py``).
"""

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from dss_ml_at_scale_tpu.data import DeltaTable as JaxDeltaTable
from dss_ml_at_scale_tpu.data import batch_loader as jax_batch_loader
from dss_ml_at_scale_tpu.data.sharding import list_row_groups as jax_list_row_groups
from dss_ml_at_scale_tpu.data.sharding import shard_units as jax_shard_units
from dss_ml_at_scale_tpu.data.transform import imagenet_transform_spec as jax_spec
from dss_ml_at_scale_tpu.datagen.images import write_image_delta as jax_write_images
from dss_ml_at_scale_tpu_torch.data import (
    DeltaTable,
    Feeder,
    batch_loader,
    imagenet_transform_spec,
    list_row_groups,
    shard_units,
)
from dss_ml_at_scale_tpu_torch.datagen import write_image_delta


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = tmp_path_factory.mktemp("images") / "t"
    write_image_delta(path, 40, classes=5, size=48, seed=3, max_rows_per_file=8)
    return str(path)


def _batches(loader, spec, table, shuffle, seed=7, n=12):
    with loader(table, batch_size=6, num_epochs=2, workers_count=1, transform_spec=spec,
                shuffle_row_groups=shuffle, seed=seed) as reader:
        return [b for b, _ in zip(reader, range(n))]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_readers_yield_the_same_batches(table, shuffle, dtype):
    kw = dict(crop=32, resize=40, output_dtype=dtype)
    want = _batches(jax_batch_loader, jax_spec(backend="pil", **kw), table, shuffle)
    got = _batches(batch_loader, imagenet_transform_spec(backend="pil", **kw), table, shuffle)
    assert len(got) == len(want) == 12  # 40 rows, batches of 6, over two epochs
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "label"}
        assert g["image"].dtype == w["image"].dtype
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_shuffle_changes_the_order(table):
    spec = imagenet_transform_spec(crop=32, resize=40)
    a = _batches(batch_loader, spec, table, True)
    b = _batches(batch_loader, spec, table, False)
    assert not all(np.array_equal(x["label"], y["label"]) for x, y in zip(a, b))


def test_generator_and_delta_log_match_jax(tmp_path):
    write_image_delta(tmp_path / "port", 20, classes=4, size=32, seed=5)
    jax_write_images(tmp_path / "jax", 20, classes=4, size=32, seed=5)
    port, ref = DeltaTable(tmp_path / "port"), JaxDeltaTable(tmp_path / "jax")
    assert port.num_records() == ref.num_records() == 20
    rows = [pq.read_table(t.file_uris()).to_pydict() for t in (port, ref)]
    assert rows[0] == rows[1]  # same JPEG bytes and labels from one seed


def test_auto_backend_is_pil_and_native_waits(monkeypatch):
    """auto is native where the C++ pool builds and PIL where it does not;
    an explicit native that cannot build raises with the reason and never
    runs PIL instead."""
    from dss_ml_at_scale_tpu_torch import native

    assert imagenet_transform_spec().backend == ("native" if native.native_available() else "pil")
    assert imagenet_transform_spec(backend="pil").backend == "pil"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", "native image pipeline unavailable: no g++")
    assert imagenet_transform_spec().backend == "pil"
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        imagenet_transform_spec(backend="native")


def test_shard_assignment_matches_jax(table):
    paths = DeltaTable(table).file_uris()
    units, ref_units = list_row_groups(paths), jax_list_row_groups(paths)
    assert [(u.path, u.row_group, u.num_rows) for u in units] == [
        (u.path, u.row_group, u.num_rows) for u in ref_units]
    for epoch in range(3):
        for shard in range(2):
            got = shard_units(units, shard, 2, epoch=epoch, seed=11)
            want = jax_shard_units(ref_units, shard, 2, epoch=epoch, seed=11)
            assert [(u.path, u.row_group) for u in got] == [(u.path, u.row_group) for u in want]


def test_cpu_feeder_keeps_order_and_surfaces_errors():
    source = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    with Feeder(source, "cpu", depth=2) as feeder:
        got = [int(b["x"][0, 0]) for b, _ in feeder]
    assert got == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) and prov is None
               for b, prov in Feeder(source[:1], "cpu"))

    def broken():
        yield {"x": np.zeros(1)}
        raise OSError("disk gone")

    feeder = Feeder(broken(), "cpu")
    next(feeder)
    with pytest.raises(OSError, match="disk gone"):
        next(feeder)
    feeder.close()
    feeder.close()  # idempotent
