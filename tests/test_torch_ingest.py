"""The front of Track A in the port: ``datagen photos`` and ``ingest``
against the JAX package's.

- Photos: the port reads its own copies of the two sample photographs; the
  arrays equal scikit-learn's ``load_sample_image`` bit for bit, and
  ``write_photo_tree`` writes the same file names and JPEG bytes as JAX's.
- Ingest: on one seeded tree (the train split labelled by path, the val
  split by XML annotation, a missing label under ``error`` and ``keep``,
  an ``append``) the port's table equals JAX's row for row and column for
  column, ``labels.json`` too, and each package's reader reads the other's
  table. Twins of ``tests/test_ingest.py``.
- The CLI: ``datagen photos`` -> ``ingest`` -> ``train`` -> ``predict`` on
  the CPU, prediction labels named from the checkpoint.
"""

import io
import json
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from PIL import Image

from dss_ml_at_scale_tpu.data import DeltaTable as JaxDeltaTable
from dss_ml_at_scale_tpu.datagen import photos as jax_photos
from dss_ml_at_scale_tpu.ingest import ingest_image_dataset as jax_ingest
from dss_ml_at_scale_tpu_torch.config.cli import main
from dss_ml_at_scale_tpu_torch.data.delta import DeltaTable
from dss_ml_at_scale_tpu_torch.datagen import photos
from dss_ml_at_scale_tpu_torch.ingest import (
    copy_parallel,
    extract_object,
    ingest_image_dataset,
    object_id_from_path,
    xml_annotation_to_json,
)

_XML = """<annotation>
  <folder>val</folder>
  <filename>{name}</filename>
  <object><name>{label}</name><bndbox><xmin>1</xmin></bndbox></object>
  <object><name>other</name><bndbox><xmin>2</xmin></bndbox></object>
</annotation>"""


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """Data/<wnid>/<wnid>_<i>.JPEG and a parallel Annotations tree, seeded."""
    root = tmp_path_factory.mktemp("ilsvrc")
    rng = np.random.default_rng(0)
    for wnid in ("n01440764", "n02007558"):
        ddir, adir = root / "Data" / wnid, root / "Annotations" / wnid
        ddir.mkdir(parents=True)
        adir.mkdir(parents=True)
        for i in range(6):
            name = f"{wnid}_{i}"
            Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
                ddir / f"{name}.JPEG", format="JPEG")
            (adir / f"{name}.xml").write_text(_XML.format(name=name, label=wnid))
    return root


def _table(uris) -> pa.Table:
    return pa.concat_tables([pq.read_table(u) for u in uris]).sort_by("id")


def _equal_tables(port_path, jax_path):
    """Row for row and column for column (modification times are the
    files', so equal too), and labels.json equal."""
    got, want = _table(DeltaTable(port_path).file_uris()), _table(JaxDeltaTable(jax_path).file_uris())
    assert got.schema == want.schema
    assert got.equals(want)
    assert (json.loads((port_path / "labels.json").read_text())
            == json.loads((jax_path / "labels.json").read_text()))
    return got


# -- photos -------------------------------------------------------------------

def test_source_photos_equal_sklearn_sample_images():
    from sklearn.datasets import load_sample_image

    for name, arr in photos._source_photos().items():
        want = load_sample_image(f"{name}.jpg")
        assert arr.dtype == want.dtype and arr.shape == want.shape == (427, 640, 3)
        assert np.array_equal(arr, want), name
    assert (photos.PHOTO_DIR / "README.txt").read_text().count("creativecommons.org/licenses/by/2.0") == 2


def test_photo_tree_equals_jax(tmp_path):
    assert photos.write_photo_tree(tmp_path / "port", 24, size=96, seed=3) == 24
    jax_photos.write_photo_tree(tmp_path / "jax", 24, size=96, seed=3)
    got = sorted((tmp_path / "port" / "Data").glob("*.JPEG"))
    want = sorted((tmp_path / "jax" / "Data").glob("*.JPEG"))
    assert [p.name for p in got] == [p.name for p in want]
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(got, want))
    with Image.open(got[0]) as im:
        assert im.size == (96, 96)


def test_photo_tree_overwrites_and_refuses_a_crop_too_large(tmp_path):
    photos.write_photo_tree(tmp_path, 6, size=48)
    photos.write_photo_tree(tmp_path, 2, size=48)
    assert len(list((tmp_path / "Data").glob("*.JPEG"))) == 2
    with pytest.raises(ValueError, match="too large"):
        photos.write_photo_tree(tmp_path, 1, size=427)


# -- ingest against JAX's --------------------------------------------------------

@pytest.mark.parametrize("label_from", ["path", "annotation"])
def test_ingested_table_equals_jax(image_tree, tmp_path, label_from):
    port = ingest_image_dataset(image_tree / "Data", tmp_path / "port", label_from=label_from,
                                rows_per_fragment=5)
    jax_ingest(image_tree / "Data", tmp_path / "jax", label_from=label_from, rows_per_fragment=5)
    full = _equal_tables(tmp_path / "port", tmp_path / "jax")
    assert len(port.file_uris()) == 3  # 5 + 5 + 2
    assert full["id"].to_pylist() == list(range(12))
    assert set(full["object_id"].to_pylist()) == {"n01440764", "n02007558"}


def test_missing_label_under_error_and_keep_equals_jax(image_tree, tmp_path):
    extra = image_tree / "Data" / "n01440764" / "n01440764_noann.JPEG"
    extra.write_bytes((image_tree / "Data" / "n01440764" / "n01440764_0.JPEG").read_bytes())
    try:
        for fn, name in ((ingest_image_dataset, "port"), (jax_ingest, "jax")):
            with pytest.raises(ValueError, match="no label for"):
                fn(image_tree / "Data", tmp_path / f"e_{name}", label_from="annotation")
            fn(image_tree / "Data", tmp_path / name, label_from="annotation",
               on_missing_label="keep")
        full = _equal_tables(tmp_path / "port", tmp_path / "jax")
        by_path = dict(zip(full["path"].to_pylist(), full["label_index"].to_pylist()))
        assert by_path[str(extra)] == -1
        assert {v for k, v in by_path.items() if k != str(extra)} == {0, 1}
    finally:
        extra.unlink()  # the fixture is module-scoped: leave it as found


def test_append_equals_jax_and_each_reader_reads_the_other(image_tree, tmp_path):
    for fn, name in ((ingest_image_dataset, "port"), (jax_ingest, "jax")):
        fn(image_tree / "Data" / "n01440764", tmp_path / name, rows_per_fragment=4)
        fn(image_tree / "Data" / "n02007558", tmp_path / name, mode="append", rows_per_fragment=4)
    full = _equal_tables(tmp_path / "port", tmp_path / "jax")
    assert full["id"].to_pylist() == list(range(12))
    from dss_ml_at_scale_tpu.data import make_batch_reader as jax_reader
    from dss_ml_at_scale_tpu_torch.data.reader import batch_loader

    kw = dict(batch_size=4, columns=["content", "id"], num_epochs=1, workers_count=1)
    with jax_reader(JaxDeltaTable(tmp_path / "port"), **kw) as r:  # JAX reads the port's
        assert sorted(int(i) for b in r for i in b["id"]) == list(range(12))
    with batch_loader(tmp_path / "jax", batch_size=4, num_epochs=1, workers_count=1,
                      drop_last=False) as r:  # the port reads JAX's
        assert sorted(int(i) for b in r for i in b["id"]) == list(range(12))


# -- twins of tests/test_ingest.py ---------------------------------------------

def test_copy_parallel(image_tree, tmp_path):
    assert copy_parallel(image_tree / "Data", tmp_path / "out", "*.JPEG", n_workers=4) == 12
    assert len(list((tmp_path / "out").rglob("*.JPEG"))) == 12
    assert (tmp_path / "out" / "n01440764" / "n01440764_0.JPEG").exists()
    assert copy_parallel(image_tree / "Data", tmp_path / "out2") == 12  # directories skipped


def test_annotation_extraction(image_tree):
    img = str(image_tree / "Data" / "n01440764" / "n01440764_0.JPEG")
    ann = xml_annotation_to_json(img)
    assert json.loads(ann)["annotation"]["filename"] == "n01440764_0"
    assert extract_object(ann) == "n01440764"  # two <object>s: the first's name
    assert object_id_from_path(img) == "n01440764"
    assert xml_annotation_to_json("/nope/Data/missing.JPEG") == "{}"
    assert extract_object("{}") is None


def test_ingest_train_split_bytes_decode(image_tree, tmp_path):
    table = ingest_image_dataset(image_tree / "Data", tmp_path / "t", rows_per_fragment=5)
    assert table.num_records() == 12
    full = _table(table.file_uris())
    with Image.open(io.BytesIO(full["content"][0].as_py())) as im:
        assert im.size == (32, 32)


def test_ingest_append_rejects_pre_label_index_tables(image_tree, tmp_path):
    table = ingest_image_dataset(image_tree / "Data", tmp_path / "old")
    for uri in table.file_uris():
        pq.write_table(pq.read_table(uri).drop_columns(["label_index"]), uri)
    with pytest.raises(ValueError, match="older version"):
        ingest_image_dataset(image_tree / "Data", tmp_path / "old", mode="append")


def test_ingest_append_continues_label_vocabulary(image_tree, tmp_path):
    path = tmp_path / "grow"
    ingest_image_dataset(image_tree / "Data", path)
    vocab1 = json.loads((path / "labels.json").read_text())
    extra = tmp_path / "extra" / "Data" / "n99999999"
    extra.mkdir(parents=True)
    shutil.copy(image_tree / "Data" / "n01440764" / "n01440764_0.JPEG", extra / "n99999999_0.JPEG")
    table = ingest_image_dataset(tmp_path / "extra" / "Data", path, mode="append")
    vocab2 = json.loads((path / "labels.json").read_text())
    assert all(vocab2[k] == v for k, v in vocab1.items())  # no renumbering
    assert vocab2["n99999999"] == len(vocab1)
    full = _table(table.file_uris())
    assert full["id"].to_pylist() == list(range(13))
    by_object = dict(zip(full["object_id"].to_pylist(), full["label_index"].to_pylist()))
    assert by_object["n99999999"] == len(vocab1)


def test_ingest_counts_rows_and_bytes_in_a_span(image_tree, tmp_path):
    from dss_ml_at_scale_tpu_torch import telemetry

    def value(name):
        return sum(m["value"] for m in telemetry.snapshot()["metrics"] if m["name"] == name)

    rows0, bytes0 = value("ingest_rows_total"), value("ingest_bytes_total")
    n_spans = sum(e.get("name") == "ingest" for e in telemetry.get_span_log().events())
    ingest_image_dataset(image_tree / "Data", tmp_path / "c")
    assert value("ingest_rows_total") - rows0 == 12
    size = sum(p.stat().st_size for p in (image_tree / "Data").rglob("*.JPEG"))
    assert value("ingest_bytes_total") - bytes0 == size
    assert sum(e.get("name") == "ingest" for e in telemetry.get_span_log().events()) == n_spans + 1


def test_ingest_refuses_unknown_modes(image_tree, tmp_path):
    with pytest.raises(ValueError, match="label_from"):
        ingest_image_dataset(image_tree / "Data", tmp_path / "x", label_from="name")
    with pytest.raises(ValueError, match="on_missing_label"):
        ingest_image_dataset(image_tree / "Data", tmp_path / "x", on_missing_label="drop")


# -- the CLI ------------------------------------------------------------------

def test_photos_ingest_train_predict_cli(tmp_path, capsys):
    raw, table = tmp_path / "raw", tmp_path / "table"
    assert main(["datagen", "photos", "--out", str(raw), "--n", "12", "--size", "48"]) == 0
    assert "photos: 12 real-photo JPEG crops, 2 classes, 48px" in capsys.readouterr().out
    assert main(["ingest", "--data-root", str(raw), "--out", str(table),
                 "--rows-per-fragment", "4"]) == 0
    assert "ingested 12 rows" in capsys.readouterr().out
    assert json.loads((table / "labels.json").read_text()) == {"china": 0, "flower": 1}
    assert main(["train", "--data", str(table), "--model", "tiny", "--num-classes", "2",
                 "--crop", "32", "--batch-size", "4", "--epochs", "1", "--device", "cpu",
                 "--checkpoint-dir", str(tmp_path / "ckpt"), "--no-tracking"]) == 0
    assert main(["predict", "--data", str(table), "--checkpoint-dir", str(tmp_path / "ckpt"),
                 "--out", str(tmp_path / "preds"), "--batch-size", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    names = json.loads((tmp_path / "ckpt" / "dsst_model.json").read_text())["label_names"]
    assert sorted(names) == ["china", "flower"]
    preds = pa.concat_tables(pq.read_table(u)
                             for u in DeltaTable(tmp_path / "preds").file_uris()).to_pylist()
    assert len(preds) == 12
    assert all(r["pred_label"] == names[r["pred_index"]] for r in preds)
    assert "accuracy_vs_label_index" in out
