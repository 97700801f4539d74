"""The port's native C++ image pipeline vs the JAX package's, and vs PIL.

The port keeps its own copy of ``image_pipeline.cpp``, built into
``build/native/``. On the same JPEGs it must give the JAX package's native
decoder's bytes exactly (float32, normalized, uint8, CHW, fast scale), and
stay within the JAX tests' thresholds of the PIL path
(``tests/test_native.py:31-43, :95-110``). ``auto`` falls back to PIL per
image for what the native path rejects (CMYK); an explicit ``native`` that
cannot build raises with the compiler's error, also through ``train``.
The libjpeg headers are vendored beside the source; the library linked is
the system's, or Pillow's bundled one where the linker finds none.
"""

import contextlib
import io
import subprocess

import numpy as np
import pytest

from dss_ml_at_scale_tpu import native as jax_native
from dss_ml_at_scale_tpu_torch import native
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.data.transform import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    decode_resize_crop,
    imagenet_transform_spec,
)


@pytest.fixture(autouse=True)
def _needs_libjpeg():
    if not native.native_available():
        error = native.load_error() or ""
        if "jpeglib.h" in error:
            pytest.skip("the host has no jpeglib.h: " + error.splitlines()[-1])
        pytest.fail(f"the native pipeline did not build: {error}")


def _jpeg(rng, w, h, mode="RGB", quality=95) -> bytes:
    from PIL import Image

    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").convert(mode).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


SIZES = [(320, 240), (240, 320), (500, 375), (224, 224), (1024, 768)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mean=IMAGENET_MEAN, std=IMAGENET_STD),
    dict(dtype="uint8"),
    dict(chw=True),
    dict(fast_scale=True),
    dict(resize=48, crop=40, num_threads=2),
], ids=["float", "normalized", "uint8", "chw", "fast", "small"])
def test_decode_is_the_jax_packages_bit_for_bit(kw):
    rng = np.random.default_rng(0)
    jpegs = [_jpeg(rng, w, h) for w, h in SIZES]
    got, ok = native.decode_jpeg_batch(jpegs, **{"chw": False, **kw})
    want, jok = jax_native.decode_jpeg_batch(jpegs, **{"chw": False, **kw})
    assert ok.all() and jok.all()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_decode_stays_within_the_pil_thresholds():
    rng = np.random.default_rng(1)
    jpegs = [_jpeg(rng, w, h) for w, h in SIZES[:4]]
    images, ok = native.decode_jpeg_batch(jpegs, resize=256, crop=224)
    assert ok.all() and images.shape == (4, 224, 224, 3)
    for i, b in enumerate(jpegs):
        ref = decode_resize_crop(b, resize=256, crop=224)
        assert np.mean(np.abs(images[i] - ref)) < 0.01
        assert np.max(np.abs(images[i] - ref)) < 0.15


def test_fast_scale_decodes_close_to_full():
    rng = np.random.default_rng(2)
    big = _jpeg(rng, 1024, 768)
    full, _ = native.decode_jpeg_batch([big])
    fast, _ = native.decode_jpeg_batch([big], fast_scale=True)
    assert np.mean(np.abs(full - fast)) < 0.03
    small = _jpeg(rng, 240, 230)  # min side below resize: no DCT scaling
    a, _ = native.decode_jpeg_batch([small])
    b, _ = native.decode_jpeg_batch([small], fast_scale=True)
    np.testing.assert_array_equal(a, b)


def test_transform_spec_native_matches_jax_and_auto_falls_back_per_image():
    from dss_ml_at_scale_tpu.data.transform import imagenet_transform_spec as jax_spec

    rng = np.random.default_rng(3)
    good, cmyk = _jpeg(rng, 320, 240), _jpeg(rng, 300, 300, mode="CMYK")
    batch = {"content": np.array([good, good], dtype=object), "label_index": np.array([0, 1])}
    for dtype in ("float32", "uint8"):
        spec = imagenet_transform_spec(backend="native", output_dtype=dtype, fast_decode=True)
        want = jax_spec(backend="native", output_dtype=dtype, fast_decode=True)(batch)
        assert spec.backend == "native"
        np.testing.assert_array_equal(spec(batch)["image"], want["image"])
    mixed = {"content": np.array([good, cmyk], dtype=object), "label_index": np.array([0, 1])}
    out = imagenet_transform_spec(backend="auto")(mixed)
    ref = imagenet_transform_spec(backend="pil")(mixed)
    assert np.mean(np.abs(out["image"][1] - ref["image"][1])) < 0.05
    with pytest.raises(ValueError, match="native decode failed"):
        imagenet_transform_spec(backend="native")(mixed)
    sub = imagenet_transform_spec(backend="native", on_error="substitute")
    assert np.all(sub(mixed)["image"][1] == 0) and sub.substitutions.count == 1


@pytest.mark.parametrize("kw", [dict(), dict(dtype="uint8"), dict(fast_scale=True)],
                         ids=["float", "uint8", "fast"])
def test_a_pillow_linked_build_is_the_system_builds_and_jaxs_bit_for_bit(kw, tmp_path,
                                                                       monkeypatch):
    """Where the linker finds no system libjpeg (the card's host), the
    pipeline links Pillow's bundled one by path: on the same JPEGs it
    decodes what the build against the system's -ljpeg and the JAX
    package's decoder decode."""
    lib = native.pillow_jpeg()
    assert lib is not None, "Pillow's wheel bundles no libjpeg here"
    rng = np.random.default_rng(5)
    jpegs = [_jpeg(rng, 300, 256) for _ in range(8)] + [_jpeg(rng, w, h) for w, h in SIZES]
    system, ok = native.decode_jpeg_batch(jpegs, **kw)
    system_build = native.library_path()
    monkeypatch.setattr(native, "jpeg_library",
                        lambda: ([str(lib), f"-Wl,-rpath,{lib.parent}"], lib))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    pillow, pok = native.decode_jpeg_batch(jpegs, **kw)
    assert native.load_error() is None and ok.all() and pok.all()
    assert native.library_path().name != system_build.name  # the library is in the hash
    linked = subprocess.run(["ldd", str(native.library_path())], capture_output=True,
                            text=True, check=True).stdout
    assert f"{lib.name} => {lib}" in linked  # the rpath finds Pillow's copy
    np.testing.assert_array_equal(pillow, system)
    want, _ = jax_native.decode_jpeg_batch(jpegs, **{"chw": False, **kw})
    np.testing.assert_array_equal(pillow, want)


def test_the_library_builds_into_the_build_directory():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert not list(native._SRC.parent.glob("*.so"))  # nothing beside the source


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """A source that does not compile, in a fresh build directory."""
    src = tmp_path / "image_pipeline.cpp"
    src.write_text("#include <jpeglib.h>\nint dsst_abi_version() { return undeclared; }\n")
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)


def test_native_that_cannot_build_raises_with_the_compilers_error(broken_build):
    assert not native.native_available()
    assert "undeclared" in native.load_error()
    with pytest.raises(RuntimeError, match="undeclared"):
        imagenet_transform_spec(backend="native")
    assert imagenet_transform_spec(backend="auto").backend == "pil"


def test_train_decode_backend_native_raises_where_it_cannot_build(broken_build, tmp_path):
    table = str(tmp_path / "t")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["datagen", "images", "--out", table, "--n", "8", "--classes", "2",
                         "--size", "32"]) == 0
    with pytest.raises(RuntimeError, match="undeclared"):
        cli.main(["train", "--data", table, "--model", "tiny", "--batch-size", "4",
                  "--crop", "32", "--num-classes", "2", "--epochs", "1", "--device", "cpu",
                  "--decode-backend", "native"])
