"""ctypes binding of the port's native C++ image pipeline.

The port's own copy of ``dss_ml_at_scale_tpu/native``: the same
``image_pipeline.cpp`` (libjpeg decode, PIL-equivalent antialiased resize,
center crop, normalize, on a GIL-free thread pool), built lazily with the
host's ``g++ -O3 -march=native`` into ``build/native/`` at the root of the
checkout (gitignored), never beside the source.

The libjpeg headers (libjpeg-turbo's, ``JPEG_LIB_VERSION`` 62, with the
x86_64 ``jconfig.h``) are vendored beside the source
(``README.libjpeg``), so a host without the development headers builds
too; another architecture does not. The library linked is the system's
``libjpeg.so`` where the linker finds one, else the ``libjpeg-*.so.62*``
that Pillow's wheel ships in ``pillow.libs/``, by path with an rpath
(:func:`jpeg_library`). The library's name carries a hash of the
source, the vendored headers, the libjpeg linked and the host's CPU
flags: a binary built with ``-march=native`` on another CPU, or against
another libjpeg, is never loaded.

:func:`native_available` says whether it built and loaded;
:func:`load_error` carries the compiler's error when it did not;
:func:`decode_jpeg_batch` decodes a batch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("image_pipeline.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_ABI = 3

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: str | None = None


_HEADER_DIR = Path(__file__).parent
_HEADERS = ("jpeglib.h", "jmorecfg.h", "jerror.h", "jconfig.h")


def jpeg_library() -> tuple[list[str], Path | None]:
    """``(link flags, library)``: ``-ljpeg`` where the linker finds the
    system's libjpeg, else Pillow's bundled libjpeg by path with an rpath
    to its directory; ``([], None)`` where there is neither."""
    try:
        found = subprocess.run(["g++", "-print-file-name=libjpeg.so"], capture_output=True,
                               text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        found = ""
    if os.path.isabs(found) and os.path.exists(found):
        return ["-ljpeg"], Path(os.path.realpath(found))
    lib = pillow_jpeg()
    if lib is not None:
        return [str(lib), f"-Wl,-rpath,{lib.parent}"], lib
    return [], None


def pillow_jpeg() -> Path | None:
    """The libjpeg (API 62) that Pillow's wheel bundles, if there is one."""
    import importlib.util

    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        return None
    candidates = sorted((Path(spec.origin).parent.parent / "pillow.libs").glob(
        "libjpeg-*.so.62*"))
    return candidates[0] if candidates else None


def _cache_key(library: Path | None) -> str:
    """Source, vendored headers, the libjpeg linked and the host's ISA:
    the library is ``-march=native``."""
    isa = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    isa += line
                    break
    except OSError:
        pass
    h = hashlib.sha256(_SRC.read_bytes() + isa.encode())
    for name in _HEADERS:
        h.update((_HEADER_DIR / name).read_bytes())
    if library is not None:
        h.update(str(library).encode() + library.read_bytes())
    return h.hexdigest()[:16]


def library_path(library: Path | None = None) -> Path:
    """Where the pipeline linked against ``library`` (default: the one
    :func:`jpeg_library` picks) is built."""
    if library is None:
        library = jpeg_library()[1]
    return BUILD_DIR / f"libdsst_image-{_cache_key(library)}.so"


def _build(out: Path, link: list[str]) -> None:
    """Compile to a temporary file and rename it into place (atomic for
    another process loading the same library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
           "-I", str(_HEADER_DIR), str(_SRC), "-o", str(tmp), *link, "-lpthread"]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError:
            # Some toolchains lack -march=native; retry plain.
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL | None:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            if platform.machine() != "x86_64":
                raise RuntimeError(f"the vendored jconfig.h is x86_64's; this host is "
                                   f"{platform.machine()}")
            link, library = jpeg_library()
            if library is None:
                raise RuntimeError("no libjpeg to link: neither the system's libjpeg.so "
                                   "nor Pillow's bundled libjpeg was found")
            path = library_path(library)
            if not path.exists():
                _build(path, link)
            lib = ctypes.CDLL(str(path))
            lib.dsst_abi_version.restype = ctypes.c_int
            if lib.dsst_abi_version() != _ABI:
                raise RuntimeError("native ABI mismatch; rebuild required")
            lib.dsst_decode_batch.restype = ctypes.c_int
            lib.dsst_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_ulong),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_void_p,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _load_error = f"native image pipeline unavailable: {detail}"
        return _lib


def native_available() -> bool:
    """True if the C++ pipeline built and loaded on this host."""
    return _load() is not None


def load_error() -> str | None:
    """Why the pipeline is unavailable (the compiler's error), else None."""
    _load()
    return _load_error


def decode_jpeg_batch(
    jpegs: list[bytes],
    *,
    resize: int = 256,
    crop: int = 224,
    mean: np.ndarray | None = None,
    std: np.ndarray | None = None,
    chw: bool = False,
    dtype: str = "float32",
    fast_scale: bool = False,
    num_threads: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of JPEG byte strings into ``(images, ok)``.

    ``images`` is ``[n, crop, crop, 3]`` (``[n, 3, crop, crop]`` with
    ``chw``); ``ok`` marks the rows that decoded (the others are zero).
    ``dtype="float32"``: values in [0, 1], or normalized with
    ``mean``/``std``; ``"uint8"``: the raw [0, 255] bytes (normalized on
    the device; ``mean``/``std`` must be None). ``fast_scale`` decodes a
    large source at the largest DCT-domain m/8 scale that covers
    ``resize`` (PIL's draft mode): less work, pixels slightly off a full
    decode. ``num_threads`` bounds the decode pool (default: one thread
    per image, at most the host's cores).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(_load_error or "native pipeline unavailable")
    if dtype not in ("float32", "uint8"):
        raise ValueError(f"dtype must be 'float32' or 'uint8', got {dtype!r}")
    out_u8 = dtype == "uint8"
    if out_u8 and (mean is not None or std is not None):
        raise ValueError("uint8 output is raw [0,255]; normalize on the device, not here")
    n = len(jpegs)
    shape = (n, 3, crop, crop) if chw else (n, crop, crop, 3)
    out = np.zeros(shape, np.uint8 if out_u8 else np.float32)
    if n == 0:
        return out, np.zeros(0, bool)
    do_norm = mean is not None or std is not None
    mean_a = np.ascontiguousarray(mean if mean is not None else np.zeros(3), np.float32)
    std_a = np.ascontiguousarray(std if std is not None else np.ones(3), np.float32)
    ptrs = (ctypes.c_char_p * n)(*jpegs)
    sizes = (ctypes.c_ulong * n)(*[len(b) for b in jpegs])
    statuses = np.zeros(n, np.int32)
    if num_threads is None:
        num_threads = min(n, os.cpu_count() or 1)
    lib.dsst_decode_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)),
        sizes, n, resize, crop, int(do_norm),
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(chw), int(out_u8), int(fast_scale),
        out.ctypes.data_as(ctypes.c_void_p),
        int(num_threads),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out, statuses == 0
