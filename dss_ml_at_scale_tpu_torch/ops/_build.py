"""Build and load the port's CUDA kernels: nvcc into a shared library, ctypes.

Every ``csrc/*.cu`` compiles on its own with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -shared``) into
``build/kernels/`` at the root of the checkout, at first use. The file name
carries a hash of the source, so an edit rebuilds and an unchanged source
loads what is there. Nothing here runs at import: the CPU tests import every
module, and this machine may have no ``nvcc`` at all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are built from csrc/ on the machine with the card"
    )


def library_path(name: str) -> Path:
    """``build/kernels/<name>-<hash>.so`` for ``csrc/<name>.cu``."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w", encoding="utf-8") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    rc = proc.wait()
    log = out.with_suffix(".log")
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {rc}):\n"
            + log.read_text(encoding="utf-8", errors="replace")
        )
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: library path}``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        try:
            for n, job in started.items():
                if job is not None:
                    _finish(n, *job)
        finally:
            for job in started.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """What nvcc (with ``-Xptxas -v``: registers, shared memory, spills)
    printed when it built ``csrc/<name>.cu``; empty if it was not built
    here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(encoding="utf-8", errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
