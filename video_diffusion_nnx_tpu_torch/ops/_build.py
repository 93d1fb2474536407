"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC --split-compile=0

The library is built at first use into ``build/kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of its source and flags, so
an edited source is rebuilt and an unchanged one is reused. ``library(name,
defines)`` builds a variant with ``-D`` macros of its own beside it (a
measurement's control build; nothing in the package asks for one).
:func:`build_all` starts one ``nvcc`` per source at once and waits for all;
``--split-compile=0`` lets each run its optimization passes over its source's
kernels on every core, which halves the build where one source has most of
the kernels (PERF.md).
Nothing here runs when a module is imported.
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
SOURCES = ("temporal_attention", "temporal_blockwise", "temporal_tf32x3", "spatial_linear_attention",
           "cross_attention")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
]

_libs: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, defines: tuple[str, ...] = ()) -> tuple[Path, Path, subprocess.Popen] | None:
    target = _target(name, defines)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    if started is None:
        return
    target, tmp, proc = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all() -> None:
    """Compile every kernel source that is not built yet, all in parallel."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        for name, s in started.items():
            _finish(name, s)


def library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with the macros ``defines`` set."""
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            _finish(name, _start(name, defines))
            lib = ctypes.CDLL(str(_target(name, defines)))
            _libs[name, defines] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")
