"""Build the native waveform decoders of the repository (``native/*.cpp``,
plain C++ with a C interface) with g++ and load them with ctypes.

Each source is compiled on first use into a shared library of its own under
``build/volpick_tpu_torch/`` (the directory of the CUDA kernels' library),
named by a hash of the source and the flags: a changed source builds anew, an
unchanged one loads the existing file. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
# the directory of ops/cuda/_build.py's BUILD_DIR, named here so that the
# readers (and the acquisition workers that write with them) load without torch
BUILD_DIR = ROOT / "build" / "volpick_tpu_torch"
CXX_FLAGS = ("-O2", "-Wall", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}  # source stem -> loaded library


def library_path(stem: str) -> Path:
    """Path of the library built from ``native/<stem>.cpp`` (built or not)."""
    src = NATIVE_DIR / f"{stem}.cpp"
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(stem: str) -> Path:
    """Compile ``native/<stem>.cpp`` unless its library already exists."""
    out = library_path(stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / f"{stem}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build the native {stem} decoder: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``native/<stem>.cpp``, built on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs[stem] = ctypes.CDLL(str(build(stem)))
        return lib
