"""Build the port's hand-written CUDA kernels with nvcc and bind them via ctypes.

Every ``volpick_tpu_torch/csrc/*.cu`` file is compiled for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, so the build
takes seconds (no PyTorch headers). The library lands in
``build/volpick_tpu_torch/`` beside the package, named by a hash of the
sources and flags: a changed source builds anew, an unchanged one loads the
existing file. The build happens on first use, never at import.

A missing ``nvcc`` or a failed compile raises with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "volpick_tpu_torch"

# -O3 without --use_fast_math: the parity targets need IEEE expf/tanhf.
# -Xptxas -v only prints registers / shared memory / spills per kernel.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # compiler output of the last build in this process


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the CUDA "
        "kernels of volpick_tpu_torch cannot be built"
    )


def library_path() -> Path:
    """Path of the shared library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvolpick_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared.

    Pointers and the stream must be declared ``ctypes.c_void_p``, or ctypes
    passes them as 32-bit ints. Every entry point returns the launch's
    ``cudaGetLastError()`` as an int."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
