"""Build the port's hand-written CUDA kernels with nvcc and bind them via ctypes.

Every ``volpick_tpu_torch/csrc/*.cu`` file is compiled for Hopper
(``sm_90a``) by its own ``nvcc``, all started together, and the objects are
linked into ONE shared library with a plain C interface, so the build takes
seconds (no PyTorch headers). The library lands in
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_functions: dict = {}  # entry point name -> bound function of _lib
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


def _run_all(cmds: Sequence[Sequence[str]]) -> str:
    """Run the commands in parallel; their joined output, or raise with the
    output of every command that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed (exit {p.returncode}): {' '.join(c)}\n{o}"
              for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists:
    one nvcc per source in parallel, then one link."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(sources, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]])
    except RuntimeError as e:
        build_log = str(e)
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_log = log
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
    """A C entry point of the library with its argument types declared (once;
    later calls return the same object).

    Pointers and the stream must be declared ``ctypes.c_void_p``, or ctypes
    passes them as 32-bit ints. Every entry point returns the launch's
    ``cudaGetLastError()`` as an int."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn
