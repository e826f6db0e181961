"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Each kernel source under `csrc/` is compiled at first use into
`kernels/_build/` (git-ignored) as a shared library with a plain C
interface. The library's file name carries a hash of its source and flags,
so an edited source builds anew and a stale library is never loaded. The
build writes to a temporary name and renames it into place, so concurrent
first uses cannot load a half-written file.

Nothing here runs at import time; `load(name)` builds (if needed) and loads.

No code here carries on on the CPU or on a plain version when a kernel
fails to build or launch: the module opts into graftcheck's
exception-flow rules, whose G028/G029 flag a quiet fallback.

# graftcheck: failure-path-module
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# sm_90a: Hopper with its architecture-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xptxas=-v", "-shared", "-Xcompiler=-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's report (registers, shared memory, spills) of each build made
# by this process, by kernel name
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME (PyTorch's own search: $CUDA_HOME, the nvcc on
    PATH, then the default install), else the PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into the build directory unless a library of
    the same source is already there. Returns the library's path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr[:8000]}")
        build_logs[name] = proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu's library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
