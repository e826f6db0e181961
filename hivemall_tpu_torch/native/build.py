"""Build the port's native host library from `native/hivemall_native.cpp`.

The source is the JAX package's (compiled, never copied or edited); the
build is the plain variant `scripts/build_native.sh` makes: g++ with
``-O3 -march=native -fPIC -shared -std=c++17``. It runs at first use and
writes into `native/_build/` of this package (git-ignored), never next to
the JAX package's library.

The library's file name carries a sha256 of the source, the flags, the
compiler's version line and the CPU that ``-march=native`` resolves to, so
an edited source, another compiler or another host builds anew and a stale
library is never loaded. The build writes to a temporary name and renames
it into place: processes reaching the first build together each compile,
and each rename leaves one whole library under the final name.

A missing compiler or a failed compile raises ``RuntimeError`` with the
compiler's output; nothing falls back to numpy in its place.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE.parent.parent / "native" / "hivemall_native.cpp"
BUILD_DIR = _HERE / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def compiler() -> str:
    """The C++ compiler's path; RuntimeError when it is not on PATH."""
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found on PATH: the native host "
                           f"library is compiled from {SOURCE.name} at "
                           "first use and needs a C++17 compiler")
    return found


def _query(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr[:8000]}")
    return proc.stdout


def compiler_identity(cxx: str) -> str:
    """The compiler's version line and the CPU ``-march=native`` selects."""
    version = _query([cxx, "--version"]).splitlines()[0]
    target = [ln.split() for ln in
              _query([cxx, "-march=native", "-Q", "--help=target"])
              .splitlines() if ln.strip().startswith(("-march=", "-mtune="))]
    return version + " " + " ".join(" ".join(t) for t in target)


def library_path(cxx: str) -> Path:
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
        + compiler_identity(cxx).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhivemall_native_{key}.so"


def build() -> Path:
    """Compile the library unless one of the same key is already built.
    Returns its path."""
    cxx = compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{CXX} failed for {SOURCE.name} (exit {proc.returncode}):"
                f"\n{proc.stderr[:8000]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
