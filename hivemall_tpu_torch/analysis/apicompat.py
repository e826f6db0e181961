"""torch API compatibility table for rule G009.

A small, declarative registry of torch spellings that moved between the
torch versions the port meets, keyed on dotted names: a call's callee, an
attribute read or written (a flag), or an imported module. Each entry
knows the version window in which the spelling exists, where that bound
comes from, and — for the TF32 flags — the ``runtime/torch_compat.py``
helper that is right on every torch, so G009 can both *grade* a use
(error when the installed torch lacks the spelling, warning when it merely
harms portability) and *repair* it (the autofix rewrites a flag's read or
write to the helper and routes the import through the compat module).

Every bound is one the installed torch proves: its own source or
deprecation text, or its file list. Where nothing here proves a bound the
entry has none, and a use grades as a portability warning on every
version. None of these spellings states the version that added or will
remove it, so the one bound in the table is an absence: ``torch._six`` is
not in torch 2.13.0's files (``tests/test_torch_analysis_collective.py``
holds the table against the installed torch's files).

The installed torch version is read from package metadata — graftcheck
must stay importable (and fast) on hosts with no accelerator stack, so
torch itself is never imported. ``GRAFTCHECK_TORCH_VERSION`` overrides it
for tests and cross-version audits.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Optional, Tuple

Version = Tuple[int, ...]

# The one module allowed to touch the raw TF32 flags (it IS the
# portability layer), and the import the autofix routes callers through.
COMPAT_MODULE_PATH = "hivemall_tpu_torch/runtime/torch_compat.py"
COMPAT_MODULE = "hivemall_tpu_torch.runtime.torch_compat"


@dataclass(frozen=True)
class ApiEntry:
    dotted: str                    # the spelling (dotted_name match)
    kind: str                      # "call", "flag" or "module"
    introduced: Optional[Version]  # first torch version carrying it
    removed: Optional[Version]     # first torch version known without it
    replacement: str               # the spelling that replaces it
    note: str                      # one-line context for the message
    compat_read: Optional[str] = None   # helper a --fix puts for a read
    compat_write: Optional[str] = None  # helper a --fix puts for a write


_TF32_MIX = ("on a torch with fp32_precision, a read of the legacy flag "
             "raises RuntimeError ('mix of the legacy and new APIs') once "
             "the new one was set")

API_TABLE: Tuple[ApiEntry, ...] = (
    ApiEntry(
        dotted="torch.backends.cuda.matmul.allow_tf32",
        kind="flag", introduced=None, removed=None,
        replacement="torch.backends.cuda.matmul.fp32_precision",
        note=_TF32_MIX,
        compat_read="tf32_matmul_enabled", compat_write="set_tf32_matmul",
    ),
    ApiEntry(
        dotted="torch.backends.cuda.matmul.fp32_precision",
        kind="flag", introduced=None, removed=None,
        replacement="torch.backends.cuda.matmul.allow_tf32",
        note="a torch from before the new TF32 API has no fp32_precision "
             "(its cuBLAS flags raise AttributeError), and a read of it "
             "alone misses the global setting that its 'none' inherits",
    ),
    ApiEntry(
        dotted="torch.backends.fp32_precision",
        kind="flag", introduced=None, removed=None,
        replacement="torch.backends.cuda.matmul.allow_tf32",
        note="the global TF32 setting exists only with the new API",
    ),
    ApiEntry(
        dotted="torch.get_float32_matmul_precision",
        kind="call", introduced=None, removed=None,
        replacement="torch.backends.cuda.matmul.fp32_precision",
        note="on a torch with fp32_precision it raises RuntimeError ('mix "
             "of the legacy and new APIs') once the new API set TF32",
    ),
    ApiEntry(
        dotted="torch.backends.cudnn.allow_tf32",
        kind="flag", introduced=None, removed=None,
        replacement="torch.backends.cudnn.conv.fp32_precision",
        note="on a torch with fp32_precision, a read of the legacy flag "
             "raises RuntimeError once conv and RNN were set apart",
        compat_write="set_tf32_cudnn",
    ),
    ApiEntry(
        dotted="torch.cuda.amp.autocast",
        kind="call", introduced=None, removed=None,
        replacement="torch.amp.autocast('cuda', ...)",
        note="deprecated in the installed torch "
             "(torch/cuda/amp/autocast_mode.py: 'torch.cuda.amp.autocast"
             "(args...) is deprecated')",
    ),
    ApiEntry(
        dotted="torch.cuda.amp.GradScaler",
        kind="call", introduced=None, removed=None,
        replacement="torch.amp.GradScaler('cuda', ...)",
        note="deprecated in the installed torch "
             "(torch/cuda/amp/grad_scaler.py)",
    ),
    ApiEntry(
        dotted="torch.distributed._tensor",
        kind="module", introduced=None, removed=None,
        replacement="torch.distributed.tensor",
        note="a shim in the installed torch "
             "(torch/distributed/_tensor/__init__.py: 'DTensor has moved to "
             "torch.distributed.tensor ... We will remove this folder')",
    ),
    ApiEntry(
        dotted="torch._six",
        kind="module", introduced=None, removed=(2, 13, 0),
        replacement="math.inf / str / collections.abc",
        note="the Python 2/3 shim is not in torch 2.13.0's files",
    ),
)

API_BY_DOTTED = {e.dotted: e for e in API_TABLE}

# modules whose import (or use, by a dotted path into them) G009 flags
LEGACY_IMPORT_MODULES = {e.dotted: e for e in API_TABLE
                         if e.kind == "module"}


def module_entry(dotted: str) -> Optional[ApiEntry]:
    """The entry of the legacy module a dotted module or attribute path
    lies in."""
    for name, e in LEGACY_IMPORT_MODULES.items():
        if dotted == name or dotted.startswith(name + "."):
            return e
    return None


def parse_version(text: str) -> Optional[Version]:
    parts = []
    for piece in text.split(".")[:3]:
        digits = ""
        for ch in piece:
            if not ch.isdigit():
                break
            digits += ch
        if not digits:
            return tuple(parts) if parts else None
        parts.append(int(digits))
    return tuple(parts) if parts else None


def installed_torch_version() -> Optional[Version]:
    """Installed torch version without importing torch; None when
    undetectable (G009 then grades everything as a portability warning).
    A local build tag (``2.13.0+cpu``) is dropped."""
    override = os.environ.get("GRAFTCHECK_TORCH_VERSION")
    if override:
        return parse_version(override)
    return _metadata_version()


@functools.lru_cache(maxsize=1)
def _metadata_version() -> Optional[Version]:
    """The package metadata's torch version, read once per process (the
    lookup walks the import path)."""
    try:
        from importlib import metadata
        return parse_version(metadata.version("torch"))
    except Exception:
        return None


def available_in(entry: ApiEntry, version: Optional[Version]
                 ) -> Optional[bool]:
    """Does `version` carry the spelling? None when the version is
    unknown."""
    if version is None:
        return None
    if entry.introduced is not None and version < entry.introduced:
        return False
    if entry.removed is not None and version >= entry.removed:
        return False
    return True


def compat_import_module(rel_path: str) -> str:
    """The import-from module string a file should use to reach
    torch_compat: relative inside the hivemall_tpu_torch package (matching
    the house style), absolute elsewhere."""
    parts = rel_path.split("/")
    if parts[0] != "hivemall_tpu_torch" or len(parts) < 2:
        return COMPAT_MODULE
    # depth below the package root: knn/x.py -> 1, models/trees/x.py -> 2
    depth = len(parts) - 2
    if parts[1] == "runtime" and depth == 1:
        return ".torch_compat"  # a sibling module of runtime/
    return "." * (depth + 1) + "runtime.torch_compat"
