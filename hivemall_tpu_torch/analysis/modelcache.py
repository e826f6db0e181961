"""Shared ModuleModel construction cache: memory layer + on-disk pickle.

Every graftcheck scan needs a ModuleModel per file, both for the scanned
files and for the package context of the program rules. This module makes
model construction a single cached path with two layers:

- **memory** (always on): ``{abspath: (mtime, size, rel_path, model)}``,
  shared by package context AND scanned files. Because the SAME
  ModuleModel object is returned while the file is unchanged, per-module
  analysis products attached as ``_graftcheck_*`` attributes (concurrency
  class tables, FFI decls, raised-exception summaries) survive across
  scans — that cache-attachment contract is what keeps repeated scans
  cheap.
- **disk** (``.graftcheck_cache/torch-models-pyXY.pkl`` at the repo root):
  pickled models keyed on each file's **sha256**, so invalidation is per
  file and a fresh process (each CLI run, each pytest worker) skips
  parsing files it has seen before. The file name carries the Python
  minor version — AST pickles are not portable across versions — and the
  payload carries a schema number. Only files inside the
  ``hivemall_tpu_torch`` package persist: test fixtures and tmpdir
  scratch files would churn the store every run for no reuse.

The file is the port's own. The JAX package's analyzer keeps
``models-pyXY.pkl`` in the same directory; unpickling that file here would
import the JAX package's analysis modules (its pickled classes) into this
process and hand back models of the other tree, so the two never share a
file, and the payload's magic string differs too.

``_graftcheck_*`` memo attributes are STRIPPED (from shallow copies —
the live models keep their caches) before pickling: several are keyed
by ``id()`` of AST nodes, and object ids do not survive a pickle
round-trip, so persisting them would resurrect tables whose keys can
collide with unrelated nodes in the new process.

Set ``GRAFTCHECK_CACHE=0`` to disable the disk layer (the memory layer
has no staleness modes beyond mtime/size and stays on).
"""

from __future__ import annotations

import ast
import copy
import hashlib
import os
import pickle
import sys
import tempfile
from typing import Dict, Optional, Tuple

from .modmodel import ModuleModel

# 2: ModuleModel gained capture_regions and JitWrap.graphed (captures)
SCHEMA_VERSION = 2
_MAGIC = "graftcheck-torch-model-cache"

_MEM: Dict[str, Tuple[float, int, str, Optional[ModuleModel]]] = {}
# abspath -> (sha256 hex, rel_path, model); None until loaded
_DISK: Optional[Dict[str, Tuple[str, str, ModuleModel]]] = None
_DIRTY = False


def _enabled() -> bool:
    return os.environ.get("GRAFTCHECK_CACHE", "1") != "0"


def cache_dir() -> str:
    from .program import package_root
    return os.path.join(os.path.dirname(package_root()),
                        ".graftcheck_cache")


def cache_file() -> str:
    return os.path.join(
        cache_dir(), "torch-models-py%d%d.pkl" % sys.version_info[:2])


def _persistable(abspath: str) -> bool:
    from .program import package_root
    return abspath.startswith(package_root() + os.sep)


def _load_disk() -> Dict[str, Tuple[str, str, ModuleModel]]:
    global _DISK
    if _DISK is not None:
        return _DISK
    _DISK = {}
    if not _enabled():
        return _DISK
    try:
        with open(cache_file(), "rb") as fh:
            payload = pickle.load(fh)
        if isinstance(payload, dict) \
                and payload.get("magic") == _MAGIC \
                and payload.get("schema") == SCHEMA_VERSION:
            _DISK = payload["models"]
    except Exception:  # corrupt/absent/foreign cache: rebuild from source
        _DISK = {}
    return _DISK


def cached_model(fs_path: str, rel_path: str) -> Optional[ModuleModel]:
    """The ModuleModel for a file, or None when it is unreadable or does
    not parse (callers that need the precise error re-read the file —
    failures are rare, so the double read costs nothing in practice)."""
    global _DIRTY
    ap = os.path.abspath(fs_path)
    try:
        st = os.stat(ap)
    except OSError:
        return None
    hit = _MEM.get(ap)
    if hit is not None and hit[0] == st.st_mtime and hit[1] == st.st_size \
            and hit[2] == rel_path:
        return hit[3]
    try:
        with open(ap, "rb") as fh:
            raw = fh.read()
    except OSError:
        return None
    model: Optional[ModuleModel] = None
    persist = _persistable(ap) and _enabled()
    disk = _load_disk() if persist else {}
    digest = hashlib.sha256(raw).hexdigest()
    entry = disk.get(ap)
    if entry is not None and entry[0] == digest and entry[1] == rel_path:
        model = entry[2]
    else:
        try:
            source = raw.decode("utf-8")
            model = ModuleModel(rel_path, source,
                                ast.parse(source, filename=rel_path))
        except (SyntaxError, ValueError, UnicodeDecodeError):
            model = None
        if persist:
            if model is not None:
                disk[ap] = (digest, rel_path, model)
            else:
                disk.pop(ap, None)
            _DIRTY = True
    _MEM[ap] = (st.st_mtime, st.st_size, rel_path, model)
    return model


def _stripped(model: ModuleModel) -> ModuleModel:
    clean = copy.copy(model)
    for attr in [a for a in vars(clean) if a.startswith("_graftcheck_")]:
        delattr(clean, attr)
    return clean


def save() -> None:
    """Atomically write the disk layer when it changed this process."""
    global _DIRTY
    if not _DIRTY or not _enabled() or _DISK is None:
        return
    _DIRTY = False
    payload = {
        "magic": _MAGIC, "schema": SCHEMA_VERSION,
        "models": {ap: (digest, rel, _stripped(model))
                   for ap, (digest, rel, model) in _DISK.items()},
    }
    tmp = None
    try:
        os.makedirs(cache_dir(), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir(), suffix=".tmp")
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cache_file())
    except OSError:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def clear() -> None:
    """Drop both layers (tests use this to exercise cold paths)."""
    global _DISK, _DIRTY
    _MEM.clear()
    _DISK = None
    _DIRTY = False
    try:
        os.unlink(cache_file())
    except OSError:
        pass
