"""Checkpoint / warm start.

The reference's persistence model is model-as-table: trainers dump
(feature, weight[, covar]) rows at close(), and warm start reloads such a
table via `-loadmodel <file>` (ref: LearnerBaseUDTF.java:215-333).

Two tiers, in the JAX package's on-disk formats so that files cross-load
between the two packages in both directions:
- `save_model_rows` / `load_model_rows` — the interchange format: a
  key-value table (npz), a Hive-exported text table (tsv/csv), or the
  sparse codec blob (utils/codec.encode_sparse_model).
- `save_linear_state` / `load_linear_state` — the full training state
  (slots, globals, step counter) for mid-training resume.
- `save_elastic` / `load_elastic` — the self-verifying single-file
  checkpoint with an embedded manifest and a payload digest, an atomic
  write and a ``.prev`` fallback (the continuous pipeline's checkpoints).

bf16 at rest, without ml_dtypes: a bf16 table is stored widened to f32
(value-exact) with its dtype NAME recorded, or — in quantized artifacts —
as its raw uint16 bit patterns, rounded and viewed through torch. Dtype
names are the JAX package's strings ("float32", "bfloat16", "int8").
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.state import LinearState
from ..device import DeviceLike, resolve_device
from ..utils.codec import decode_sparse_model, encode_sparse_model


def save_model_rows(path: str, feats: np.ndarray, weights: np.ndarray,
                    covars: Optional[np.ndarray] = None,
                    compressed: bool = False) -> None:
    if compressed:
        with open(path, "wb") as f:
            f.write(encode_sparse_model(feats, weights))
        return
    data = {"feature": np.asarray(feats), "weight": np_saveable(weights)}
    if covars is not None:
        data["covar"] = np_saveable(covars)
    np.savez_compressed(path, **data)


def load_model_rows(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    if path.endswith(".npz"):
        # context-manage the NpzFile: np.load keeps the zip member open
        # until closed (one leaked fd per reload otherwise)
        with np.load(path) as z:
            return (z["feature"], z["weight"],
                    z["covar"] if "covar" in z.files else None)
    if path.endswith((".tsv", ".csv", ".txt")):
        return _load_text_model_rows(path)
    with open(path, "rb") as f:
        feats, weights = decode_sparse_model(f.read())
    return feats, weights, None


def _load_text_model_rows(path: str):
    """A Hive-exported model table `feature<TAB>weight[<TAB>covar]` (or
    comma-separated) — the file the reference's -loadmodel consumed
    (ref: LearnerBaseUDTF.loadPredictionModel:215-333)."""
    sep = "," if path.endswith(".csv") else "\t"
    feats, weights, covars = [], [], []
    has_covar = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(sep)
            feats.append(int(parts[0]))
            weights.append(float(parts[1]))
            if len(parts) > 2:
                covars.append(float(parts[2]))
                has_covar = True
    return (np.asarray(feats, np.int64), np.asarray(weights, np.float32),
            np.asarray(covars, np.float32) if has_covar else None)


def dense_from_rows(dims: int, feats: np.ndarray, weights: np.ndarray,
                    covars: Optional[np.ndarray] = None):
    """Model rows -> dense warm-start arrays (the loadPredictionModel path)."""
    w = np.zeros(dims, np.float32)
    w[np.asarray(feats, np.int64) % dims] = weights
    c = None
    if covars is not None:
        c = np.ones(dims, np.float32)
        c[np.asarray(feats, np.int64) % dims] = covars
    return w, c


def dtype_name(dtype) -> str:
    """A torch (or numpy) dtype's name as the JAX package records it:
    torch.float32 -> "float32", torch.bfloat16 -> "bfloat16"."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def np_saveable(x) -> np.ndarray:
    """npz-stable host array: a tensor comes to the host, and bf16 (which
    np.savez cannot hold) widens to f32 — value-exact; the recorded
    ``weights_dtype`` narrows it back at load."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # a host bf16 array from another library
        return a.astype(np.float32)
    return a


def dtype_from_name(name) -> Optional[torch.dtype]:
    """The narrow half of the at-rest protocol: a recorded dtype NAME back
    to the torch dtype device tables reload at (None, for checkpoints that
    predate the record, passes through)."""
    if name is None:
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


# --- quantized at-rest protocol (serving/artifact freeze(quantize=...)) -----
# - bf16: raw uint16 bit patterns — exact bytes, half the widened-f32 pack;
# - int8_absmax: per-block symmetric int8 with one f32 scale per block of
#   `block_rows` (power of two) rows along the quantized axis, computed by
#   absmax: scale = max(|block|) / 127, q = rint(x / scale). An all-zero
#   block records scale 1.0 so dequantization is exactly zero; a tail
#   block shorter than block_rows is padded with zeros for the reshape
#   only (the pad never changes absmax and is sliced off the q output).

QUANT_SCHEME_BF16 = "bf16"
QUANT_SCHEME_INT8 = "int8_absmax"
QUANT_BLOCK_ROWS = 64  # default scale-block granularity (power of two)
SCALE_SUFFIX = "__scale"  # pack name of a quantized table's scale array


def bf16_pack_raw(x) -> np.ndarray:
    """A table -> raw bf16 bit patterns as uint16. A non-bf16 input is
    rounded to bf16 (round to nearest, ties to even) first — that rounding
    IS the quantization. The input is taken as f32 (tables are f32 or
    bf16)."""
    if not torch.is_tensor(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # already bf16 bits: view them
            return np.ascontiguousarray(a).view(np.uint16)
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    t = x.detach().cpu()
    if t.dtype != torch.bfloat16:
        t = t.float().to(torch.bfloat16)
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def bf16_unpack_raw(u: np.ndarray) -> torch.Tensor:
    """Raw uint16 bit patterns back to a host bf16 TENSOR (a view of the
    bits, not a cast: moving it to the device reloads at bf16 with no
    widened copy anywhere)."""
    bits = np.array(np.asarray(u, np.uint16), copy=True).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def quantize_int8(table, block_rows: int = QUANT_BLOCK_ROWS, axis: int = 0):
    """Symmetric per-block int8 quantization along ``axis``.

    Returns ``(q, scales)``: ``q`` is int8 with ``table``'s shape; ``scales``
    is f32 with the same shape except the quantized axis collapses to
    ``ceil(rows / block_rows)`` blocks. Row r of the table dequantizes as
    ``q[r] * scales[r // block_rows]`` (axis-relative), which is how the
    serving scorer folds the scale into the gathered window — the full
    table is never widened.
    """
    if block_rows <= 0 or block_rows & (block_rows - 1):
        raise ValueError(f"block_rows must be a power of two: {block_rows}")
    a = np.asarray(np_saveable(table), np.float32)
    a = np.moveaxis(a, axis, 0)
    rows = a.shape[0]
    n_blocks = max(1, -(-rows // block_rows))
    pad = n_blocks * block_rows - rows
    if pad:  # tail block: zero-pad for the reshape only (absmax unchanged)
        a = np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], np.float32)])
    blocks = a.reshape((n_blocks, block_rows) + a.shape[1:])
    absmax = np.max(np.abs(blocks), axis=1)  # [n_blocks, *rest]
    # all-zero block: scale 1.0 keeps q == 0 dequantizing to exact zero
    scales = np.where(absmax > 0.0, absmax / np.float32(127.0),
                      np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(np.int8)
    q = q.reshape((n_blocks * block_rows,) + a.shape[1:])[:rows]
    return np.moveaxis(q, 0, axis), np.moveaxis(scales, 0, axis)


def dequantize_int8(q, scales, block_rows: int = QUANT_BLOCK_ROWS,
                    axis: int = 0) -> np.ndarray:
    """Host-side reference dequantization (tests / offline analysis; the
    serving path never calls this on a full table)."""
    qq = np.moveaxis(np.asarray(q), axis, 0)
    ss = np.moveaxis(np.asarray(scales, np.float32), axis, 0)
    per_row = np.repeat(ss, block_rows, axis=0)[: qq.shape[0]]
    return np.moveaxis(qq.astype(np.float32) * per_row, 0, axis)


def pack_linear_state(state: LinearState) -> Dict[str, np.ndarray]:
    """LinearState -> the npz array payload, the JAX package's layout."""
    arrays = {
        "weights": np_saveable(state.weights),
        "touched": np_saveable(state.touched).astype(np.int8),
        "step": np.asarray(np.int32(state.step)),
        # the dtype the state TRAINED with — resume must re-narrow a bf16
        # table rather than silently continue in f32
        "weights_dtype": np.asarray(dtype_name(state.weights.dtype)),
    }
    if state.covars is not None:
        arrays["covars"] = np_saveable(state.covars)
    for k, v in state.slots.items():
        arrays[f"slot__{k}"] = np_saveable(v)
    for k, v in state.globals.items():
        arrays[f"global__{k}"] = np_saveable(v)
    return arrays


def unpack_linear_state(arrays: Mapping[str, np.ndarray],
                        device: DeviceLike = None) -> LinearState:
    """The load half of pack_linear_state, over any name->array mapping;
    the state lands on ``device`` (None: the CUDA device, or raise)."""
    dev = resolve_device(device)
    wdt = str(arrays["weights_dtype"][()]) if "weights_dtype" in arrays \
        else None
    table_dt = dtype_from_name(wdt)

    def t(a, dtype):
        x = torch.from_numpy(np.array(a, copy=True))
        return x.to(device=dev, dtype=dtype or x.dtype)

    return LinearState(
        weights=t(arrays["weights"], table_dt),
        covars=t(arrays["covars"], table_dt) if "covars" in arrays else None,
        slots={k[len("slot__"):]: t(arrays[k], torch.float32)
               for k in arrays if k.startswith("slot__")},
        touched=t(arrays["touched"], torch.int8),
        step=int(np.asarray(arrays["step"])),
        globals={k[len("global__"):]: t(arrays[k], torch.float32)
                 for k in arrays if k.startswith("global__")},
    )


def save_linear_state(path: str, state: LinearState) -> None:
    np.savez_compressed(path, **pack_linear_state(state))


def load_linear_state(path: str, device: DeviceLike = None) -> LinearState:
    # every array is read inside the with: NpzFile reads lazily and must be
    # closed (fd leak otherwise)
    with np.load(path) as z:
        return unpack_linear_state({k: z[k] for k in z.files}, device)


# --- elastic checkpoints -----------------------------------------------------
# One self-contained npz per checkpoint: the payload arrays plus an embedded
# JSON manifest and a sha256 digest over the payload bytes — the JAX
# package's format, so either package loads the other's files. Written as
# tmp, then the previous checkpoint rotated to `path.prev`, then tmp
# renamed into place: a crash at ANY point leaves at least one valid
# checkpoint on disk, and the loader verifies the digest and falls back
# (loudly) to `.prev` when the newest file is truncated or corrupt.

ELASTIC_FORMAT_VERSION = 1
MANIFEST_KEY = "__manifest__"
PREV_SUFFIX = ".prev"


class CheckpointCorrupt(RuntimeError):
    """The checkpoint file exists but cannot be trusted: unreadable zip
    (truncation), missing manifest, or payload digest mismatch."""


class NotElasticCheckpoint(CheckpointCorrupt):
    """A readable npz with no embedded manifest — a save_linear_state
    checkpoint, not a rotted elastic one. The loader raises it instead of
    falling back."""


def elastic_digest(arrays: Mapping[str, np.ndarray]) -> str:
    """sha256 over the payload: sorted (name, dtype, shape, raw bytes).
    The manifest carries this digest, so it cannot cover itself — the
    loader recomputes over the arrays and compares."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == MANIFEST_KEY:
            continue
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.dtype.str).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def crash_point(tag: str, path: str) -> None:
    """No-op hook on the checkpoint write path — the monkeypatch target of
    the fault harness (runtime/faults.py), which simulates a crash between
    the payload write and the atomic rename. Tags: ``elastic.after_write``
    (tmp exists, nothing rotated), ``elastic.before_rename`` (previous
    checkpoint already rotated to .prev, new one not yet in place)."""


def checkpoint_written(path: str) -> None:
    """No-op hook fired after a successful write and rename — the fault
    harness's seat for truncating or corrupting the file after the fact."""


def save_elastic(path: str, arrays: Dict[str, np.ndarray],
                 manifest: dict) -> dict:
    """Atomically persist an elastic checkpoint: payload ``arrays`` (host
    numpy arrays, e.g. `pack_linear_state`) plus ``manifest`` (digest and
    format_version are stamped here). On success the previous checkpoint
    survives as ``path + '.prev'``. Returns the stamped manifest."""
    manifest = dict(manifest)
    manifest["format_version"] = ELASTIC_FORMAT_VERSION
    manifest["digest"] = elastic_digest(arrays)
    # the .npz suffix keeps np.savez from renaming the temp file
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, **arrays,
        **{MANIFEST_KEY: np.asarray(json.dumps(manifest))})
    crash_point("elastic.after_write", path)
    if os.path.exists(path):
        os.replace(path, path + PREV_SUFFIX)
    crash_point("elastic.before_rename", path)
    os.replace(tmp, path)
    checkpoint_written(path)
    return manifest


def _load_elastic_one(path: str):
    """Read and verify ONE checkpoint file. Raises CheckpointCorrupt on any
    integrity failure (truncated zip, missing or unparsable manifest,
    digest mismatch) and FileNotFoundError when absent."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:  # zipfile.BadZipFile, zlib.error, ValueError ...
        raise CheckpointCorrupt(f"{path}: unreadable npz ({e})") from e
    if MANIFEST_KEY not in arrays:
        raise NotElasticCheckpoint(
            f"{path}: no {MANIFEST_KEY} entry — not an elastic checkpoint")
    try:
        manifest = json.loads(str(arrays.pop(MANIFEST_KEY)[()]))
    except Exception as e:
        raise CheckpointCorrupt(f"{path}: unparsable manifest ({e})") from e
    digest = elastic_digest(arrays)
    if digest != manifest.get("digest"):
        raise CheckpointCorrupt(
            f"{path}: payload digest {digest[:12]}… does not match the "
            f"manifest's {str(manifest.get('digest'))[:12]}…")
    return arrays, manifest


def load_elastic(path: str, fallback: bool = True):
    """Load and verify the newest valid checkpoint at ``path``. When the
    newest file is missing or corrupt and ``fallback`` is on, fall back —
    loudly, with a RuntimeWarning naming the reason — to ``path + '.prev'``
    instead of failing the resume. Returns ``(arrays, manifest)``: host
    numpy arrays (`unpack_linear_state` puts a state on a device)."""
    try:
        return _load_elastic_one(path)
    except (FileNotFoundError, CheckpointCorrupt) as e:
        if not fallback or isinstance(e, NotElasticCheckpoint):
            # a save_linear_state checkpoint is a format, not a rot: the
            # caller decides how to read it
            raise
        prev = path + PREV_SUFFIX
        if not os.path.exists(prev):
            raise
        warnings.warn(
            f"elastic checkpoint {path} is unusable ({e}); falling back to "
            f"the previous checkpoint {prev} — work since that checkpoint "
            "will be replayed", RuntimeWarning, stacklevel=2)
        return _load_elastic_one(prev)
