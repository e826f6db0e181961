"""ctypes bindings of the native host library (native/hivemall_native.cpp).

The counterpart of the JAX package's `native/__init__.py`, with its
function names, argument order and return conventions: bulk murmur3
hashing, bulk feature parsing, the zigzag-LEB128 codec, the per-row AROW
and FM loops behind `-native_scan`, and the batched apply behind
`-batch B -native_apply`. Everything here runs on the host, on numpy
arrays; no device tensor crosses the C ABI.

**One deliberate difference.** The JAX package returns None from every
binding, and warns, when its prebuilt library is absent or will not load.
The port builds its own library at first use (`native/build.py`) and
raises RuntimeError when it cannot, so no path quietly takes numpy in its
place. None is returned only where the JAX package returns it with its
library loaded: `parse_features_bulk` declines a token outside the
canonical grammar, a tuple feature or a non-ASCII numeric name, and the
callers take their Python path exactly there.

`CALLS` counts the calls into the library per binding, as the CUDA
kernels' wrappers count launches.

Not bound here (later slices, with the modules that need them):
`decode_records` / `encode_records` (io/records.py), `forest_eval` (the
trees), `lattice_tokenize_bulk` (nlp/) and the sanitizer variants.
`pack_block` is left out too: the port's `core/batch.pack_rows` is a
vectorised numpy pack (PERF.md).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import build as _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

CALLS = {"murmur3": 0, "murmur3_bulk": 0, "parse_features_bulk": 0,
         "zigzag_leb128_encode": 0, "zigzag_leb128_decode": 0,
         "arow_reference_rowloop": 0, "fm_reference_rowloop": 0,
         "batch_apply_block": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_PROTOTYPES = {
    # name: (restype, argtypes)
    "hm_plan_abi_version": (_I64, []),
    "hm_murmur3_x86_32": (ctypes.c_int32,
                          [ctypes.c_char_p, _I64, ctypes.c_uint32]),
    "hm_murmur3_bulk": (None, [_P, _P, _I64, ctypes.c_uint32, _I64, _P]),
    "hm_zigzag_leb128_encode": (_I64, [_P, _I64, _P, _I64]),
    "hm_zigzag_leb128_decode": (_I64, [_P, _I64, _I64, _P]),
    "hm_parse_features_batch": (_I64, [_P, _P, _I64, _I64, _P, _P]),
    "hm_arow_reference_rowloop": (
        _I64, [_P, _P, _P, _I64, _I64, _F32, _P, _P, _P, _P, _P]),
    "hm_fm_reference_rowloop": (
        _I64, [_P, _P, _P, _I64, _I64, _I64, _F32, _F32, _P, _P, _P, _P]),
    "hm_batch_apply_block": (
        _I64, [ctypes.c_int32, _F32, _F32, _F32, _P, _P, _I64, _I64,
               _I64, _I64, _I64, _P, _P, _P, _P, _P, _I64, _I64,
               _P, _P, _P, _P, _P, _I64, _P, _P, _P, ctypes.c_int32, _P]),
}


def _open(path) -> ctypes.CDLL:
    """Load the library at `path`, declare every prototype, and hold its
    plan ABI against ops/scatter.py's; RuntimeError on any mismatch."""
    from ..ops.scatter import PLAN_ABI_VERSION

    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _PROTOTYPES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    native_ver = int(lib.hm_plan_abi_version())
    if native_ver != PLAN_ABI_VERSION:
        raise RuntimeError(f"plan ABI version mismatch: {path} was "
                           f"compiled with {native_ver}, ops/scatter.py "
                           f"expects {PLAN_ABI_VERSION}")
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library, built at first use. Raises RuntimeError (the
    compiler's output, or the ABI mismatch) when it cannot be had."""
    global _lib, _load_error
    with _lock:
        if _lib is None:
            try:
                _lib = _open(_build.build())
                _load_error = None
            except (RuntimeError, OSError, AttributeError) as e:
                _load_error = str(e)
                raise RuntimeError(
                    f"hivemall_tpu_torch.native: {e}") from e
        return _lib


def library_path() -> str:
    """The file the loaded library came from."""
    return _load()._name


def load_error() -> Optional[str]:
    """Why the last attempt to build or load the library failed, or None
    when none has failed since it last loaded. Builds nothing."""
    return _load_error


# rule-family ids of hm_batch_apply_block's native closed forms — the ABI's
# rule enum, mirrored (native/hivemall_native.cpp HM_BATCH_RULE_*)
BATCH_APPLY_RULES = {"perceptron": 0, "cw": 1, "arow": 2, "arowh": 3}
# hyperparameters each native form REQUIRES: a missing one must raise like
# the rule's hyper["..."] KeyError would, never default to a silently
# degenerate 0.0 (phi=0 freezes CW entirely)
_BATCH_APPLY_REQUIRED_HYPER = {"perceptron": (), "cw": ("phi",),
                               "arow": ("r",), "arowh": ("r", "c")}


def _ptr(a: Optional[np.ndarray]):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def batch_apply_block(rule_name: str, hyper: dict, values: np.ndarray,
                      labels: np.ndarray, main_plan, tail_plan, dims: int,
                      weights: np.ndarray, covars: Optional[np.ndarray],
                      touched: Optional[np.ndarray],
                      mini_batch_average: bool = True) -> float:
    """Apply one staged block through hm_batch_apply_block: gather ->
    batch closed form -> segment-reduce -> scatter-back in one native call,
    mutating the host f32 tables in place.

    `main_plan` is the block's stacked StagedDedupPlan ([nb, ...] leading
    axis, core/batch_update.py::BlockPlans.main) or None; `tail_plan` the
    remainder chunk's plan or None. Plans must satisfy the frozen ABI
    (ops/scatter.py::plan_abi_arrays: host int32, C-contiguous); values
    [n_rows, width] f32, labels [n_rows] f32. Returns the block's loss sum.
    Raises on a rule outside BATCH_APPLY_RULES or malformed plan / table
    arguments."""
    if rule_name not in BATCH_APPLY_RULES:
        raise ValueError(f"no native batch closed form for rule "
                         f"{rule_name!r} (supported: "
                         f"{sorted(BATCH_APPLY_RULES)})")
    missing = [h for h in _BATCH_APPLY_REQUIRED_HYPER[rule_name]
               if h not in hyper]
    if missing:
        raise KeyError(f"rule {rule_name!r} requires hyperparameter(s) "
                       f"{missing} — same contract as the rule's "
                       f"hyper[...] access")
    from ..ops.scatter import plan_abi_arrays

    values = np.ascontiguousarray(values, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    n_rows, width = values.shape
    if labels.shape != (n_rows,):
        raise ValueError(f"labels shape {labels.shape} != ({n_rows},) for "
                         f"values {values.shape}")
    nb = bsz = slots_u = 0
    mo = mls = mrep = mst = men = None
    if main_plan is not None:
        mo, mls, mrep, mst, men = plan_abi_arrays(main_plan, stacked=True)
        nb, lanes = mo.shape
        slots_u = mrep.shape[1]
        bsz = lanes // width
    tail_rows = tail_u = 0
    to = tls = trep = tst = ten = None
    if tail_plan is not None:
        to, tls, trep, tst, ten = plan_abi_arrays(tail_plan)
        tail_rows = to.shape[0] // width
        tail_u = trep.shape[0]
    for name, t, dt in (("weights", weights, np.float32),
                        ("covars", covars, np.float32),
                        ("touched", touched, np.int8)):
        if t is None:
            continue
        if t.dtype != dt or not t.flags["C_CONTIGUOUS"]:
            raise ValueError(f"native batch apply needs C-contiguous "
                             f"{np.dtype(dt).name} {name} table, got "
                             f"{t.dtype}")
        if t.shape[0] < dims:
            # the C pass writes any rp < dims: a short table would be
            # heap corruption, not a drop — fail at the boundary
            raise ValueError(f"{name} table has {t.shape[0]} rows < dims "
                             f"{dims}")
    lib = _load()
    loss = ctypes.c_double(0.0)
    CALLS["batch_apply_block"] += 1
    rc = lib.hm_batch_apply_block(
        BATCH_APPLY_RULES[rule_name],
        ctypes.c_float(float(hyper.get("r", 0.0))),
        ctypes.c_float(float(hyper.get("c", 0.0))),
        ctypes.c_float(float(hyper.get("phi", 0.0))),
        _ptr(values), _ptr(labels), n_rows, width,
        nb, bsz, slots_u, _ptr(mo), _ptr(mls), _ptr(mrep), _ptr(mst),
        _ptr(men), tail_rows, tail_u, _ptr(to), _ptr(tls), _ptr(trep),
        _ptr(tst), _ptr(ten), dims, _ptr(weights), _ptr(covars),
        _ptr(touched), 1 if mini_batch_average else 0,
        ctypes.byref(loss))
    if rc != 0:
        raise ValueError("hm_batch_apply_block rejected its arguments "
                         f"(rc={rc}): rule/plan/table mismatch")
    return float(loss.value)


def murmur3(data: bytes, seed: int = 0x9747B28C) -> int:
    lib = _load()
    CALLS["murmur3"] += 1
    return int(lib.hm_murmur3_x86_32(data, len(data), seed))


def _pack_bytes(items: Sequence[bytes]):
    """Concatenate byte strings into (ctypes buffer, int64 offsets[n+1]) —
    the marshalling shape every bulk string entry point shares."""
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, items), np.int64, len(items)),
              out=offsets[1:])
    buf = b"".join(items)
    return ctypes.create_string_buffer(buf, len(buf) or 1), offsets


def murmur3_bulk(strings: Sequence[bytes], num_features: int,
                 seed: int = 0x9747B28C) -> np.ndarray:
    lib = _load()
    n = len(strings)
    cbuf, offsets = _pack_bytes(strings)
    out = np.empty(n, dtype=np.int64)
    CALLS["murmur3_bulk"] += 1
    lib.hm_murmur3_bulk(ctypes.cast(cbuf, ctypes.c_void_p), _ptr(offsets),
                        n, seed, num_features, _ptr(out))
    return out


def zigzag_leb128_encode(values: np.ndarray) -> bytes:
    lib = _load()
    vals = np.ascontiguousarray(values, dtype=np.int64)
    cap = 10 * len(vals)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    CALLS["zigzag_leb128_encode"] += 1
    written = lib.hm_zigzag_leb128_encode(_ptr(vals), len(vals), _ptr(out),
                                          cap)
    if written < 0:
        raise ValueError("zigzag-leb128 encode overflow")
    return out[:written].tobytes()


def zigzag_leb128_decode(buf: bytes, n: int) -> np.ndarray:
    """Decode n values; ValueError on a corrupt stream or a value past 64
    bits (the caller's Python path owns those)."""
    lib = _load()
    data = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(max(n, 1), dtype=np.int64)
    CALLS["zigzag_leb128_decode"] += 1
    consumed = lib.hm_zigzag_leb128_decode(_ptr(data), len(data), n,
                                           _ptr(out))
    if consumed < 0:
        raise ValueError("corrupt zigzag-leb128 stream")
    return out[:n]


def _numeric_name(token: str) -> bool:
    """True for a non-ASCII token whose name holds Unicode decimals or
    spaces: Python's int() would direct-index it, which the C scan cannot
    see. Ordinary non-ASCII names stay on the fast path."""
    return any(ch.isdecimal() or ch.isspace()
               for ch in token.split(":", 1)[0])


def parse_features_bulk(rows: Sequence[Sequence[str]], num_features: int
                        ) -> Optional[Tuple[List[np.ndarray],
                                            List[np.ndarray]]]:
    """Bulk-parse rows of "name[:value]" tokens through the C parser
    (hm_parse_features_batch): one concatenated buffer in, flat idx/val
    arrays out, re-split per row. Returns None when a token falls outside
    the canonical grammar, or a row holds a tuple feature or a non-ASCII
    numeric name (the caller's Python parser keeps error behavior and
    exotic-literal handling identical)."""
    lib = _load()
    row_lens = np.fromiter(map(len, rows), np.int64, len(rows))
    toks = [t for row in rows for t in row]
    if any(type(t) is not str for t in toks):
        return None  # (name, value) tuples etc. -> Python path
    enc = [t.encode("utf-8") for t in toks]
    # more bytes than characters: some token is non-ASCII
    if sum(map(len, enc)) != sum(map(len, toks)) and any(
            _numeric_name(t) for t in toks if not t.isascii()):
        return None
    n = len(enc)
    cbuf, offsets = _pack_bytes(enc)
    out_idx = np.empty(n, dtype=np.int64)
    out_val = np.empty(n, dtype=np.float32)
    CALLS["parse_features_bulk"] += 1
    rc = lib.hm_parse_features_batch(
        ctypes.cast(cbuf, ctypes.c_void_p), _ptr(offsets), n, num_features,
        _ptr(out_idx), _ptr(out_val))
    if rc != 0:
        return None
    bounds = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(row_lens, out=bounds[1:])
    idx_rows = [out_idx[bounds[r]:bounds[r + 1]] for r in range(len(rows))]
    val_rows = [out_val[bounds[r]:bounds[r + 1]] for r in range(len(rows))]
    return idx_rows, val_rows


def arow_reference_rowloop(idx: np.ndarray, val: np.ndarray,
                           labels: np.ndarray, dims: int, r: float = 0.1,
                           state: Optional[dict] = None,
                           track_touched: bool = False) -> int:
    """Run the reference's per-row AROW loop (C transliteration of
    AROWClassifierUDTF.java:99-150 + DenseModel.java:193-201 set
    bookkeeping) over [n_rows, width] blocks. Mutates (or allocates) the
    flat model arrays in `state`, reused across calls; returns the
    margin-violation count.

    `track_touched`: keep a monotone uint8 `state["touch"]` was-ever-set
    flag per feature, the -native_scan backend's model-emission mask (the
    clocks / deltas wrap like the reference's short / byte counters and
    cannot serve as touched)."""
    lib = _load()
    n_rows, width = idx.shape
    if state is None:
        state = {}
    if "w" not in state:
        state["w"] = np.zeros(dims, np.float32)
        state["cov"] = np.ones(dims, np.float32)
        state["clocks"] = np.zeros(dims, np.int16)
        state["deltas"] = np.zeros(dims, np.int8)
    if track_touched and "touch" not in state:
        state["touch"] = np.zeros(dims, np.uint8)
    idx = np.ascontiguousarray(idx, np.int32)
    val = np.ascontiguousarray(val, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    CALLS["arow_reference_rowloop"] += 1
    return int(lib.hm_arow_reference_rowloop(
        _ptr(idx), _ptr(val), _ptr(labels), n_rows, width,
        ctypes.c_float(r), _ptr(state["w"]), _ptr(state["cov"]),
        _ptr(state["clocks"]), _ptr(state["deltas"]),
        _ptr(state["touch"]) if track_touched else None))


def fm_reference_rowloop(idx: np.ndarray, val: np.ndarray,
                         labels: np.ndarray, dims: int, k: int = 5,
                         eta: float = 0.05, lam: float = 0.01,
                         state: Optional[dict] = None,
                         track_touched: bool = False) -> int:
    """Run the reference's per-row train_fm (classification) loop (C
    transliteration of FactorizationMachineUDTF.java:369-393 trainTheta;
    fixed eta, defaults eta0=0.05 lambda=0.01 per FMHyperParameters.java:
    30-70), the -native_scan FM backend's body with `track_touched`.
    Returns the sign-error count."""
    lib = _load()
    n_rows, width = idx.shape
    if state is None:
        state = {}
    if "w" not in state:
        rng = np.random.RandomState(42)
        state["w0"] = np.zeros(1, np.float32)
        state["w"] = np.zeros(dims, np.float32)
        # sigma=0.1 gaussian rankinit like the reference default
        state["V"] = (0.1 * rng.randn(dims, k)).astype(np.float32)
    if track_touched and "touch" not in state:
        state["touch"] = np.zeros(dims, np.uint8)
    idx = np.ascontiguousarray(idx, np.int32)
    val = np.ascontiguousarray(val, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    CALLS["fm_reference_rowloop"] += 1
    rc = int(lib.hm_fm_reference_rowloop(
        _ptr(idx), _ptr(val), _ptr(labels), n_rows, width, k,
        ctypes.c_float(eta), ctypes.c_float(lam),
        _ptr(state["w0"]), _ptr(state["w"]), _ptr(state["V"]),
        _ptr(state["touch"]) if track_touched else None))
    if rc < 0:
        raise ValueError("fm reference rowloop: k > 64 unsupported")
    return rc
