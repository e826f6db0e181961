"""ctypes bindings of the native host library (native/hivemall_native.cpp).

The counterpart of the JAX package's `native/__init__.py`, with its
function names, argument order and return conventions: bulk murmur3
hashing, bulk feature parsing, the zigzag-LEB128 codec, the per-row AROW
and FM loops behind `-native_scan`, the batched apply behind
`-batch B -native_apply`, and the bulk evaluator of exported tree opcode
programs (`forest_eval`). Everything here runs on the host, on numpy
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

`lattice_tokenize_bulk` runs the Japanese lattice Viterbi over many texts
(nlp/lattice.py marshals the lexicon). `decode_records` /
`encode_records` are the HMTR1 record-shard codec of io/records.py.

`available()` says whether the library builds and loads (building it at
first call); `load_error()` says why it did not. Every binding still
raises where the library cannot be had: `available()` is a probe for a
caller that asks, never a path that turns a build error into a quiet
fallback.

Not bound here: the sanitizer variants (a build of the JAX package's
scripts, not of the port's `native/build.py`), and `pack_block`: the
port's `core/batch.pack_rows` is a vectorised numpy pack (PERF.md).

No binding carries on in numpy when the library fails to build or load:
the module opts into graftcheck's exception-flow rules, whose G028/G029
flag a quiet fallback.

# graftcheck: failure-path-module
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
         "batch_apply_block": 0, "forest_eval": 0,
         "lattice_tokenize_bulk": 0, "decode_records": 0,
         "encode_records": 0}

def _declare(lib: ctypes.CDLL) -> None:
    """Every prototype the port calls, one literal declaration per symbol
    (the JAX package's form), so that graftcheck's G024-G026 read each one
    and G025 holds it against its definition in hivemall_native.cpp
    (python -m hivemall_tpu_torch.analysis). An absent symbol raises
    AttributeError, which _load reports as a load failure."""
    lib.hm_plan_abi_version.restype = ctypes.c_int64
    lib.hm_plan_abi_version.argtypes = []
    lib.hm_murmur3_x86_32.restype = ctypes.c_int32
    lib.hm_murmur3_x86_32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_uint32]
    lib.hm_murmur3_bulk.restype = None
    lib.hm_murmur3_bulk.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.hm_decode_records.restype = ctypes.c_int64
    lib.hm_decode_records.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hm_encode_records_bound.restype = ctypes.c_int64
    lib.hm_encode_records_bound.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.hm_encode_records.restype = ctypes.c_int64
    lib.hm_encode_records.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.hm_zigzag_leb128_encode.restype = ctypes.c_int64
    lib.hm_zigzag_leb128_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.hm_zigzag_leb128_decode.restype = ctypes.c_int64
    lib.hm_zigzag_leb128_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.hm_parse_features_batch.restype = ctypes.c_int64
    lib.hm_parse_features_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hm_arow_reference_rowloop.restype = ctypes.c_int64
    lib.hm_arow_reference_rowloop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hm_fm_reference_rowloop.restype = ctypes.c_int64
    lib.hm_fm_reference_rowloop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.hm_batch_apply_block.restype = ctypes.c_int64
    lib.hm_batch_apply_block.argtypes = [
        ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.hm_forest_eval.restype = ctypes.c_int64
    lib.hm_forest_eval.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.hm_lattice_tokenize_bulk.restype = ctypes.c_int64
    lib.hm_lattice_tokenize_bulk.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]


def _open(path) -> ctypes.CDLL:
    """Load the library at `path`, declare every prototype, and hold its
    plan ABI against ops/scatter.py's; RuntimeError on any mismatch."""
    from ..ops.scatter import PLAN_ABI_VERSION

    lib = ctypes.CDLL(str(path))
    _declare(lib)
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


def available() -> bool:
    """True when the library builds (at first call) and loads; False with
    the reason kept in `load_error()`. A probe only: the bindings raise
    RuntimeError themselves when the library cannot be had."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def has_batch_apply() -> bool:
    """True when the loaded library exports the batched-apply entry point
    (hm_batch_apply_block), the -native_apply backend's probe. The port
    builds its library from the one source, so this is `available()`."""
    return available() and hasattr(_load(), "hm_batch_apply_block")


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


def decode_records(body: bytes, n_rows: int):
    """Decode an HMTR1 shard body (io/records.py) -> (row_offsets [n+1]
    int64, indices int64, values f32, labels [n] f32). ValueError("corrupt
    record shard") on a truncated or malformed body. The JAX package
    returns None without its library; the port raises (module
    docstring)."""
    lib = _load()
    buf = np.frombuffer(body, dtype=np.uint8)
    CALLS["decode_records"] += 1
    total = lib.hm_decode_records(_ptr(buf), len(body), n_rows, None, None,
                                  None, None)
    if total < 0:
        raise ValueError("corrupt record shard")
    offsets = np.empty(n_rows + 1, np.int64)
    indices = np.empty(total, np.int64)
    values = np.empty(total, np.float32)
    labels = np.empty(n_rows, np.float32)
    out = lib.hm_decode_records(_ptr(buf), len(body), n_rows, _ptr(offsets),
                                _ptr(indices), _ptr(values), _ptr(labels))
    if out != total:
        raise ValueError("corrupt record shard")
    return offsets, indices, values, labels


def encode_records(idx_rows: Sequence[np.ndarray],
                   val_rows: Sequence[np.ndarray],
                   labels: np.ndarray) -> bytes:
    """Encode rows to an HMTR1 shard body, each row sorted by feature id
    (stable: equal ids keep their input order). Raises ValueError on
    nnz > 255 or a negative id, as the JAX package does."""
    lib = _load()
    n = len(idx_rows)
    if len(val_rows) != n or len(labels) != n:
        raise ValueError("idx_rows/val_rows/labels length mismatch")
    lens = np.fromiter(map(len, idx_rows), np.int64, n)
    vlens = np.fromiter(map(len, val_rows), np.int64, n)
    if not np.array_equal(lens, vlens):
        i = int(np.nonzero(lens != vlens)[0][0])
        raise ValueError(f"row {i}: {lens[i]} indices vs {vlens[i]} values")
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    indices = (np.ascontiguousarray(
        np.concatenate(idx_rows).astype(np.int64, copy=False)) if n else
        np.zeros(0, np.int64))
    values = (np.ascontiguousarray(
        np.concatenate(val_rows).astype(np.float32, copy=False)) if n else
        np.zeros(0, np.float32))
    labs = np.ascontiguousarray(labels, dtype=np.float32)
    cap = int(lib.hm_encode_records_bound(_ptr(offsets), n))
    out = np.empty(max(cap, 1), dtype=np.uint8)
    CALLS["encode_records"] += 1
    written = lib.hm_encode_records(_ptr(indices), _ptr(values),
                                    _ptr(offsets), _ptr(labs), n, _ptr(out),
                                    cap)
    if written < 0:
        raise ValueError("row nnz > 255 or negative feature id")
    return out[:written].tobytes()


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


def forest_eval(programs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                X: np.ndarray) -> np.ndarray:
    """Evaluate T compiled opcode programs (models/trees/vm.py
    compile_script_arrays output) over X [N, F] raw rows -> [T, N] float64
    leaf values, StackMachine's semantics. Raises ValueError on a malformed
    program (an out-of-range operand, a stack fault, a revisited op)."""
    lib = _load()
    T = len(programs)
    X = np.ascontiguousarray(X, dtype=np.float64)
    N, F = X.shape
    offsets = np.zeros(T + 1, np.int64)
    for t, (ops, _, _) in enumerate(programs):
        offsets[t + 1] = offsets[t] + len(ops)
    ops = np.ascontiguousarray(np.concatenate([p[0] for p in programs]),
                               dtype=np.int8)
    argi = np.ascontiguousarray(np.concatenate([p[1] for p in programs]),
                                dtype=np.int32)
    argf = np.ascontiguousarray(np.concatenate([p[2] for p in programs]),
                                dtype=np.float64)
    out = np.empty((T, N), np.float64)
    CALLS["forest_eval"] += 1
    rc = lib.hm_forest_eval(_ptr(ops), _ptr(argi), _ptr(argf), _ptr(offsets),
                            T, _ptr(X), N, F, _ptr(out))
    if rc != 0:
        raise ValueError("malformed opcode program")
    return out


def lattice_tokenize_bulk(cps: np.ndarray, classes: np.ndarray,
                          text_offsets: np.ndarray,
                          surf_buf: np.ndarray, surf_offsets: np.ndarray,
                          entry_offsets: np.ndarray, entry_pos: np.ndarray,
                          entry_cost: np.ndarray, max_word: int,
                          conn: np.ndarray,
                          unk_base: np.ndarray, unk_per: np.ndarray,
                          unk_pos: np.ndarray):
    """Bulk lattice Viterbi (hm_lattice_tokenize_bulk); the caller
    (nlp/lattice.py, which owns the lexicon encoding) marshals the tables.
    Returns (starts, lens, pos_ids, counts), or None where the JAX package
    returns None with its library loaded: the native pass reports a corrupt
    lattice, and the caller takes its Python path."""
    lib = _load()
    # pin every buffer to the ABI's dtype and C order: the native pass
    # reads them at fixed widths
    cps = np.ascontiguousarray(cps, np.uint32)
    classes = np.ascontiguousarray(classes, np.uint8)
    text_offsets = np.ascontiguousarray(text_offsets, np.int64)
    surf_buf = np.ascontiguousarray(surf_buf, np.uint32)
    surf_offsets = np.ascontiguousarray(surf_offsets, np.int64)
    entry_offsets = np.ascontiguousarray(entry_offsets, np.int64)
    entry_pos = np.ascontiguousarray(entry_pos, np.int16)
    entry_cost = np.ascontiguousarray(entry_cost, np.int32)
    conn = np.ascontiguousarray(conn, np.int32)
    unk_base = np.ascontiguousarray(unk_base, np.int32)
    unk_per = np.ascontiguousarray(unk_per, np.int32)
    unk_pos = np.ascontiguousarray(unk_pos, np.int16)
    n_texts = len(text_offsets) - 1
    total_chars = int(text_offsets[-1])
    out_start = np.empty(max(total_chars, 1), np.int32)
    out_len = np.empty(max(total_chars, 1), np.int32)
    out_pos = np.empty(max(total_chars, 1), np.int16)
    out_counts = np.empty(max(n_texts, 1), np.int64)
    CALLS["lattice_tokenize_bulk"] += 1
    rc = lib.hm_lattice_tokenize_bulk(
        _ptr(cps), _ptr(classes), _ptr(text_offsets), n_texts,
        _ptr(surf_buf), _ptr(surf_offsets), _ptr(entry_offsets),
        _ptr(entry_pos), _ptr(entry_cost), len(surf_offsets) - 1,
        int(max_word), _ptr(conn), conn.shape[0],
        _ptr(unk_base), _ptr(unk_per), _ptr(unk_pos),
        _ptr(out_start), _ptr(out_len), _ptr(out_pos), _ptr(out_counts))
    if rc < 0:
        return None
    return out_start[:rc], out_len[:rc], out_pos[:rc], out_counts
