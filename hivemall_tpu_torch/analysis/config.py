"""Codebase-specific knobs for the port's graftcheck rules.

Only the constants that this package's modules read: the module model's
trace and taint vocabulary, the dtype-flow rules' scopes, the concurrency
rules' scope and blocking-call tables, the FFI rules' symbol prefix,
validators and C sources, and the exception-flow rules' scope, loud
surfaces and backoff calls — all pointed at the port's tree
(``hivemall_tpu_torch/``).
"""

from __future__ import annotations

import re

# --- module model (modmodel.py): traced functions and device-value taint ---
# The model keeps the JAX package's trace/taint walker so that its rules
# read the same facts; no torch code is traced, so in the port these mark
# only a stray jax-style wrapper. G013 reads JITTED_ATTR_CALLEES too.
SYNC_CALLS = ("float", "int", "bool")
SYNC_METHODS = ("item", "tolist")

# `step = make_train_step(...)` / `predict = make_predict(...)`: calling the
# result yields device values. Matched against the callee name.
JITTED_FACTORY_RE = re.compile(
    r"^make_\w*(step|epoch|predict|train_fn|mix|fn)\w*$")

# Attribute callees whose results are device values (trainer convention:
# `self._step(...)` dispatches the step's device work).
JITTED_ATTR_CALLEES = ("_step", "step")

# Transforms whose function argument is traced when called.
TRACING_TRANSFORMS = (
    "jit", "vmap", "pmap", "shard_map", "scan", "cond", "while_loop",
    "fori_loop", "checkpoint", "remat", "grad", "value_and_grad", "custom_vjp",
)

# Calls whose RESULT is host data even when arguments are device values.
UNTAINT_CALLS = ("device_get", "shape", "len", "range", "eval_shape",
                 "tree_structure")

# Methods with these names receive device state / blocks by contract; the
# dtype-flow rules count them as per-step code (dtypeflow.in_hot_scope).
HOT_FN_RE = re.compile(r"^(step|_step|train_step|epoch)$")

# --- program model (program.py) ---------------------------------------------
# Collective calls whose axis argument the per-function summaries record.
COLLECTIVE_CALLS = ("psum", "pmean", "pmax", "pmin", "all_gather",
                    "axis_index", "ppermute", "psum_scatter", "pcast")

# --- G003: dtype-sensitive scopes ------------------------------------------
# Modules whose math feeds weight updates: float64 here doubles the bytes
# every step moves, and an unpinned literal can turn an integer operand into
# the default float (models/base.py keeps tables f32, bf16 above 2^24 dims).
DTYPE_MODULE_PREFIXES = (
    "hivemall_tpu_torch/ops/",
    "hivemall_tpu_torch/core/",
    "hivemall_tpu_torch/models/",
    "hivemall_tpu_torch/kernels/",
)
# Update-math modules where even host-side helper functions are checked for
# unpinned float literals (their outputs flow straight into rule updates).
DTYPE_MATH_MODULES = (
    "hivemall_tpu_torch/ops/eta.py",
    "hivemall_tpu_torch/ops/losses.py",
)

# --- G017-G021: dtype / precision flow --------------------------------------
# Hot-path scopes for the dtype-flow rules: a silent widening here doubles
# the card's memory traffic on every step/request. The kernel/op packages
# and the serving score path are always hot; elsewhere in the
# dtype-sensitive packages only traced / step-shaped functions are
# (dtypeflow.in_hot_scope).
DTYPEFLOW_HOT_PREFIXES = (
    "hivemall_tpu_torch/ops/",
    "hivemall_tpu_torch/kernels/",
)
# The reference's seven always-hot modules, at the port's paths: the
# dequant-free score path (engine.py's int8 / bf16 scorers, the sharded
# and top-K retrieval scorers), the hot-row score cache (cached values are
# the engine's predictions, bit for bit), the quantization pack/unpack
# helpers of io/checkpoint.py, the segment-sum batched trainer and the
# native-apply staging layer, whose host f32 tables cross the ctypes ABI —
# a silent widening or a float64 temporary in any of them doubles the very
# traffic the module exists to cut.
DTYPEFLOW_HOT_MODULES = ("hivemall_tpu_torch/serving/engine.py",
                         "hivemall_tpu_torch/serving/cache.py",
                         "hivemall_tpu_torch/serving/sharded.py",
                         "hivemall_tpu_torch/serving/retrieval.py",
                         "hivemall_tpu_torch/io/checkpoint.py",
                         "hivemall_tpu_torch/core/batch_update.py",
                         "hivemall_tpu_torch/core/native_batch.py")
HOT_MARKER = "# graftcheck: hot-module"

# G018 scope: the serving/request path plus checkpoint IO — a float64 numpy
# value (or a float64-by-default constructor) here doubles payload and table
# bandwidth, and `torch.as_tensor` carries it to the card as float64.
# Modules outside opt in with the serving-module marker (shared with G013 —
# both guard the same request path).
DTYPEFLOW_SERVING_PREFIXES = (
    "hivemall_tpu_torch/serving/",
    "hivemall_tpu_torch/io/",
)

# G020 scope: artifact/checkpoint save->load modules whose reloads must pin
# the manifest dtype (a bf16 table widened to f32 at rest must narrow back
# on load, not silently serve wide).
ARTIFACT_IO_MODULES = (
    "hivemall_tpu_torch/io/checkpoint.py",
    "hivemall_tpu_torch/serving/artifact.py",
    "hivemall_tpu_torch/serving/engine.py",
    "hivemall_tpu_torch/serving/sharded.py",
)
ARTIFACT_MARKER = "# graftcheck: artifact-io"

# --- G012-G016: concurrency / serving safety --------------------------------
# Constructors whose result is a lock object; the kind decides reentrancy
# (plain Lock is non-reentrant; Condition() wraps an RLock by default).
LOCK_CONSTRUCTOR_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Semaphore": "lock",
    "BoundedSemaphore": "lock",
}

# Method calls on a field that mutate the underlying container — counted as
# WRITES by the guarded-by inference (`self._q.append(x)` races exactly like
# `self._q = ...`).
MUTATOR_METHODS = ("append", "appendleft", "extend", "insert", "add",
                   "discard", "remove", "clear", "update", "setdefault",
                   "pop", "popleft", "popitem", "sort")

# G013 scope: the serving hot path — a blocking call under a lock here stalls
# every in-flight request at once (the hot-swap-stall failure mode). Modules
# outside the list opt in with the marker comment. The continuous-training
# pipeline is in scope by prefix: its worker thread shares the registry with
# request handlers, so a freeze/gate/deploy under its lock would stall
# every concurrent status()/lineage read exactly when a swap is in flight.
# The observability stack (metrics registry + endpoint, time-series
# sampler, SLO engine) is hot the same way: the sampler thread, ring
# listeners and HTTP scrape handlers all take its locks concurrently with
# request handlers.
CONCURRENCY_HOT_PREFIXES = ("hivemall_tpu_torch/serving/",
                            "hivemall_tpu_torch/pipeline/",
                            "hivemall_tpu_torch/runtime/metrics",
                            "hivemall_tpu_torch/runtime/timeseries",
                            "hivemall_tpu_torch/runtime/slo")
CONCURRENCY_MARKER = "# graftcheck: serving-module"

# Blocking-call classification for G013 (tails of dotted callees).
# The device syncs are torch's: `torch.cuda.synchronize()` and
# `Stream/Event.synchronize()` wait for the card; `.item()` and `.cpu()`
# copy a device tensor to the host and wait for every kernel queued before
# them. The analyzer sees no types, so these tails count on any receiver:
# `.item()` on a numpy scalar or array and `.cpu()` on a tensor already on
# the host are flagged too under a lock in scope. That costs a suppression
# (with its reason) at such a line; the port's locked regions call neither.
BLOCKING_DEVICE_TAILS = ("synchronize", "item", "cpu")
BLOCKING_IO_TAILS = ("sleep", "urlopen", "connect", "accept", "recv",
                     "sendall", "getaddrinfo", "fsync")
# Future/thread rendezvous: .result() blocks on completion; set_result /
# set_exception run done-callbacks synchronously on the calling thread.
BLOCKING_FUTURE_TAILS = ("result", "set_result", "set_exception", "join",
                         "wait")
# Device dispatch and first-use work under a lock: an engine's warm-up
# sweep (every bucket run on the card, allocator segments grown),
# predict / a servable's padded run (the device dispatch of a request),
# and CUDA-graph capture (`torch.cuda.CUDAGraph.capture_begin`,
# `torch.cuda.make_graphed_callables`), which runs the captured work once.
BLOCKING_JIT_TAILS = ("warmup", "predict", "predict_fn", "run_padded",
                      "capture_begin", "make_graphed_callables")
# Roots whose methods share tails with the blocking list but never block
# (os.path.join, np ops, json/re parsing).
BLOCKING_SAFE_ROOTS = ("os", "np", "numpy", "json", "re", "posixpath",
                       "ntpath", "shutil", "sys", "math")

# --- G022-G026: FFI boundary ------------------------------------------------
# Exported symbols of the native host library and of the CUDA kernels'
# extern "C" block all share this prefix; any dotted call whose tail
# matches is a foreign call.
FFI_SYMBOL_PREFIXES = ("hm_",)
# Callees whose results are sanctioned pointer sources: they raise on any
# dtype/rank/contiguity violation, so arrays unpacked from them are
# ABI-proven (ops/scatter.py plan_abi_arrays — the frozen plan ABI's gate).
FFI_SANCTIONING_VALIDATORS = ("plan_abi_arrays",)
# numpy constructors whose result is always freshly allocated C-contiguous;
# with an explicit dtype they fully validate a pointer source.
FFI_FRESH_CTORS = ("empty", "zeros", "ones", "full", "frombuffer")
# The Python-side plan ABI version constant (ops/scatter.py) checked by
# G025 against the C side's HM_PLAN_ABI_VERSION literal.
FFI_ABI_VERSION_CONSTANT = "PLAN_ABI_VERSION"
# The C sources G025 cross-checks the ctypes declarations against, each
# with the env var that overrides its repo-root-relative default: the
# native host library, and the CUDA kernels' extern "C" block. Tests seed
# deliberate drift through a tempdir copy named by the env var.
FFI_NATIVE_CPP_ENV = "GRAFTCHECK_NATIVE_CPP"
FFI_NATIVE_CPP_DEFAULT = "native/hivemall_native.cpp"
FFI_KERNEL_CU_ENV = "GRAFTCHECK_KERNEL_CU"
FFI_KERNEL_CU_DEFAULT = "hivemall_tpu_torch/kernels/csrc/linear_scan.cu"

# --- G027-G031: exception flow / failure paths ------------------------------
# Failure-path scope: the serving request path, the continuous-training
# pipeline, and the whole runtime package (recovery driver, fault injector,
# tracing, metrics, debug bundles) — the code whose exception paths the
# port's reliability depends on. A Future leaked on an unwind here hangs a
# client forever; a silent fallback hides a degradation until a run
# regresses. Modules outside the prefixes opt in with the marker comment:
# the kernels' build and launch, the device choice and the native host
# library carry it, so that no code there carries on on the CPU or on a
# plain version when a kernel fails to build or launch.
EXCEPTION_HOT_PREFIXES = (
    "hivemall_tpu_torch/serving/",
    "hivemall_tpu_torch/pipeline/",
    "hivemall_tpu_torch/runtime/",
)
EXCEPTION_MARKER = "# graftcheck: failure-path-module"

# Handler calls that count as a LOUD surface for G028: the fallback names
# its reason somewhere an operator can see (warnings / logging / the trace
# ring's `TRACER.instant` / the metrics registry's `increment`).
LOUD_CALL_TAILS = ("warn", "warning", "warn_explicit", "error", "exception",
                   "critical", "fatal", "instant", "increment")
LOUD_CALL_ROOTS = ("warnings", "logging")

# Handler types whose silent fallback is the sanctioned API-probing idiom
# (compat shims, optional libraries) — a handler catching ONLY these is
# never a G028 degraded path.
PROBE_EXCEPTION_TYPES = frozenset({
    "ImportError", "ModuleNotFoundError", "AttributeError",
})

# Retry backoff classification for G031 (tails of dotted callees).
# cv.wait(timeout) counts: blocking on a condition variable IS the
# well-behaved form of waiting between attempts.
BACKOFF_CALL_TAILS = ("sleep", "wait")
