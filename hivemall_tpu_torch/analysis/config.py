"""Codebase-specific knobs for the port's graftcheck rules.

Only the constants that this package's modules read: the module model's
capture and taint vocabulary, the retrace rules' scopes and tables, the
collective rules' mesh file, axes and collective table, the dtype-flow
rules' scopes, the concurrency rules' scope and blocking-call tables, the
FFI rules' symbol prefix, validators and C sources, and the
exception-flow rules' scope, loud surfaces and backoff calls — all pointed
at the port's tree (``hivemall_tpu_torch/``).
"""

from __future__ import annotations

import re

# --- G002: modules whose loops are per-step hot paths -----------------------
# The per-step loops of these modules drive every trainer; an implicit
# device->host sync there stalls the launch stream once per step.
HOT_LOOP_MODULES = (
    "hivemall_tpu_torch/core/engine.py",
    "hivemall_tpu_torch/parallel/sharded_train.py",
    "hivemall_tpu_torch/parallel/mix.py",
    "hivemall_tpu_torch/models/trees/grow.py",
    # the epoch/convergence loop over the engine's steps
    "hivemall_tpu_torch/models/base.py",
)

# --- module model (modmodel.py): captures and device-value taint ------------
# A capture is code whose host Python runs once and whose device work is
# replayed: the port's counterpart of a jitted function (traceflow.py's
# docstring). The model's traced set holds the captured defs, beside the
# JAX package's jit/vmap/scan forms, which it keeps. G013 reads
# JITTED_ATTR_CALLEES too.
#
# Calls that force a device->host copy when applied to a device value.
# ``.cpu()`` / ``.tolist()`` of a whole value is the port's batched
# boundary read (jax.device_get's part): G002 flags it only per element
# (BOUNDARY_READ_METHODS); ``.item()`` / ``.numpy()`` are per value.
SYNC_CALLS = ("float", "int", "bool")
SYNC_NP_CALLS = ("asarray", "array")
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
BOUNDARY_READ_METHODS = ("cpu", "tolist")
# A call with this tail waits for the card whatever its arguments
# (``torch.cuda.synchronize()``, ``stream.synchronize()``).
SYNC_WAIT_TAILS = ("synchronize",)

# Wrappers whose function argument (or decorated def) is captured: its
# host Python runs once, at capture, and its device work is replayed.
CAPTURE_WRAPPERS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                    "torch.cuda.make_graphed_callables",
                    "make_graphed_callables")
# ``with torch.cuda.graph(g):`` — the block's body is a capture.
CAPTURE_CONTEXTS = ("torch.cuda.graph",)
# Calls that build a capture (G001(b), traceflow's sites): each one takes a
# fresh private memory pool, so one built per call or per iteration adds
# allocator segments every time.
CAPTURE_CONSTRUCTORS = ("torch.cuda.CUDAGraph", "torch.cuda.graph",
                        "torch.cuda.make_graphed_callables",
                        "make_graphed_callables", "torch.compile")
# torch.compile modes that replay CUDA graphs: their outputs are static
# buffers that the next call overwrites, like make_graphed_callables'.
GRAPHED_COMPILE_MODES = ("reduce-overhead", "max-autotune")
# Parameters of a captured def annotated with one of these are Python
# constants per capture (torch.compile guards on them), the port's
# counterpart of static_argnums.
STATIC_ANNOTATIONS = ("str", "bool", "int", "float")

# torch calls whose result is host data, and prefixes of torch namespaces
# whose calls the taint walker does not classify (their results follow
# their arguments); every other ``torch.*`` call yields a device value.
# A ``device="cpu"`` literal makes any constructor's result host data.
TORCH_HOST_CALLS = ("torch.from_numpy", "torch.device", "torch.Size",
                    "torch.is_tensor", "torch.finfo", "torch.iinfo",
                    "torch.get_default_dtype", "torch.manual_seed",
                    "torch.initial_seed", "torch.seed", "torch.Generator",
                    "torch.no_grad", "torch.inference_mode",
                    "torch.set_grad_enabled", "torch.is_grad_enabled",
                    "torch.promote_types", "torch.result_type")
TORCH_UNTRACKED_PREFIXES = ("torch.cuda.", "torch.backends.",
                            "torch.distributed.", "torch.utils.",
                            "torch.profiler.", "torch.jit.",
                            "torch.library.", "torch.testing.",
                            "torch.multiprocessing.", "torch.compiler.",
                            "torch._dynamo.")
# Callee names that declare a host result: a helper named like this copies
# its device input to the host in one read, so what it returns is host
# data (models/trees/grow.py's _split_to_host, all_gather_host).
HOST_RESULT_NAME_RE = re.compile(r"(to_host|device_get|gather_host)$")
# Tensor methods and attributes that read metadata only: no copy, no sync.
TENSOR_META_METHODS = ("size", "dim", "numel", "nelement", "element_size",
                       "data_ptr", "stride", "is_contiguous", "get_device",
                       "storage_offset", "is_floating_point")
TENSOR_META_ATTRS = ("shape", "dtype", "device", "ndim", "is_cuda",
                     "requires_grad", "layout")

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

# Methods with these names receive device state / blocks by contract, so
# G002 treats their parameters as device values even outside a loop; the
# dtype-flow rules count them as per-step code (dtypeflow.in_hot_scope).
HOT_FN_RE = re.compile(r"^(step|_step|train_step|epoch)$")

# --- G006: host side effects inside a capture --------------------------------
SIDE_EFFECT_CALLS = ("print",)
SIDE_EFFECT_ATTR_ROOTS = ("time", "logging")
SIDE_EFFECT_METHODS = ("increment", "set_gauge", "record")
SIDE_EFFECT_NP_RANDOM = ("random",)
# torch's host RNG: seeding it or building a CPU generator inside a
# capture happens once, at capture.
SIDE_EFFECT_TORCH_RNG = ("torch.manual_seed", "torch.seed",
                         "torch.random.manual_seed", "torch.random.seed")

# --- G032-G036: the retrace layer (traceflow.py) -----------------------------
# Modules whose capture call graphs the retrace rules sweep by default: the
# serving dispatch stack and the kernel/op layers every step and scorer
# funnels through. Anything else opts in with the marker comment.
TRACEFLOW_HOT_PREFIXES = (
    "hivemall_tpu_torch/ops/",
    "hivemall_tpu_torch/kernels/",
)
TRACEFLOW_HOT_MODULES = (
    "hivemall_tpu_torch/serving/engine.py",
    "hivemall_tpu_torch/serving/retrieval.py",
    "hivemall_tpu_torch/serving/sharded.py",
)
TRACEFLOW_MARKER = "# graftcheck: jit-hot-module"

# Module-level dicts recognized as sanctioned capture memos (the
# get-or-build idiom, ``_SCORER_JIT`` / ``_STEP_GRAPHS``): a function that
# both reads and writes one is a memo helper, and captures built under it
# are built once per key, not once per call.
TRACEFLOW_MEMO_NAME_RE = re.compile(r"^_[A-Z0-9_]*(JIT|GRAPH)[A-Z0-9_]*$")

# Function names sanctioned to build captures per CALL of the factory:
# factories invoked once at setup (make_*/build_*) and __init__. Calling one
# of these per hot-loop iteration is still churn (G032c).
TRACEFLOW_FACTORY_RE = re.compile(r"^_?(make|build)_\w+")

# Calls that canonicalize an array's shape onto the bucket ladder before it
# reaches a capture (G034): pad_to_bucket is the width calculator,
# bucket_rows and pad_rows_to_multiple the array-level canonicalizers; a
# bare pad is trusted as deliberate shape control.
SHAPE_CANONICALIZERS = ("pad_to_bucket", "bucket_rows", "pad_rows_to_multiple",
                        "pad")
# The port's bucketed dispatch entry points (G034): a servable's padded
# run is warmed per (batch, width) bucket, and a novel length reaching it
# adds allocator segments after warmup (serving/engine.py run_padded).
BUCKETED_DISPATCH_TAILS = ("run_padded",)

# Callee names that declare themselves host-sync boundaries (G036): a
# helper named like one of these syncs on purpose, as the loop's
# sanctioned whole-value boundary read.
TRACEFLOW_SYNC_NAME_RE = re.compile(
    r"(sync|block_until|device_get|to_host|fetch|drain|gather_host)",
    re.IGNORECASE)

# --- G004, G007, G008, G010, G011: the port's process meshes ----------------
# The module that declares the mesh axes (its *_AXIS string constants) and
# builds the meshes: make_mesh(axis_name=) and make_mesh_2d(replica_axis=,
# shard_axis=).
MESH_FILE = "hivemall_tpu_torch/parallel/mesh.py"
DEFAULT_AXIS_NAMES = frozenset({"workers", "shards"})

# The port's collective callees (core/collectives.py, and torch.distributed
# called directly), each with the positions of its axis and mesh arguments:
# psum(x, mesh, axis), pmean(x, mesh, axis), all_gather_host(x, mesh,
# axis), gather_fields(state, names, mesh, axis) and mesh.index(axis),
# JAX's axis_index, whose mesh is its receiver. An ``axis=`` /
# ``axis_name=`` / ``mesh=`` keyword wins over the position. The
# torch.distributed calls name a ``group=``, not an axis (None, None).
MESH_RECEIVER = "receiver"
COLLECTIVE_CALLS = {
    "psum": (2, 1),
    "pmean": (2, 1),
    "all_gather_host": (2, 1),
    "gather_fields": (3, 2),
    "index": (0, MESH_RECEIVER),
    "all_reduce": (None, None),
    "all_gather": (None, None),
    "all_gather_object": (None, None),
    "broadcast": (None, None),
    "barrier": (None, None),
    "reduce_scatter": (None, None),
}
# torch.distributed's collectives count only when called on the module
# (``dist.all_reduce``), and ``index`` only on a receiver named like a mesh
# (``mesh.index``, ``self.mesh.index``): a list's or a string's ``index``
# is no collective.
DIST_MODULES = ("dist", "torch.distributed")
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
                    "broadcast", "barrier", "reduce_scatter")
MESH_RECEIVER_RE = re.compile(r"(^|[._])mesh$", re.IGNORECASE)
# The collectives every rank of the group must reach (G011): all but the
# rank's own coordinate. The reducing ones (G010) combine the ranks'
# values into a whole.
RENDEZVOUS_COLLECTIVES = ("psum", "pmean", "all_gather_host",
                          "gather_fields") + DIST_COLLECTIVES
REDUCING_COLLECTIVES = ("psum", "pmean", "all_gather_host", "gather_fields",
                        "all_reduce", "all_gather", "all_gather_object",
                        "reduce_scatter")
# A mesh's per-axis lookups (G008): ``mesh.shape[axis]``,
# ``mesh.coords[axis]`` and ``mesh.groups[axis]`` raise KeyError on the
# ranks for an axis the mesh does not bind, as ``mesh.index(axis)`` does.
MESH_AXIS_MAPS = ("shape", "coords", "groups")
# Calls whose value is this rank's place in the world (G011): a test on
# one diverges across ranks. ``mesh.index(...)`` and ``mesh.coords[...]``
# are the mesh's own.
RANK_CALLS = ("get_rank",)

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
# G036's callee walk (traceflow.sync_site) counts the same tails, with the
# same cost: a helper that calls ``.item()`` on a numpy scalar or ``.cpu()``
# on a host tensor, called in a hot loop, is a finding to rename
# (*_fetch/*_sync), fix or suppress with its reason.
TRACEFLOW_SYNC_CALL_TAILS = BLOCKING_DEVICE_TAILS
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
