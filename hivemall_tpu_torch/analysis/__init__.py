"""graftcheck for the port — a static analyzer of hivemall_tpu_torch's source.

The twin of the JAX package's graftcheck, with its engine (module and
whole-program models, suppressions, baseline, SARIF, the fixer, the
parallel runner) and all 36 of its rules: the language-level concurrency,
FFI and exception-flow rules, which apply to torch code as they stand,
and the JAX-idiom rules, each designed anew for torch — the retrace layer
(``traceflow.py``) over captures, the dtype-flow layer (``dtypeflow.py``)
under torch's promotion rules, the collective rules over the port's
process meshes (``program.py``'s mesh resolution) and the API-compatibility
rule over torch's moved spellings (``apicompat.py``). Runnable as

    python -m hivemall_tpu_torch.analysis [paths]

(no paths: the ``hivemall_tpu_torch`` package). It reads source only: it
imports neither torch nor jax, touches no device, and gives the same
answer on any host, so the port's rule that entry points run on the card
unless asked for the CPU does not apply to it.

Rules:

- G001 recompile                — a branch on a tensor in a capture, a
                                  capture built in a loop.
- G002 host-sync                — a per-value device->host read in a hot
                                  loop.
- G003 dtype-drift              — float64 (``torch.float64``,
                                  ``.double()``, ``np.float64``) or an
                                  unpinned float literal in update math.
- G004 axis-name-mismatch       — a collective's literal axis that no
                                  mesh declares.
- G005 donation                 — a graphed callable's output read after a
                                  later replay.
- G006 side-effect              — host effects inside a capture.
- G007 collective-axis          — a collective over an axis the mesh it
                                  receives does not bind.
- G008 mesh-lookup              — ``mesh.index`` / ``mesh.shape[...]`` of
                                  an axis the mesh does not bind.
- G009 torch-api-compat         — a torch spelling that moved (the TF32
                                  flags, ``torch.cuda.amp``, ...).
- G010 unreduced-output         — a reduction over a rank's own stripe
                                  returned without a psum.
- G011 divergent-collective     — a collective under a branch on the
                                  rank or on its own tensor data.
- G012 unguarded-shared-field   — a field two threads touch with no
                                  common lock.
- G013 blocking-under-lock      — a device sync (``torch.cuda.synchronize``,
                                  ``.item()``, ``.cpu()``), IO, a warm-up
                                  sweep or a Future rendezvous while a lock
                                  is held, on the serving/pipeline path.
- G014 cv-misuse                — wait() outside a predicate loop,
                                  notify() unheld, a Lock re-acquired.
- G015 thread-leak              — a non-daemon thread never joined.
- G016 lock-order-cycle         — two locks taken in opposite orders.
- G017 hot-promotion            — a bf16/f16/int8 tensor silently widened
                                  by a dimensioned f32/f64 operand in a hot
                                  path (torch's table: scalars and 0-dim
                                  tensors never widen it).
- G018 f64-leak                 — float64 on the serving path, and a
                                  float64 numpy value handed to
                                  ``torch.as_tensor`` / ``from_numpy``.
- G019 cast-in-loop             — a loop-invariant ``.to(dtype)`` /
                                  ``.float()`` per iteration, or a whole
                                  16-bit table widened at once.
- G020 artifact-dtype           — ``torch.as_tensor(pack[...])`` reloads
                                  with no pinned dtype.
- G021 low-precision-accum      — an accumulation whose running sum is
                                  16-bit on the card (``index_add_``,
                                  ``scatter_add_``, ``cumprod``, numpy's
                                  sums).
- G022 ffi-unvalidated-pointer  — a numpy pointer crosses the ctypes ABI
                                  with no dtype+contiguity proof.
- G023 ffi-borrowed-buffer      — a temporary's or a view's pointer.
- G024 ffi-missing-prototype    — a native symbol called without both
                                  argtypes and restype declared, or under
                                  a serving-path lock.
- G025 ffi-abi-drift            — ctypes declarations against the exported
                                  C signatures of ``native/
                                  hivemall_native.cpp`` and of the CUDA
                                  kernels' ``extern "C"`` block
                                  (``kernels/csrc/linear_scan.cu``).
- G026 ffi-unchecked-return     — a native status code dropped.
- G027 future-leak              — a handed-out Future that a raise can
                                  unwind past unresolved.
- G028 silent-fallback          — a handler that switches to degraded work
                                  without a LOUD reason (warn, log, a
                                  trace instant, a counter).
- G029 swallowed-exception      — a broad ``except`` that discards the
                                  error.
- G030 unwind-under-lock        — a manual acquire() whose release an
                                  unwind skips, or a raise between two
                                  writes of self state under a lock.
- G031 unbounded-retry          — a retry loop with no cap or no backoff.
- G032-G036 retrace            — a capture built per call, a host
                                  branch on a traced value, an unbucketed
                                  shape, a graphed output kept across
                                  replays, a sync in a hot loop.

G027-G031 scan serving/, pipeline/ and runtime/, and the modules that opt
in with ``# graftcheck: failure-path-module``: the kernels' build and
launch, the device choice and the native host library, where no code may
carry on on the CPU or on a plain version when a kernel fails.

Suppress a line with ``# graftcheck: disable=G0XX (reason)`` (or
``disable=all``); accepted pre-existing findings live in
``hivemall_tpu_torch/analysis/baseline.json`` and are refreshed with
``python -m hivemall_tpu_torch.analysis --update-baseline``.
"""

from .findings import Finding, Severity
from .runner import analyze_paths, analyze_source
from .baseline import load_baseline, diff_against_baseline, write_baseline

__all__ = [
    "Finding",
    "Severity",
    "analyze_paths",
    "analyze_source",
    "load_baseline",
    "diff_against_baseline",
    "write_baseline",
]
