"""graftcheck for the port — a static analyzer of hivemall_tpu_torch's source.

The twin of the JAX package's graftcheck, with its engine (module and
whole-program models, suppressions, baseline, SARIF, the fixer, the
parallel runner), its language-level concurrency, FFI and exception-flow
rules, which apply to torch code as they stand, and its dtype-flow layer
(``dtypeflow.py``), rewritten for torch's promotion rules. Runnable as

    python -m hivemall_tpu_torch.analysis [paths]

(no paths: the ``hivemall_tpu_torch`` package). It reads source only: it
imports neither torch nor jax, touches no device, and gives the same
answer on any host, so the port's rule that entry points run on the card
unless asked for the CPU does not apply to it.

Rules:

- G003 dtype-drift              — float64 (``torch.float64``,
                                  ``.double()``, ``np.float64``) or an
                                  unpinned float literal in update math.
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

G027-G031 scan serving/, pipeline/ and runtime/, and the modules that opt
in with ``# graftcheck: failure-path-module``: the kernels' build and
launch, the device choice and the native host library, where no code may
carry on on the CPU or on a plain version when a kernel fails.

The JAX package's JAX-idiom rules (G001, G002, G004-G011, G032-G036) are
still its own.

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
