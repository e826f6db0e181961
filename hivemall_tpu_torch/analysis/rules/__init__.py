"""Rule registry.

Module rules export ``RULE_ID`` and ``check(model)``; program rules export
``RULE_ID`` and ``check_program(program, scanned)`` — the runner dispatches
each tier (runner._run_rules). The port has every rule of the JAX
package, G001-G036: the retrace rules (G001, G002, G005, G006, G032-G036)
over captures, dtype rules (G003, G017-G021), collective rules (G004,
G007, G008, G010, G011) over the port's process meshes, the torch
API-compatibility rule G009, concurrency rules (G012-G016), FFI rules
(G022-G026) and exception-flow rules (G027-G031), each in the reference's
tier but G018, which reads the dtype-flow model for torch's ``as_tensor``
channel and so runs as a program rule."""

from __future__ import annotations

from typing import Callable, Dict, List

from ..findings import Finding
from ..modmodel import ModuleModel
from . import (g001_recompile, g002_host_sync, g003_dtype, g004_axis,
               g005_donation, g006_side_effect, g007_collective_axis,
               g008_spec_mesh, g009_api_compat, g010_unreduced_output,
               g011_divergent_collective,
               g012_unguarded_shared_field, g013_blocking_under_lock,
               g014_cv_misuse, g015_thread_leak, g016_lock_order_cycle,
               g017_hot_promotion, g018_f64_leak, g019_cast_in_loop,
               g020_artifact_dtype, g021_low_precision_accum,
               g022_ffi_unvalidated_pointer, g023_ffi_borrowed_buffer,
               g024_ffi_missing_prototype, g025_ffi_abi_drift,
               g026_ffi_unchecked_return, g027_future_leak,
               g028_silent_fallback, g029_swallowed_exception,
               g030_unwind_under_lock, g031_unbounded_retry,
               g032_jit_cache_churn, g033_host_branch_traced,
               g034_unbucketed_shape, g035_donated_reuse,
               g036_hot_loop_sync)

_MODULE_RULES = (g001_recompile, g002_host_sync, g003_dtype, g004_axis,
                 g005_donation, g006_side_effect, g009_api_compat,
                 g015_thread_leak)
_PROGRAM_RULES = (g007_collective_axis, g008_spec_mesh,
                  g010_unreduced_output, g011_divergent_collective,
                  g012_unguarded_shared_field, g013_blocking_under_lock,
                  g014_cv_misuse, g016_lock_order_cycle,
                  g017_hot_promotion, g018_f64_leak, g019_cast_in_loop,
                  g020_artifact_dtype, g021_low_precision_accum,
                  g022_ffi_unvalidated_pointer, g023_ffi_borrowed_buffer,
                  g024_ffi_missing_prototype, g025_ffi_abi_drift,
                  g026_ffi_unchecked_return, g027_future_leak,
                  g028_silent_fallback, g029_swallowed_exception,
                  g030_unwind_under_lock, g031_unbounded_retry,
                  g032_jit_cache_churn, g033_host_branch_traced,
                  g034_unbucketed_shape, g035_donated_reuse,
                  g036_hot_loop_sync)

ALL_RULES: Dict[str, Callable[[ModuleModel], List[Finding]]] = {
    m.RULE_ID: m.check for m in _MODULE_RULES
}

PROGRAM_RULES: Dict[str, Callable] = {
    m.RULE_ID: m.check_program for m in _PROGRAM_RULES
}

RULE_DOCS: Dict[str, str] = {
    m.RULE_ID: (m.__doc__ or "").strip().splitlines()[0]
    for m in _MODULE_RULES + _PROGRAM_RULES
}
