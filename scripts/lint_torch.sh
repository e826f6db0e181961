#!/usr/bin/env bash
# graftcheck gate for the PyTorch/CUDA port (hivemall_tpu_torch/analysis):
# retraces G001/G002/G005/G006/G032-G036, dtype flow G003/G017-G021,
# concurrency G012-G016, FFI G022-G026 and exception flow G027-G031 over
# hivemall_tpu_torch/. The twin of scripts/lint.sh, in the same modes:
#
#   scripts/lint_torch.sh              # changed-files mode: files touched vs
#                                      # HEAD (staged + unstaged + untracked)
#                                      # under hivemall_tpu_torch/, PLUS the
#                                      # modules that import them — the
#                                      # program rules can fire in an
#                                      # unchanged caller whose callee changed
#   scripts/lint_torch.sh --all        # full-tree scan of hivemall_tpu_torch/
#   scripts/lint_torch.sh --fix-check  # fail if `--fix` would diff the
#                                      # changed files; combine with --all
#                                      # for the full tree
#   scripts/lint_torch.sh FILES...     # explicit file list
#
# The dtype-flow rules (G017-G021) treat the quantized-serving modules —
# serving/engine.py (dequant-free scorers) and io/checkpoint.py (quant
# pack/unpack helpers), with the rest of analysis/config.py
# DTYPEFLOW_HOT_MODULES — as ALWAYS hot, so every gating scan here prices
# a widened full-table dequant or a silent promotion in the quant plumbing.
#
# Exits non-zero on any finding not covered by
# hivemall_tpu_torch/analysis/baseline.json. Accepted debt is refreshed with:
#   python -m hivemall_tpu_torch.analysis --update-baseline
# Machine-applicable findings are repaired with:
#   python -m hivemall_tpu_torch.analysis --fix
set -euo pipefail
cd "$(dirname "$0")/.."

# leading flags parse order-independently: --fix-check --all == --all --fix-check
mode_args=()
all=0
while [[ $# -gt 0 ]]; do
  case "$1" in
    --fix-check) mode_args=(--fix-check); shift ;;
    --all) all=1; shift ;;
    *) break ;;
  esac
done

# every gating scan also archives its findings as SARIF in
# analysis_torch.sarif (scripts/lint.sh keeps analysis.sarif for the JAX
# package's analyzer); stdout keeps the text summary. --fix-check plans
# fixes instead of reporting, so the artifact flags are omitted there.
sarif_args=(--format sarif --output analysis_torch.sarif)
if [[ ${#mode_args[@]} -gt 0 ]]; then
  sarif_args=()
fi
# fix/baseline flags forwarded after a file list also make the run a
# non-report one — the analyzer rejects --output there as a usage error
for arg in "$@"; do
  case "$arg" in
    --fix|--fix-check|--update-baseline) sarif_args=() ;;
  esac
done

if [[ $all -eq 1 ]]; then
  exec python -m hivemall_tpu_torch.analysis hivemall_tpu_torch/ \
    ${sarif_args[@]+"${sarif_args[@]}"} ${mode_args[@]+"${mode_args[@]}"}
elif [[ $# -gt 0 ]]; then
  exec python -m hivemall_tpu_torch.analysis "$@" \
    ${sarif_args[@]+"${sarif_args[@]}"} ${mode_args[@]+"${mode_args[@]}"}
fi

# changed-files mode needs git; outside a work tree fall back to the
# full-tree scan rather than silently checking nothing
if ! git rev-parse --is-inside-work-tree >/dev/null 2>&1; then
  echo "graftcheck: git diff unavailable — falling back to full-tree scan"
  exec python -m hivemall_tpu_torch.analysis hivemall_tpu_torch/ \
    ${sarif_args[@]+"${sarif_args[@]}"} ${mode_args[@]+"${mode_args[@]}"}
fi

existing=()
add_present() {  # append each existing file not yet in the scan list
  local f e present
  for f in "$@"; do
    present=0
    for e in ${existing[@]+"${existing[@]}"}; do
      [[ "$e" == "$f" ]] && present=1
    done
    if [[ $present -eq 0 && -f "$f" ]]; then
      existing+=("$f")
    fi
  done
}

# python files under hivemall_tpu_torch/ touched since HEAD
# (portable read loop — macOS stock bash 3.2 has no mapfile builtin)
while IFS= read -r f; do
  if [[ -n "$f" && -f "$f" ]]; then  # drop deleted paths (set -e safe)
    existing+=("$f")
  fi
done < <(
  {
    git diff --name-only HEAD -- 'hivemall_tpu_torch/**/*.py' \
      'hivemall_tpu_torch/*.py'
    git ls-files --others --exclude-standard -- \
      'hivemall_tpu_torch/**/*.py' 'hivemall_tpu_torch/*.py'
  } | sort -u)
# an edit to the host library's C++ or to the CUDA kernels is an ABI edit:
# pull the FFI-boundary modules into the scan so G022-G026 (and G025's
# cross-language check against the edited source) gate the change even
# though no .py file moved
c_changed=$(
  {
    git diff --name-only HEAD -- 'native/*.cpp' 'native/*.h' \
      'hivemall_tpu_torch/kernels/csrc/*.cu' \
      'hivemall_tpu_torch/kernels/csrc/*.h'
    git ls-files --others --exclude-standard -- 'native/*.cpp' \
      'native/*.h' 'hivemall_tpu_torch/kernels/csrc/*.cu' \
      'hivemall_tpu_torch/kernels/csrc/*.h'
  } | sort -u)
if [[ -n "$c_changed" ]]; then
  echo "graftcheck: C++/CUDA source changed — scanning the FFI boundary modules"
  add_present hivemall_tpu_torch/native/__init__.py \
    hivemall_tpu_torch/core/native_batch.py hivemall_tpu_torch/ops/scatter.py \
    hivemall_tpu_torch/kernels/linear_scan.py \
    hivemall_tpu_torch/kernels/build.py
fi
# the elastic-recovery spine is one failure domain: the fault injector,
# the recovery driver and the pipeline supervisor raise into each other,
# and the exception-flow rules (G027-G031) prove raises ACROSS those
# modules — an edit to either runtime half gates the whole trio
for e in ${existing[@]+"${existing[@]}"}; do
  case "$e" in
    hivemall_tpu_torch/runtime/faults.py|hivemall_tpu_torch/runtime/recovery.py)
      echo "graftcheck: recovery spine changed — scanning the failure-path trio"
      add_present hivemall_tpu_torch/runtime/faults.py \
        hivemall_tpu_torch/runtime/recovery.py \
        hivemall_tpu_torch/pipeline/loop.py
      break ;;
  esac
done
# the capture-hot surface and the hot loops are one retrace domain: an
# op/kernel/serving edit can add a capture, a novel shape or a sync that a
# dispatch module or a step loop reaches, so edits there pull the serving
# dispatch modules and the hot-loop modules into the scan — the retrace
# rules (G002, G032-G036) prove churn, unbucketed shapes and callee syncs
# ACROSS that boundary, in callers that did not move
for e in ${existing[@]+"${existing[@]}"}; do
  case "$e" in
    hivemall_tpu_torch/ops/*|hivemall_tpu_torch/kernels/*|\
    hivemall_tpu_torch/serving/*|hivemall_tpu_torch/core/engine.py|\
    hivemall_tpu_torch/parallel/sharded_train.py|\
    hivemall_tpu_torch/parallel/mix.py|\
    hivemall_tpu_torch/models/trees/grow.py|hivemall_tpu_torch/models/base.py)
      echo "graftcheck: capture-hot surface changed — scanning the dispatch and hot-loop modules"
      add_present hivemall_tpu_torch/serving/engine.py \
        hivemall_tpu_torch/serving/retrieval.py \
        hivemall_tpu_torch/serving/sharded.py \
        hivemall_tpu_torch/core/engine.py \
        hivemall_tpu_torch/parallel/sharded_train.py \
        hivemall_tpu_torch/parallel/mix.py \
        hivemall_tpu_torch/models/trees/grow.py \
        hivemall_tpu_torch/models/base.py
      break ;;
  esac
done
if [[ ${#existing[@]} -eq 0 ]]; then
  echo "graftcheck: no changed python files under hivemall_tpu_torch/"
  exit 0
fi
# --with-callers widens the scan to modules importing the changed ones, so
# interprocedural findings surfacing in unchanged callers are still caught
exec python -m hivemall_tpu_torch.analysis --with-callers "${existing[@]}" \
  ${sarif_args[@]+"${sarif_args[@]}"} ${mode_args[@]+"${mode_args[@]}"}
