#!/usr/bin/env bash
# Per-host worker control for a hivemall-tpu-torch cluster: start|stop|status.
#
# The PyTorch port's twin of bin/hivemall_tpu_daemon.sh (same interface, pid
# file, log rotation and stop escalation). The long-lived process is the
# port's launcher, `python -m hivemall_tpu_torch.runtime.launch`: it joins the
# torch.distributed world and then runs $HIVEMALL_TPU_TORCH_APP (a training
# program; empty = the report-only cluster join). Where it differs:
#   - the program comes from HIVEMALL_TPU_TORCH_APP, never HIVEMALL_TPU_APP,
#     so a conf/cluster_env.sh written for the JAX fleet cannot make this
#     fleet run a JAX program;
#   - HIVEMALL_TPU_DEVICE, when set, is the launcher's --device ("cpu" joins
#     over gloo); unset means the CUDA device, and a host without one fails
#     `start`;
#   - its default pid file and log names carry "torch", so a JAX worker and
#     a port worker on one host never answer for each other;
#   - `start` waits for the launcher's "[launch] distributed=" line (printed
#     after the join) or the worker's death, at most HIVEMALL_TPU_START_WAIT
#     seconds, instead of a one-second liveness check: importing torch alone
#     outlasts that second.
# Settings: conf/cluster_env.sh (shared with the JAX fleet), then
# conf/cluster_env_torch.sh when present (this fleet's own).
#
# Usage: hivemall_tpu_torch_daemon.sh start <coordinator> <num_procs> <proc_id>
#        hivemall_tpu_torch_daemon.sh (stop|status)
set -u

HOME_DIR=${HIVEMALL_TPU_HOME:-$(cd "$(dirname "$0")/.." && pwd)}
[ -f "$HOME_DIR/conf/cluster_env.sh" ] && . "$HOME_DIR/conf/cluster_env.sh"
[ -f "$HOME_DIR/conf/cluster_env_torch.sh" ] && \
  . "$HOME_DIR/conf/cluster_env_torch.sh"

PY=${HIVEMALL_TPU_PYTHON:-python}
APP=${HIVEMALL_TPU_TORCH_APP:-}
DEVICE=${HIVEMALL_TPU_DEVICE:-}
PID_FILE=${HIVEMALL_TPU_PID_FILE:-/tmp/hivemall-tpu-torch-worker-${USER:-root}.pid}
LOG_DIR=${HIVEMALL_TPU_LOG_DIR:-$HOME_DIR/logs}
KEEP_LOGS=${HIVEMALL_TPU_KEEP_LOGS:-5}
START_WAIT=${HIVEMALL_TPU_START_WAIT:-120}

rotate() {
  local log=$1 n=$KEEP_LOGS prev
  [ -f "$log" ] || return 0
  while [ "$n" -gt 1 ]; do
    prev=$((n - 1))
    [ -f "$log.$prev" ] && mv "$log.$prev" "$log.$n"
    n=$prev
  done
  mv "$log" "$log.1"
}

alive() {  # alive <pid>: running, and not a zombie awaiting its reaper
  # (a stopped worker is no child of this shell: where the reaper is slow,
  # kill -0 alone would call a dead worker alive for seconds)
  local stat
  kill -0 "$1" 2>/dev/null || return 1
  read -r stat 2>/dev/null < "/proc/$1/stat" || return 0
  stat=${stat##*) }
  [ "${stat%% *}" != Z ]
}

halt() {  # halt <pid>: TERM, then KILL after 10 s; 1 if it outlives both
  # a worker wedged in a native collective defers SIGTERM handling —
  # escalate so the pid file never outlives a still-running process (a
  # stale file + fresh start would race two workers for the same
  # card/coordinator port)
  local tries=0
  kill "$1" 2>/dev/null
  while [ "$tries" -lt 50 ]; do
    alive "$1" || return 0
    sleep 0.2
    tries=$((tries + 1))
  done
  kill -9 "$1" 2>/dev/null
  sleep 1
  ! alive "$1"
}

case ${1:-} in
  start)
    coordinator=${2:?usage: $0 start <coordinator> <num_procs> <proc_id>}
    num_procs=${3:?num_procs required}
    proc_id=${4:?proc_id required}
    if [ -f "$PID_FILE" ] && alive "$(cat "$PID_FILE")"; then
      echo "worker already running as pid $(cat "$PID_FILE")"
      exit 0
    fi
    mkdir -p "$LOG_DIR"
    log="$LOG_DIR/worker-torch-${proc_id}-$(hostname).log"
    rotate "$log"
    echo "starting worker $proc_id/$num_procs -> $coordinator" \
      "(device: ${DEVICE:-cuda}; log: $log)"
    # the package resolves from the checkout, whatever ssh's working dir
    export PYTHONPATH="$HOME_DIR${PYTHONPATH:+:$PYTHONPATH}"
    # --device goes before APP: the launcher passes everything after the
    # program's path through to the program
    # shellcheck disable=SC2086  # APP is intentionally word-split
    nohup "$PY" -m hivemall_tpu_torch.runtime.launch \
      --coordinator "$coordinator" --num-procs "$num_procs" \
      --proc-id "$proc_id" ${DEVICE:+--device "$DEVICE"} $APP \
      > "$log" 2>&1 &
    pid=$!
    echo "$pid" > "$PID_FILE"
    waited=0
    while ! grep -q '^\[launch\] distributed=' "$log" 2>/dev/null; do
      if ! alive "$pid"; then
        echo "worker (pid $pid) exited before it joined; tail of $log:"
        tail -5 "$log"
        rm -f "$PID_FILE"
        exit 1
      fi
      if [ "$waited" -ge $((START_WAIT * 5)) ]; then
        echo "worker (pid $pid) did not join within ${START_WAIT}s;" \
          "stopping it; tail of $log:"
        tail -5 "$log"
        halt "$pid" && rm -f "$PID_FILE"
        exit 1
      fi
      sleep 0.2
      waited=$((waited + 1))
    done
    echo "worker running as pid $pid:" \
      "$(grep -m1 '^\[launch\] distributed=' "$log")"
    ;;
  stop)
    if [ -f "$PID_FILE" ] && alive "$(cat "$PID_FILE")"; then
      pid=$(cat "$PID_FILE")
      if ! halt "$pid"; then
        echo "failed to stop pid $pid; pid file kept"
        exit 1
      fi
      echo "stopped pid $pid"
    else
      echo "no running worker"
    fi
    rm -f "$PID_FILE"
    ;;
  status)
    if [ -f "$PID_FILE" ] && alive "$(cat "$PID_FILE")"; then
      echo "worker running as pid $(cat "$PID_FILE")"
    else
      echo "worker not running"
      exit 1
    fi
    ;;
  *)
    echo "Usage: $0 (start <coordinator> <num_procs> <proc_id> | stop | status)"
    exit 1
    ;;
esac
