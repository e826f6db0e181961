#!/usr/bin/env bash
# A stand-in for ssh that runs the fleet scripts' per-host commands on this
# machine, for testing bin/hivemall_tpu_torch_cluster.sh without an sshd.
# Put it first on PATH under the name `ssh` and set LOOPBACK_SSH_ROOT: it
# drops ssh's options, takes the host name, and runs the command locally
# with a pid file and a log dir of that host's own
# ($LOOPBACK_SSH_ROOT/<host>/worker.pid, .../logs), so two host names of one
# machine behave as two hosts. The caller's environment passes through, as
# it would not over a real ssh.
#
# Usage (as ssh): ssh [-o opt]... <host> <command>
set -u
: "${LOOPBACK_SSH_ROOT:?set LOOPBACK_SSH_ROOT to a directory}"
while [ $# -gt 0 ]; do
  case $1 in
    -[bcDEeFIiJLlmOopQRSWw]) shift 2 ;;  # options that take a value
    -*) shift ;;
    *) break ;;
  esac
done
host=${1:?usage: ssh [options] <host> <command>}
shift
mkdir -p "$LOOPBACK_SSH_ROOT/$host"
export HIVEMALL_TPU_PID_FILE="$LOOPBACK_SSH_ROOT/$host/worker.pid"
export HIVEMALL_TPU_LOG_DIR="$LOOPBACK_SSH_ROOT/$host/logs"
exec bash -c "$*"
