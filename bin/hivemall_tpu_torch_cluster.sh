#!/usr/bin/env bash
# Fleet control for a hivemall-tpu-torch multi-host cluster: fan the port's
# per-host worker daemon (bin/hivemall_tpu_torch_daemon.sh) out over ssh to
# every host in conf/WORKER_LIST.
#
# The PyTorch port's twin of bin/hivemall_tpu_cluster.sh: the same host list
# parsing, the same coordinator rule (the FIRST host's $COORD_PORT, where
# process 0 serves the torch.distributed rendezvous), proc ids by list order,
# parallel ssh and per-host exit codes. ssh carries no environment: each
# host reads conf/cluster_env.sh and conf/cluster_env_torch.sh of its own
# checkout at $HIVEMALL_TPU_HOME.
#
# Usage: hivemall_tpu_torch_cluster.sh (start|stop|status)
set -u

HOME_DIR=${HIVEMALL_TPU_HOME:-$(cd "$(dirname "$0")/.." && pwd)}
[ -f "$HOME_DIR/conf/cluster_env.sh" ] && . "$HOME_DIR/conf/cluster_env.sh"
[ -f "$HOME_DIR/conf/cluster_env_torch.sh" ] && \
  . "$HOME_DIR/conf/cluster_env_torch.sh"

WORKER_LIST=${HIVEMALL_TPU_WORKER_LIST:-$HOME_DIR/conf/WORKER_LIST}
COORD_PORT=${HIVEMALL_TPU_COORD_PORT:-11212}
SSH_OPTS=${HIVEMALL_TPU_SSH_OPTS:--o StrictHostKeyChecking=no}

cmd=${1:-}
case $cmd in
  start|stop|status) ;;
  *) echo "Usage: $0 (start|stop|status)"; exit 1 ;;
esac

if [ -f "$WORKER_LIST" ]; then
  # strip comments, surrounding whitespace, and blank lines; one host per
  # line, list order = proc id
  mapfile -t hosts < <(sed 's/#.*$//; s/^[[:space:]]*//; s/[[:space:]]*$//; /^$/d' "$WORKER_LIST")
else
  hosts=(localhost)
fi
n=${#hosts[@]}
coordinator="${hosts[0]}:$COORD_PORT"

rcdir=$(mktemp -d)
i=0
for host in "${hosts[@]}"; do
  if [ "$cmd" = start ]; then
    remote_cmd="'$HOME_DIR/bin/hivemall_tpu_torch_daemon.sh' start '$coordinator' $n $i"
  else
    remote_cmd="'$HOME_DIR/bin/hivemall_tpu_torch_daemon.sh' $cmd"
  fi
  # shellcheck disable=SC2086  # SSH_OPTS is intentionally word-split
  ( ssh $SSH_OPTS "$host" "$remote_cmd" 2>&1; echo "$?" > "$rcdir/$i" ) \
    | sed "s/^/$host: /" &
  i=$((i + 1))
done
wait

# surface per-host failures (daemon status/start exit 1 deliberately)
overall=0
i=0
for host in "${hosts[@]}"; do
  rc=$(cat "$rcdir/$i" 2>/dev/null || echo 255)
  [ "$rc" -ne 0 ] && { echo "$host: exit $rc" >&2; overall=1; }
  i=$((i + 1))
done
rm -rf "$rcdir"
exit $overall
