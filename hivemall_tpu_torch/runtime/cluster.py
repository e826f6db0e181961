"""Multi-host cluster bring-up (the port of ``hivemall_tpu/runtime/
cluster.py``), the MIX-server-fleet replacement.

The reference deploys a Netty parameter-server fleet via ssh fan-out
(ref: bin/mixserv_cluster.sh:44-56, conf/MIXSERV_LIST) and clients learn
the servers from a ``-mix host1,host2`` option. Here there is no server
process: a multi-host run is N identical processes joined into one
``torch.distributed`` world, and "mixing" is the all_reduce inside the
train step (parallel/mix.py).

- `init_cluster(coordinator, num_processes, process_id, device)` — join the
  world through ``parallel.mesh.init_distributed`` with
  ``init_method="tcp://<coordinator>"``, rank = process id, world = process
  count (NCCL on a GPU, gloo on the CPU); afterwards ``make_mesh()`` spans
  every process. A no-op for one process, and safe to call twice.
- `cluster_env()` — the same settings from HIVEMALL_TPU_COORDINATOR /
  _NUM_PROCS / _PROC_ID (the MIXSERV_LIST analog; the JAX package's
  variables).
- `parse_mix_option("host1,host2")` — the reference's -mix syntax; the
  first host is the coordinator.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from ..device import DeviceLike, resolve_device

DEFAULT_PORT = 11212  # kept from MixEnv.java:21 for familiarity


def parse_mix_option(mix: str) -> Tuple[str, int]:
    """-mix "host1[:port][,host2...]" -> (coordinator_host, port)
    (ref: MixClient parses the same list; here the first entry
    coordinates)."""
    first = mix.split(",")[0].strip()
    if ":" in first:
        host, port = first.rsplit(":", 1)
        return host, int(port)
    return first, DEFAULT_PORT


def cluster_env() -> Optional[Tuple[str, int, int]]:
    coord = os.environ.get("HIVEMALL_TPU_COORDINATOR")
    if not coord:
        return None
    n = int(os.environ.get("HIVEMALL_TPU_NUM_PROCS", "1"))
    pid = int(os.environ.get("HIVEMALL_TPU_PROC_ID", "0"))
    return coord, n, pid


def init_cluster(coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 device: DeviceLike = None) -> bool:
    """Join the world (or no-op for one process). Returns True when this
    process is part of a multi-process world. ``coordinator`` is process
    0's ``host:port``; ``device`` resolves as in
    ``parallel.mesh.init_distributed`` (None: this process's CUDA device,
    raising without one; ``"cpu"``: gloo on the CPU)."""
    import torch.distributed as dist

    from ..parallel.mesh import init_distributed

    if coordinator is None:
        env = cluster_env()
        if env is None:
            return False
        coordinator, num_processes, process_id = env
    if num_processes is None or num_processes <= 1:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    init_distributed(device=device, init_method=f"tcp://{coordinator}",
                     rank=int(process_id), world_size=int(num_processes))
    return True


def main(argv=None) -> None:
    """`python -m hivemall_tpu_torch.runtime.cluster --coordinator
    host:port --num-procs N --proc-id I [--device cpu]` — join the world
    and report it (the start_mixserv.sh analog). The device is resolved
    first: with no ``--device`` on a host without a CUDA device it raises
    before joining."""
    import argparse

    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-procs", type=int, default=None)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    joined = init_cluster(args.coordinator, args.num_procs, args.proc_id,
                          args.device)
    rank, world = (dist.get_rank(), dist.get_world_size()) if joined \
        else (0, 1)
    print(f"distributed={'joined' if joined else 'single-process'} "
          f"process={rank}/{world}")


if __name__ == "__main__":
    main()
