"""Cluster launcher: run a training program inside a joined multi-process
world — ``python -m hivemall_tpu_torch.runtime.launch [cluster flags]
prog.py [prog args...]`` (the port of ``hivemall_tpu/runtime/launch.py``).

The reference deploys its distributed tier as daemon processes fanned out
over ssh (ref: bin/mixserv_daemon.sh start branch, bin/mixserv_cluster.sh:
44-56). Here the "fleet" is N identical processes, so the launcher (1)
joins the ``torch.distributed`` world (runtime/cluster.py init_cluster —
the coordinator replaces conf/MIXSERV_LIST), then (2) hands the process
over to the user's unmodified program via runpy, where
``parallel.make_mesh()`` spans the world.

Cluster flags come from the CLI (--coordinator / --num-procs / --proc-id)
or from HIVEMALL_TPU_COORDINATOR / _NUM_PROCS / _PROC_ID; ``--mix
host1,host2`` (the reference's client option, ref: LearnerBaseUDTF.java:98)
maps its first host to the coordinator. ``--device`` picks this process's
device as the JAX package's JAX_PLATFORMS picks its platform: unset is the
CUDA device (``cuda:LOCAL_RANK``), ``cpu`` joins over gloo on the CPU. The
device is resolved before anything else runs: with no flag on a host
without a CUDA device the launcher raises, and the program never starts.
HIVEMALL_TPU_METRICS_PORT opens the /metrics endpoint (loopback unless
HIVEMALL_TPU_METRICS_HOST says otherwise).
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys

from ..device import resolve_device
from .cluster import init_cluster, parse_mix_option


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m hivemall_tpu_torch.runtime.launch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default: env/single-process)")
    ap.add_argument("--mix", default=None,
                    help="reference-style 'host1[:port],host2' list; first "
                         "entry becomes the coordinator")
    ap.add_argument("--num-procs", type=int, default=None)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="this process's device (default: the CUDA device "
                         "cuda:LOCAL_RANK; 'cpu' joins over gloo)")
    ap.add_argument("--module", "-m", default=None,
                    help="run a module (python -m semantics) instead of a path")
    ap.add_argument("prog", nargs="?", default=None,
                    help="training program path (ignored with --module)")
    ap.add_argument("prog_args", nargs=argparse.REMAINDER,
                    help="arguments passed through to the program")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    coordinator = args.coordinator
    if coordinator is None and args.mix:
        host, port = parse_mix_option(args.mix)
        coordinator = f"{host}:{port}"

    mport = os.environ.get("HIVEMALL_TPU_METRICS_PORT")
    if mport:
        from .metrics_http import serve_metrics

        # loopback unless the operator opts in: the endpoint is
        # unauthenticated
        mhost = os.environ.get("HIVEMALL_TPU_METRICS_HOST", "127.0.0.1")
        srv = serve_metrics(int(mport), host=mhost)
        print(f"[launch] metrics on {mhost}:{srv.server_address[1]}/metrics",
              file=sys.stderr, flush=True)

    joined = init_cluster(coordinator, args.num_procs, args.proc_id,
                          args.device)
    import torch
    import torch.distributed as dist

    rank, world = (dist.get_rank(), dist.get_world_size()) if joined \
        else (0, 1)
    if dev.type == "cuda" and dev.index is None:
        # the device the join set (cuda:LOCAL_RANK), else the default one
        dev = torch.device("cuda", torch.cuda.current_device())
    local = 1 if dev.type == "cpu" else torch.cuda.device_count()
    print(f"[launch] distributed={'joined' if joined else 'single-process'} "
          f"rank={rank}/{world} local_devices={local} device={dev}",
          file=sys.stderr, flush=True)

    try:
        if args.module is not None:
            sys.argv = [args.module] + ([args.prog] if args.prog else []) \
                + args.prog_args
            runpy.run_module(args.module, run_name="__main__",
                             alter_sys=True)
        elif args.prog is not None:
            sys.argv = [args.prog] + args.prog_args
            sys.path.insert(0, os.path.dirname(os.path.abspath(args.prog)))
            runpy.run_path(args.prog, run_name="__main__")
        # neither: runtime.cluster's report-only mode
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
