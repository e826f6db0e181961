"""The port's cluster bring-up (hivemall_tpu_torch/runtime/cluster.py) and
launcher (runtime/launch.py) on the CPU, mirroring tests/test_launch.py:
one process, a two-process gloo world joined through the launcher over a
loopback coordinator (an all_reduce proves the ranks talk, not only that
they joined), and the reference's ``-mix`` syntax mapped to the
coordinator — parsed as the JAX package parses it; with no ``--device``
on a host without a CUDA device, both entry points raise before a program
runs. The port's daemon scripts are tested in
tests/test_torch_cluster_scripts.py."""

import json
import os
import socket
import subprocess
import sys

import pytest

from hivemall_tpu.runtime import cluster as jcluster
from hivemall_tpu_torch.runtime import cluster as tcluster
from hivemall_tpu_torch.runtime import launch as tlaunch
from hivemall_tpu_torch.runtime.launch import build_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180

CHILD = '''\
import json
import sys

import torch
import torch.distributed as dist

out_path = sys.argv[1]
extra = sys.argv[2] if len(sys.argv) > 2 else ""
joined = dist.is_initialized()
rank = dist.get_rank() if joined else 0
world = dist.get_world_size() if joined else 1
total = torch.ones(1)
if joined:
    dist.all_reduce(total)  # a real collective, not only a join
with open(out_path, "w") as f:
    json.dump({"rank": rank, "world": world, "argv_extra": extra,
               "collective": int(total.item())}, f)
print(f"LAUNCH CHILD {rank} OK")
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HIVEMALL_TPU_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture()
def child(tmp_path):
    path = tmp_path / "child.py"
    path.write_text(CHILD)
    return str(path)


def test_launch_single_process(tmp_path, child):
    out = tmp_path / "single.json"
    r = subprocess.run(
        [sys.executable, "-m", "hivemall_tpu_torch.runtime.launch",
         "--device", "cpu", child, str(out), "pass-through-arg"],
        env=_env(), cwd=REPO, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr
    assert "LAUNCH CHILD 0 OK" in r.stdout
    assert "single-process" in r.stderr
    assert "rank=0/1" in r.stderr
    rec = json.loads(out.read_text())
    assert rec == {"rank": 0, "world": 1, "argv_extra": "pass-through-arg",
                   "collective": 1}


def test_launch_two_process_cluster(tmp_path, child):
    """Two launcher processes join over a loopback coordinator into one
    gloo world of two — the mixserv_cluster start analog."""
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"launch{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hivemall_tpu_torch.runtime.launch",
             "--coordinator", f"127.0.0.1:{port}", "--num-procs", "2",
             "--proc-id", str(pid), "--device", "cpu", child, str(out)],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {pid}:\n{log}"
        assert f"LAUNCH CHILD {pid} OK" in log
        assert f"rank={pid}/2" in log and "distributed=joined" in log
    for pid, out in enumerate(outs):
        rec = json.loads(out.read_text())
        assert (rec["rank"], rec["world"], rec["collective"]) == (pid, 2, 2)


def test_launch_mix_option_maps_to_coordinator():
    """--mix 'host1:port,host2' resolves its first entry as the
    coordinator, as the JAX package's parser does."""
    args = build_parser().parse_args(
        ["--mix", "10.0.0.5:7777,10.0.0.6", "--num-procs", "2",
         "--proc-id", "0", "--device", "cpu", "prog.py", "a", "b"])
    assert tcluster.parse_mix_option(args.mix) == ("10.0.0.5", 7777)
    assert args.prog == "prog.py" and args.prog_args == ["a", "b"]
    assert args.device == "cpu"
    for mix in ("10.0.0.5:7777,10.0.0.6", "hostA", " h:1 , h2"):
        assert tcluster.parse_mix_option(mix) == \
            jcluster.parse_mix_option(mix)
    assert tcluster.DEFAULT_PORT == jcluster.DEFAULT_PORT == 11212


def test_cluster_env_and_single_process_noop(monkeypatch):
    for k in ("HIVEMALL_TPU_COORDINATOR", "HIVEMALL_TPU_NUM_PROCS",
              "HIVEMALL_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tcluster.cluster_env() is None
    assert tcluster.init_cluster() is False  # no env: single process
    monkeypatch.setenv("HIVEMALL_TPU_COORDINATOR", "10.1.2.3:11212")
    monkeypatch.setenv("HIVEMALL_TPU_NUM_PROCS", "4")
    monkeypatch.setenv("HIVEMALL_TPU_PROC_ID", "3")
    assert tcluster.cluster_env() == jcluster.cluster_env() == \
        ("10.1.2.3:11212", 4, 3)
    # one process joins nothing, whatever the coordinator
    assert tcluster.init_cluster("127.0.0.1:1", 1, 0, "cpu") is False


def test_launch_default_device_raises_before_the_program(tmp_path,
                                                         monkeypatch):
    """No --device on a host without a CUDA device: the launcher raises
    before it joins or runs anything (the program would write a file)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    # the launcher hands the process over: keep this one's argv and path
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in ("HIVEMALL_TPU_COORDINATOR", "HIVEMALL_TPU_METRICS_PORT"):
        monkeypatch.delenv(k, raising=False)
    out = tmp_path / "ran.txt"
    prog = tmp_path / "prog.py"
    prog.write_text(f"open({str(out)!r}, 'w').write('ran')\n")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tlaunch.main([str(prog)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tlaunch.main(["--module", "json.tool", str(prog)])
    assert not out.exists()
    tlaunch.main(["--device", "cpu", str(prog)])  # asked for: it runs
    assert out.read_text() == "ran"


def test_cluster_main_default_device_raises_before_joining(monkeypatch,
                                                           capsys):
    """runtime.cluster's report-only join resolves its device first, so a
    world of one on a host without a CUDA device raises too, and reports
    nothing."""
    import torch.distributed as dist

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.delenv("HIVEMALL_TPU_COORDINATOR", raising=False)
    for argv in ([], ["--coordinator", "127.0.0.1:1", "--num-procs", "1",
                      "--proc-id", "0"]):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tcluster.main(argv)
    assert capsys.readouterr().out == ""
    assert not dist.is_initialized()
    tcluster.main(["--device", "cpu"])
    assert "single-process process=0/1" in capsys.readouterr().out
