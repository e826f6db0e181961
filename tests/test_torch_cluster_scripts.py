"""The port's fleet scripts (bin/hivemall_tpu_torch_{daemon,cluster}.sh) on
the CPU, as tests/test_launch.py tests the JAX package's daemon: the
daemon's lifecycle against 127.0.0.1, a default-device start failing on a
host without a CUDA device, the twin's pid file kept apart from the JAX
daemon's, and a world of two started through the cluster script over a
loopback ssh stand-in (scripts/ssh_loopback.sh), joined over gloo, each rank
training its partition with train_arow and holding the JAX package's
train_arow on the same rows. Every subprocess runs under its own timeout."""

import json
import os
import re
import socket
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAEMON = os.path.join(REPO, "bin", "hivemall_tpu_torch_daemon.sh")
CLUSTER = os.path.join(REPO, "bin", "hivemall_tpu_torch_cluster.sh")
JAX_DAEMON = os.path.join(REPO, "bin", "hivemall_tpu_daemon.sh")
SSH_SHIM = os.path.join(REPO, "scripts", "ssh_loopback.sh")
TIMEOUT = 120  # seconds any one script call may take
RESULT_WAIT = 120  # seconds the ranks may take to write their results

ROWS, WIDTH, DIMS = 512, 8, 1024
OPTS = f"-dims {DIMS} -pallas"

SLEEPER = "import time\ntime.sleep(120)\n"

# the fleet's program: one gloo all_reduce of the rank's row count checks
# the world, then train_arow on the rank's partition; the model rows go to
# <out>/rank<r>.npz and the facts to rank<r>.json, then it waits to be
# stopped
RANK_PROGRAM = '''\
import json, os, sys, time

import numpy as np
import torch
import torch.distributed as dist

from hivemall_tpu_torch.models.classifier import train_arow

data, out, opts = sys.argv[1], sys.argv[2], " ".join(sys.argv[3:])
idx, val, y = (np.load(os.path.join(data, f + ".npy"))
               for f in ("idx", "val", "y"))
joined = dist.is_initialized()
rank, world = (dist.get_rank(), dist.get_world_size()) if joined else (0, 1)
mine = np.array_split(np.arange(len(y)), world)[rank]
total = torch.tensor([len(mine)])
if joined:
    dist.all_reduce(total)
assert int(total) == len(y), (int(total), len(y))
model = train_arow((list(idx[mine]), list(val[mine])), y[mine], opts,
                   device="cpu")
f, w, c = model.model_rows()
np.savez(os.path.join(out, f"rank{rank}.tmp.npz"), feature=f, weight=w,
         covar=c)
os.replace(os.path.join(out, f"rank{rank}.tmp.npz"),
           os.path.join(out, f"rank{rank}.npz"))
with open(os.path.join(out, f"rank{rank}.tmp"), "w") as fh:
    json.dump({"rank": rank, "world": world, "total": int(total),
               "rows": [int(mine[0]), int(mine[-1]) + 1]}, fh)
os.replace(os.path.join(out, f"rank{rank}.tmp"),
           os.path.join(out, f"rank{rank}.json"))
print(f"RANK {rank} TRAINED", flush=True)
while True:
    time.sleep(1)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HIVEMALL_TPU_")}
    env["HIVEMALL_TPU_PYTHON"] = sys.executable
    env.update(extra)
    return env


def _run(args, env):
    return subprocess.run(["bash", *args], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT)


def _worker_env(tmp_path, **extra):
    return _env(HIVEMALL_TPU_PID_FILE=str(tmp_path / "worker.pid"),
                HIVEMALL_TPU_LOG_DIR=str(tmp_path / "logs"),
                HIVEMALL_TPU_DEVICE="cpu", **extra)


def _log_tail(host_dir) -> str:
    return "".join(p.read_text()[-3000:]
                   for p in (host_dir / "logs").glob("*.log"))


def _gone(pid: int) -> bool:
    """No such process, or a zombie: a stopped worker is no child of ours
    and waits for its reaper, as the daemon's `alive` knows."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("script", [DAEMON, CLUSTER],
                         ids=["daemon", "cluster"])
def test_twins_name_only_the_port(script):
    """The twins start the port's launcher and fan out the port's daemon;
    no line names a module of the JAX package or its daemon."""
    text = open(script).read()
    code = "\n".join(line for line in text.splitlines()
                     if not line.lstrip().startswith("#"))
    assert not re.search(r"hivemall_tpu\.", code), script
    assert "hivemall_tpu_daemon.sh" not in code
    assert "HIVEMALL_TPU_APP" not in code
    if script == DAEMON:
        assert "-m hivemall_tpu_torch.runtime.launch" in code
        assert "HIVEMALL_TPU_TORCH_APP" in code
    else:
        assert code.count("bin/hivemall_tpu_torch_daemon.sh") == 2


def test_twin_daemon_lifecycle(tmp_path):
    """start -> status -> stop on 127.0.0.1 without ssh (tests/
    test_launch.py's test_daemon_lifecycle, on the port): the pid file, the
    log, the double start refused; the JAX fleet's HIVEMALL_TPU_APP is not
    the port's program."""
    sleeper = tmp_path / "sleeper.py"
    sleeper.write_text(SLEEPER)
    marker = tmp_path / "jax_app_ran"
    jax_app = tmp_path / "jax_app.py"
    jax_app.write_text(f"open({str(marker)!r}, 'w').close()\n")
    pid_file = tmp_path / "worker.pid"
    env = _worker_env(tmp_path, HIVEMALL_TPU_TORCH_APP=str(sleeper),
                      HIVEMALL_TPU_APP=str(jax_app))

    r = _run([DAEMON, "start", "127.0.0.1:1", "1", "0"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert pid_file.exists()
    pid = int(pid_file.read_text())
    try:
        assert f"worker running as pid {pid}" in r.stdout
        assert "[launch] distributed=single-process rank=0/1" in r.stdout
        assert "device=cpu" in r.stdout
        r2 = _run([DAEMON, "start", "127.0.0.1:1", "1", "0"], env)
        assert r2.returncode == 0 and \
            f"already running as pid {pid}" in r2.stdout
        r3 = _run([DAEMON, "status"], env)
        assert r3.returncode == 0 and f"running as pid {pid}" in r3.stdout
        logs = sorted(p.name for p in (tmp_path / "logs").iterdir())
        assert logs == [f"worker-torch-0-{socket.gethostname()}.log"], logs
    finally:
        r4 = _run([DAEMON, "stop"], env)
    assert r4.returncode == 0 and f"stopped pid {pid}" in r4.stdout
    assert not pid_file.exists() and _gone(pid)
    r5 = _run([DAEMON, "status"], env)
    assert r5.returncode == 1 and "not running" in r5.stdout
    assert not marker.exists()


def test_twin_default_device_start_fails_without_gpu(tmp_path):
    """HIVEMALL_TPU_DEVICE unset on a host without a CUDA device: the
    launcher raises before the program, and start exits 1 with the log's
    tail and leaves no worker and no pid file."""
    ran = tmp_path / "ran"
    prog = tmp_path / "prog.py"
    prog.write_text(f"open({str(ran)!r}, 'w').close()\n")
    env = _worker_env(tmp_path, HIVEMALL_TPU_TORCH_APP=str(prog),
                      CUDA_VISIBLE_DEVICES="")
    del env["HIVEMALL_TPU_DEVICE"]
    r = _run([DAEMON, "start", "127.0.0.1:1", "1", "0"], env)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "exited before it joined" in r.stdout
    assert "RuntimeError" in r.stdout and "CUDA device" in r.stdout
    pid = int(re.search(r"worker \(pid (\d+)\) exited", r.stdout).group(1))
    assert _gone(pid)
    assert not (tmp_path / "worker.pid").exists() and not ran.exists()
    r2 = _run([DAEMON, "status"], env)
    assert r2.returncode == 1


def test_twin_pid_file_apart_from_jax_daemon(tmp_path):
    """With the default pid files, the JAX daemon does not see a running
    port worker (bin/hivemall_tpu_daemon.sh status only reads its pid
    file), so neither answers for, nor stops, the other."""
    user = f"pytest-{uuid.uuid4().hex[:12]}"
    twin_pid_file = f"/tmp/hivemall-tpu-torch-worker-{user}.pid"
    sleeper = tmp_path / "sleeper.py"
    sleeper.write_text(SLEEPER)
    env = _env(USER=user, HIVEMALL_TPU_LOG_DIR=str(tmp_path / "logs"),
               HIVEMALL_TPU_DEVICE="cpu",
               HIVEMALL_TPU_TORCH_APP=str(sleeper))
    r = _run([DAEMON, "start", "127.0.0.1:1", "1", "0"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    try:
        assert os.path.exists(twin_pid_file)
        rj = _run([JAX_DAEMON, "status"], env)
        assert rj.returncode == 1 and "worker not running" in rj.stdout
        rj2 = _run([JAX_DAEMON, "stop"], env)
        assert "no running worker" in rj2.stdout
        rt = _run([DAEMON, "status"], env)
        assert rt.returncode == 0 and "running as pid" in rt.stdout
    finally:
        rs = _run([DAEMON, "stop"], env)
    assert "stopped pid" in rs.stdout
    assert not os.path.exists(twin_pid_file)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A world of two started by the cluster twin: hosts 127.0.0.1 and
    localhost through the loopback ssh, joined over gloo, each rank's
    results written; stopped again at the end of the module."""
    root = tmp_path_factory.mktemp("fleet")
    rng = np.random.default_rng(20)
    idx = rng.integers(0, DIMS, size=(ROWS, WIDTH)).astype(np.int32)
    val = rng.random((ROWS, WIDTH), dtype=np.float32)
    y = np.where(rng.random(ROWS) < 0.5, 1.0, -1.0).astype(np.float32)
    data, out, shim_bin = root / "data", root / "out", root / "bin"
    for d in (data, out, shim_bin):
        d.mkdir()
    for name, a in (("idx", idx), ("val", val), ("y", y)):
        np.save(data / f"{name}.npy", a)
    prog = root / "rank_program.py"
    prog.write_text(RANK_PROGRAM)
    os.symlink(SSH_SHIM, shim_bin / "ssh")
    workers = root / "WORKER_LIST"
    workers.write_text("# coordinator first\n127.0.0.1\n\n  localhost  \n")
    hosts = root / "hosts"
    env = _env(PATH=f"{shim_bin}{os.pathsep}{os.environ['PATH']}",
               LOOPBACK_SSH_ROOT=str(hosts),
               HIVEMALL_TPU_WORKER_LIST=str(workers),
               HIVEMALL_TPU_COORD_PORT=str(_free_port()),
               HIVEMALL_TPU_DEVICE="cpu",
               HIVEMALL_TPU_TORCH_APP=f"{prog} {data} {out} {OPTS}")
    started = _run([CLUSTER, "start"], env)
    try:
        assert started.returncode == 0, started.stdout + started.stderr
        deadline = time.monotonic() + RESULT_WAIT
        while not all((out / f"rank{r}.json").exists() for r in (0, 1)):
            for host in ("127.0.0.1", "localhost"):
                pid = int((hosts / host / "worker.pid").read_text())
                assert not _gone(pid), _log_tail(hosts / host)
            assert time.monotonic() < deadline, "ranks wrote no results"
            time.sleep(0.2)
        yield {"env": env, "hosts": hosts, "out": out, "start": started,
               "rows": (idx, val, y)}
    finally:
        _run([CLUSTER, "stop"], env)


@pytest.mark.parametrize("rank", [0, 1])
def test_fleet_rank_matches_jax_train_arow(fleet, rank):
    """Each rank joined the world of two (the all_reduce of the row counts
    saw both halves) and its model rows hold the JAX package's train_arow
    on the same partition at rtol 2e-5 / atol 1e-6."""
    from hivemall_tpu.models.classifier import train_arow as jtrain

    host = ("127.0.0.1", "localhost")[rank]
    assert re.search(rf"^{re.escape(host)}: worker running as pid \d+: "
                     rf"\[launch\] distributed=joined rank={rank}/2 "
                     rf"local_devices=1 device=cpu$",
                     fleet["start"].stdout, re.M), fleet["start"].stdout
    facts = json.loads((fleet["out"] / f"rank{rank}.json").read_text())
    lo, hi = facts["rows"]
    assert (facts["rank"], facts["world"], facts["total"]) == \
        (rank, 2, ROWS)
    assert (lo, hi) == ((0, ROWS // 2), (ROWS // 2, ROWS))[rank]
    idx, val, y = (a[lo:hi] for a in fleet["rows"])
    want = jtrain((list(idx), list(val)), y, OPTS)
    got = np.load(fleet["out"] / f"rank{rank}.npz")
    features, weights, covars = want.model_rows()
    np.testing.assert_array_equal(got["feature"], features)
    np.testing.assert_allclose(got["weight"], weights, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["covar"], covars, rtol=2e-5, atol=1e-6)


def test_fleet_status_stop_status(fleet):
    """status answers 0 for both hosts while the ranks wait; stop stops
    both ("stopped pid"); status then exits 1 and no pid file is left."""
    env, hosts = fleet["env"], fleet["hosts"]
    pids = {h: int((hosts / h / "worker.pid").read_text())
            for h in ("127.0.0.1", "localhost")}
    r = _run([CLUSTER, "status"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    for h, pid in pids.items():
        assert f"{h}: worker running as pid {pid}" in r.stdout
    r = _run([CLUSTER, "stop"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    for h, pid in pids.items():
        assert f"{h}: stopped pid {pid}" in r.stdout
        assert _gone(pid) and not (hosts / h / "worker.pid").exists()
    r = _run([CLUSTER, "status"], env)
    assert r.returncode == 1
    for h in pids:
        assert f"{h}: worker not running" in r.stdout
        assert f"{h}: exit 1" in r.stderr
