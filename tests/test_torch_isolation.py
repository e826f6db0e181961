"""The port stands alone: hivemall_tpu_torch and chip_smoke.py import neither
jax (nor flax, nor ml_dtypes) nor anything of the JAX package, and the
port's entry points do not carry on on the CPU by themselves."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "hivemall_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "hivemall_tpu")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _is_forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_import_in_sources():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _is_forbidden(n)]
    assert not bad, bad


# the subpackages of the continuous-training and kNN slices, each with the
# modules it must hold (numpy copies and host logic included: the port keeps its
# own copy of every reference module it needs)
SLICE_MODULES = {
    "pipeline": ("__init__", "gate", "holdout", "loop"),
    "dataset": ("__init__", "lr_datagen"),
    "evaluation": ("__init__", "metrics"),
    "ftvec": ("__init__", "amplify"),
    "tools": ("__init__", "math"),
    "runtime": ("faults", "timeseries", "slo", "debug_bundle"),
    "knn": ("__init__", "distance", "lsh", "similarity"),
    "parallel": ("__init__", "mesh", "mix", "sharded", "sharded_train",
                 "fm_mix", "ffm_mix", "mc_mix", "forest_shard"),
    "core": ("striping", "collectives"),
}


@pytest.mark.parametrize("sub", sorted(SLICE_MODULES))
def test_slice_subpackages_import_no_jax(sub):
    """Each subpackage's modules exist, name nothing forbidden, and import
    in a fresh interpreter without loading jax or the JAX package."""
    paths = [PKG / sub / f"{m}.py" for m in SLICE_MODULES[sub]]
    assert all(p.exists() for p in paths), paths
    assert set(paths) <= set(_port_sources())
    mods = [f"hivemall_tpu_torch.{sub}" if m == "__init__"
            else f"hivemall_tpu_torch.{sub}.{m}" for m in SLICE_MODULES[sub]]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PKG.rglob("*.py")]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(','.join(bad))\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_without_cuda_raises():
    """No GPU and no device named: a RuntimeError, not a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    from hivemall_tpu_torch.device import resolve_device
    from hivemall_tpu_torch.models.classifier import train_arow
    from hivemall_tpu_torch.models.ffm import train_ffm
    from hivemall_tpu_torch.models.multiclass import train_multiclass_arow
    from hivemall_tpu_torch.models.trees import (
        train_gradient_tree_boosting_classifier, train_randomforest_classifier,
        train_randomforest_regr)

    feats = ([np.array([1, 2])], [np.ones(2, np.float32)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_arow(feats, [1], "-dims 16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_multiclass_arow(feats, ["a"], "-dims 16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ffm([["0:1:1", "1:2:1"]], [1],
                  "-feature_hashing 10 -v_bits 10")
    X = np.random.RandomState(0).rand(8, 2)
    for trainer in (train_randomforest_classifier, train_randomforest_regr,
                    train_gradient_tree_boosting_classifier):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer(X, [0, 1] * 4, "-trees 1")
    from hivemall_tpu_torch.pipeline import ContinuousPipeline, PipelineConfig
    from hivemall_tpu_torch.serving.server import ModelRegistry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousPipeline(ModelRegistry(device="cpu"), lambda i: None,
                           PipelineConfig(artifact_root=str(ROOT / "_none"),
                                          dims=16, rule=None))
    assert not (ROOT / "_none").exists()
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_spawn_without_cuda_raises_before_any_rank_starts(tmp_path,
                                                         monkeypatch):
    """parallel.mesh.spawn resolves its device as init_distributed does: no
    GPU and no device named is a RuntimeError, raised before a process is
    started."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    import torch.multiprocessing as tmp

    from hivemall_tpu_torch.parallel.mesh import spawn

    def started(*a, **k):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(tmp, "start_processes", started)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(print, 2, init_file=str(tmp_path / "rendezvous"))
    assert not (tmp_path / "rendezvous").exists()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a GPU
    (and, alone in a directory, without the package)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_parallel_carries_no_jax_compat_copy():
    """The multi-device slice runs on torch.distributed: no copy of the JAX
    package's runtime/jax_compat.py (its shard_map / pcast shims) in the
    port, and no parallel module names them."""
    assert not list(PKG.rglob("jax_compat.py"))
    for path in sorted((PKG / "parallel").glob("*.py")):
        text = path.read_text()
        assert "jax_compat" not in text and "shard_map(" not in text, path
