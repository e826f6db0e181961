"""Tests of the benchmark harness. Most run on the CPU at tiny sizes; the
ones marked `card` need a CUDA device and skip without one, deciding inside
the test. Run them all from the repository root:

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


TINY_DIMS = 1 << 12


def _shrink(root: Path) -> None:
    """Every configuration and cell of the copy at `root` cut to a size the
    CPU trains in a second: 2^12 features, 512 rows."""
    import json

    for path in (root / "portbench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        dims = config["dims"]
        config["options"] = config["options"].replace(f"-dims {dims}",
                                                      f"-dims {TINY_DIMS}")
        config["dims"], config["rows"] = TINY_DIMS, 512
        path.write_text(json.dumps(config))
    for path in (root / "portbench" / "cells").glob("*.json"):
        cell = json.loads(path.read_text())
        cell["warmup_rows"] = 128
        path.write_text(json.dumps(cell))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ (tests left out) with every
    configuration and cell cut to a tiny size."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    _shrink(tmp_path)
    return tmp_path
