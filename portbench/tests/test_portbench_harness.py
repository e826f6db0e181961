"""The harness on the CPU: BENCHMARK.json keeps the rules its readers rely
on; a new configuration, cell and per-layer metric added as files alone are
found by name, validated and run; a run without a CUDA device, or without
the port beside the benchmark, prints no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, spec

ROOT = Path(__file__).resolve().parents[2]


def digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_benchmark_json_keeps_the_rules():
    assert spec.validate(spec.load(ROOT), ROOT) == []


def test_every_cell_is_found_by_name():
    doc = spec.load(ROOT)
    for entry in doc["workloads"]:
        cell = spec.cell(doc, entry["name"], ROOT)
        assert cell.config["name"] == entry["config"]
        assert cell.traffic["rate"] in {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"], ROOT))


def add_new_files(root):
    """A configuration, a cell and a per-layer metric, as new files and
    new entries of BENCHMARK.json."""
    portbench = root / "portbench"
    config = json.loads((portbench / "configs" / "arow_kdd12.json")
                        .read_text())
    config.update(name="pa1_probe", trainer="train_arow")
    (portbench / "configs" / "pa1_probe.json").write_text(json.dumps(config))
    cell = json.loads((portbench / "cells" / "arow_kdd12.scan.json")
                      .read_text())
    cell["traffic"] = "scan_probe"
    (portbench / "cells" / "pa1_probe.scan_probe.json").write_text(
        json.dumps(cell))
    (portbench / "metrics" / "probe_share.new.py").write_text(
        "def read(view):\n    return 100.0 * view.fits / view.fits\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "pa1_probe", "source": "https://x.org/a",
                           "file": "portbench/configs/pa1_probe.json",
                           "reduced": [], "why": "a probe"})
    doc["workloads"].append({"name": "pa1_probe.scan_probe",
                             "config": "pa1_probe", "traffic": "scan_probe",
                             "chips": 1, "why": "a probe"})
    doc["end_to_end"][0]["workloads"].append("pa1_probe.scan_probe")
    doc["per_layer"].append({"name": "probe_share.new", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "device", "moves": "scan_rows_per_s",
                             "workloads": ["pa1_probe.scan_probe"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return doc


def test_new_files_are_found_validated_and_run(tiny_root):
    before = digests(tiny_root / "portbench")
    doc = add_new_files(tiny_root)
    after = digests(tiny_root / "portbench")
    assert {k: v for k, v in before.items() if after[k] != v} == {}
    assert spec.validate(doc, tiny_root) == []
    cell = spec.cell(doc, "pa1_probe.scan_probe", tiny_root)
    assert cell.config["dims"] == 1 << 12
    assert [m["name"] for m in cell.per_layer] == ["probe_share.new"]
    result, lines = harness.run(doc, "pa1_probe.scan_probe", 7, 0.01, True,
                                device="cpu", root=tiny_root)
    assert result["correct"], lines
    assert result["metrics"] == {"probe_share.new": {"value": 100.0,
                                                     "unit": "%"}}
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == {"w_gap", "cov_gap", "cov_median_gap",
                                       "examples"}


@pytest.mark.parametrize("where,key,bad", [
    ("workloads", "name", "a cell"), ("workloads", "name", "x/y"),
    ("end_to_end", "unit", "rows per s"), ("per_layer", "unit", "µs"),
    ("per_layer", "moves", "nothing_s"), ("end_to_end", "bound", 0.3),
    ("workloads", "chips", 2), ("configs", "extra", 1)])
def test_bad_entries_are_refused(where, key, bad):
    doc = json.loads(json.dumps(spec.load(ROOT)))
    doc[where][0][key] = bad
    assert spec.validate(doc, ROOT)


def test_a_run_reports_every_end_to_end_metric_of_its_cell(tiny_root):
    doc = spec.load(tiny_root)
    for entry in doc["workloads"]:
        result, lines = harness.run(doc, entry["name"], 2 ** 31 + 5, 0.01,
                                    False, device="cpu", root=tiny_root)
        cell = spec.cell(doc, entry["name"], tiny_root)
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert result["correct"] and result["failed"] == 0, lines
        assert lines[-len(result["compared"]):] == [
            f"compared {n}: {c['value']!r} limit {c['limit']!r}"
            for n, c in result["compared"].items()]


def run_command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "arow_kdd12.scan", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_no_cuda_device_means_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = run_command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_command(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
