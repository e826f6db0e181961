"""`BENCHMARK.json` and the files it names, found by name and checked.

- a configuration: the file its `configs[].file` names (JSON);
- a cell: `cells/<workload name>.json` (JSON), its traffic;
- a per-layer metric: `metrics/<metric name>.py`, a module with
  `read(view) -> float | None`;
- a rule's reference: `reference/<rule>.py` (see `reference/__init__.py`).

Adding a configuration, a cell or a metric adds files and entries; no
existing file changes. `validate` checks a benchmark document against the
rules its readers rely on: names and units in their alphabets, each entry's
keys, the files it names present, every cell reporting `setup_s`, one more
end-to-end metric and one per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n\r]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@dataclass
class Cell:
    """One workload with everything its run reads."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_path(root: Path, workload: str) -> Path:
    return Path(root) / "portbench" / "cells" / f"{workload}.json"


def metric_path(root: Path, metric: str) -> Path:
    return Path(root) / "portbench" / "metrics" / f"{metric}.py"


def cell(doc: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of the benchmark document `doc`."""
    entries = [w for w in doc["workloads"] if w["name"] == workload]
    if not entries:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in doc["configs"] if c["name"] == entry["config"]]
    if not configs:
        raise ValueError(f"workload {workload!r} names no configuration")
    config = json.loads((Path(root) / configs[0]["file"]).read_text())
    traffic = json.loads(cell_path(root, workload).read_text())
    if traffic.get("traffic") != entry["traffic"]:
        raise ValueError(f"{cell_path(root, workload)} is traffic "
                         f"{traffic.get('traffic')!r}, BENCHMARK.json says "
                         f"{entry['traffic']!r}")
    return Cell(workload, entry, config, traffic,
                [m for m in doc["end_to_end"] if _listed(m, workload)],
                [m for m in doc["per_layer"] if _listed(m, workload)])


def reader(metric: str, root: Path = ROOT) -> Callable:
    """`read` of `metrics/<metric>.py`."""
    path = metric_path(root, metric)
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _check_name(errors: List[str], what: str, name) -> None:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        errors.append(f"{what}: bad name {name!r}")


def _check_text(errors: List[str], what: str, text) -> None:
    if not isinstance(text, str) or not TEXT.fullmatch(text):
        errors.append(f"{what}: text must be 1-200 characters on one line")


def _check_metric(errors: List[str], m: dict, keys: set, names: set) -> None:
    what = f"metric {m.get('name')!r}"
    extra = set(m) - keys - {"workloads"}
    if extra or keys - set(m):
        errors.append(f"{what}: keys {sorted(m)}")
    _check_name(errors, what, m.get("name"))
    if not isinstance(m.get("unit"), str) or not UNIT.fullmatch(m["unit"]):
        errors.append(f"{what}: bad unit {m.get('unit')!r}")
    if m.get("better") not in ("lower", "higher"):
        errors.append(f"{what}: better must be lower or higher")
    if m.get("source") not in SOURCES:
        errors.append(f"{what}: bad source {m.get('source')!r}")
    for w in m.get("workloads", []):
        if w not in names:
            errors.append(f"{what}: lists unknown workload {w!r}")


def validate(doc: dict, root: Path = ROOT) -> List[str]:
    """The rules `doc` breaks, as messages; empty when it keeps them all."""
    root = Path(root)
    errors: List[str] = []
    if set(doc) != TOP_KEYS:
        errors.append(f"top-level keys {sorted(doc)}")
        return errors
    seen: Dict[str, str] = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in doc[kind]:
            name = entry.get("name")
            if name in seen:
                errors.append(f"name {name!r} in {seen[name]} and {kind}")
            seen[name] = kind
    config_names = {c.get("name") for c in doc["configs"]}
    for c in doc["configs"]:
        what = f"config {c.get('name')!r}"
        if set(c) != CONFIG_KEYS:
            errors.append(f"{what}: keys {sorted(c)}")
            continue
        _check_name(errors, what, c["name"])
        _check_text(errors, what, c["source"])
        _check_text(errors, what, c["why"])
        for key in c["reduced"]:
            _check_name(errors, f"{what} reduced", key)
        if not (root / c["file"]).is_file():
            errors.append(f"{what}: no file {c['file']}")
    names = {w.get("name") for w in doc["workloads"]}
    for w in doc["workloads"]:
        what = f"workload {w.get('name')!r}"
        if set(w) != WORKLOAD_KEYS:
            errors.append(f"{what}: keys {sorted(w)}")
            continue
        _check_name(errors, what, w["name"])
        _check_name(errors, what, w["traffic"])
        _check_text(errors, what, w["why"])
        if w["config"] not in config_names:
            errors.append(f"{what}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            errors.append(f"{what}: chips must be 1 or 4")
        if not cell_path(root, w["name"]).is_file():
            errors.append(f"{what}: no file {cell_path(root, w['name'])}")
    for m in doc["end_to_end"]:
        _check_metric(errors, m, E2E_KEYS, names)
        bound = m.get("bound")
        if not isinstance(bound, (int, float)) or not 0.01 <= bound <= 0.25:
            errors.append(f"metric {m.get('name')!r}: bound {bound!r} "
                          "outside [0.01, 0.25]")
    if "setup_s" not in {m.get("name") for m in doc["end_to_end"]}:
        errors.append("no setup_s")
    e2e = {m.get("name") for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        _check_metric(errors, m, LAYER_KEYS, names)
        _check_text(errors, f"metric {m.get('name')!r} layer", m.get("layer"))
        if m.get("moves") not in e2e:
            errors.append(f"metric {m.get('name')!r}: moves unknown "
                          f"{m.get('moves')!r}")
        if not metric_path(root, m.get("name", "")).is_file():
            errors.append(f"metric {m.get('name')!r}: no reader "
                          f"{metric_path(root, m.get('name', ''))}")
    for w in names:
        reported = [m["name"] for m in doc["end_to_end"] if _listed(m, w)]
        layers = [m for m in doc["per_layer"] if _listed(m, w)]
        if "setup_s" not in reported or len(reported) < 2 or not layers:
            errors.append(f"workload {w!r}: needs setup_s, another "
                          "end-to-end metric and a per-layer metric")
        for m in layers:
            if m.get("moves") not in reported:
                errors.append(f"metric {m['name']!r} in {w!r} moves "
                              f"{m.get('moves')!r}, which {w!r} does not "
                              "report")
    return errors
