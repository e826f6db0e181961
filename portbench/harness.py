"""One run of one cell: set-up, the timed window, the check, the result.

Set-up (counted in `setup_s`, from the process's start): the rows from the
seed (`traffic.py`), the port's import, one warm-up fit of the cell's
options on the cell's `warmup_rows` (which builds or loads the CUDA
kernels and warms the allocator at the window's shapes).

The window: whole fits of the cell's rows back to back, each with a fresh
model as a mapper task starts one, until `seconds` have passed; it closes
on a value the last fit's device tables hold, read back to the host. The
rate is the rows every fit trained (rows x epochs, which the program's
`hivemall.<rule>.examples` counter must agree with) over the window's
seconds. With `trace`, torch.profiler records the window, and the cell's
per-layer readers (`metrics/<name>.py`) read it.

After the window: the peak memory, then the last fit's tables copied to the
host and the device freed, then the plain reference recomputes the fit from
the same rows and `check.py` compares.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import check, counts, reference, spec, traffic
from .reference import linear

FORBIDDEN = ("jax", "jaxlib", "flax", "hivemall_tpu")


def process_start() -> float:
    """The epoch second this process started, from /proc; this module's
    import time where /proc is missing."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + ticks
    except (OSError, ValueError, IndexError):
        pass
    return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold, compared
    whole (`hivemall_tpu_torch` is not `hivemall_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _options_agree(traffic_: dict) -> None:
    opts = traffic_["options"].split()

    def value(flag):
        return opts[opts.index(flag) + 1] if flag in opts else None

    if value("-iters") != str(traffic_["epochs"]):
        raise ValueError(f"cell options {traffic_['options']!r} do not train "
                         f"{traffic_['epochs']} epochs")
    if "-pallas" not in opts or "-mini_batch" in opts:
        raise ValueError(f"cell options {traffic_['options']!r} are not the "
                         "exact scan on the port's kernels (-pallas)")


class View:
    """What a per-layer reader reads: the traced window and the work its
    fits' inputs needed."""

    def __init__(self, cell: spec.Cell, trace, fits: int, rows: traffic.Rows,
                 device_name: str, peaks: dict):
        self.cell = cell
        self.trace = trace
        self.fits = fits
        self.rows = rows
        self._peaks = peaks.get(device_name, {})
        t = cell.traffic
        self.epochs = int(t["epochs"])
        self.block_rows = int(t["block_rows"])
        blocks = -(-len(rows) // self.block_rows)
        self.steps = fits * self.epochs * blocks
        self._work: Dict[str, counts.Work] = {}

    @property
    def busy_s(self) -> float:
        return self.trace.busy_s

    @property
    def window_s(self) -> float:
        return self.trace.window_s

    @property
    def device_ops(self) -> int:
        return len(self.trace.device)

    def kernel(self, name: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernel `name` in the window."""
        return self.trace.kernel_seconds(name)

    def peak(self, key: str) -> Optional[float]:
        return self._peaks.get(key)

    def work(self, kind: str) -> counts.Work:
        """The work of every block the window's fits ran: `scan` or
        `plan`."""
        if kind not in self._work:
            ids, dims = self.rows.padded_ids, self.rows.dims
            rule = self.cell.config["rule"]
            if kind == "scan":
                one = counts.per_block(ids, self.block_rows,
                                       counts.scan_block, dims, rule)
            elif kind == "plan":
                width = counts.staged_width(ids.shape[1])
                staged = np.full((ids.shape[0], width), dims, ids.dtype)
                staged[:, :ids.shape[1]] = ids
                one = counts.per_block(staged, self.block_rows,
                                       counts.plan_block)
            else:
                raise ValueError(f"unknown work {kind!r}")
            self._work[kind] = one * (self.fits * self.epochs)
        return self._work[kind]


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"
    return (out.stdout or out.stderr).strip().replace("\n", "; ")


def reference_tables(cell: spec.Cell, rows: traffic.Rows,
                     precision: str = "float64",
                     fired: Optional[list] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's (w, cov) of one fit of `cell` on `rows` (see
    `linear.exact_fit` for `precision` and `fired`)."""
    config = cell.config
    return linear.exact_fit(rows.padded_ids, rows.padded_values,
                            rows.labels, rows.dims,
                            int(cell.traffic["epochs"]),
                            reference.rule(config["rule"]), config["hyper"],
                            precision, fired)


class Trainer:
    """The port's entry of a configuration, called as a user calls it."""

    def __init__(self, cell: spec.Cell, device: str):
        config, t = cell.config, cell.traffic
        module = importlib.import_module(config["module"])
        self.fn = getattr(module, config["trainer"])
        self.options = f"{config['options']} {t['options']}"
        self.kw = {"device": device} if device == "cpu" else {}
        from hivemall_tpu_torch.runtime.metrics import REGISTRY

        self.examples = REGISTRY.counter("hivemall",
                                         f"{config['rule']}.examples")

    def fit(self, rows: traffic.Rows):
        return self.fn((rows.ids, rows.values), rows.labels, self.options,
                       **self.kw)


def run(doc: dict, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda",
        root: Path = spec.ROOT) -> Tuple[dict, List[str]]:
    """(result, lines for standard error) of one run; raises where the run
    cannot give a result."""
    started = process_start()
    cell = spec.cell(doc, workload, root)
    _options_agree(cell.traffic)
    import torch

    if device == "cuda":
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise RuntimeError(f"{workload} needs {chips} CUDA device(s); "
                               f"this machine has "
                               f"{torch.cuda.device_count()}")
    dev = torch.device(device)
    lines: List[str] = []
    rows = traffic.make_rows(cell.config, seed)
    trainer = Trainer(cell, device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    warm = trainer.fit(rows.head(int(cell.traffic["warmup_rows"])))
    del warm
    sync()
    # the rows are the run's input, not the program's objects: keep the
    # collector from walking them in every full collection of the window
    gc.collect()
    gc.freeze()
    setup_s = time.time() - started

    epochs = int(cell.traffic["epochs"])
    expected = len(rows) * epochs
    profiler = contextlib.nullcontext()
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    fits = 0
    counted0 = trainer.examples.value
    probe_id = int(rows.padded_ids[0, 0])
    with profiler as prof:
        span = (torch.profiler.record_function if trace
                else lambda _: contextlib.nullcontext())
        with span("portbench.window"):
            t0 = time.perf_counter()
            ends = []
            model = None
            while True:
                model = None
                with span("portbench.fit"):
                    model = trainer.fit(rows)
                fits += 1
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
            probe = float(model.state.weights[probe_id])
            sync()
            window_s = time.perf_counter() - t0
    counted = trainer.examples.value - counted0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rate = cell.traffic["rate"]
    lines.append(f"{workload} seed {seed}: {fits} fits of {len(rows)} rows "
                 f"x {epochs} epochs in {window_s:.3f} s "
                 f"({fits * expected / window_s:.1f} rows/s), set-up "
                 f"{setup_s:.3f} s, probe w[{probe_id}] = {probe!r}, "
                 f"peak {peak} B on {name}")
    lines.append("fit seconds: " + " ".join(
        f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)))
    if dev.type == "cuda":
        lines.append(f"card: {_power_limit()}")

    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result: dict = {"correct": False, "attempted": fits, "failed": 0}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": name, "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        from . import trace as trace_mod

        traced = trace_mod.collect(prof)
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        peaks = json.loads((Path(root) / "portbench" / "peaks.json")
                           .read_text())
        view = View(cell, traced, fits, rows, name, peaks)
        for m in cell.per_layer:
            value = spec.reader(m["name"], root)(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
        result["breakdown"] = traced.breakdown()
        lines.append(f"traced: busy {traced.busy_s:.6f} s of "
                     f"{traced.window_s:.6f} s, {len(traced.device)} device "
                     f"operations, {view.steps} steps")
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == rate:
                metrics[rate] = {"value": fits * expected / window_s,
                                 "unit": units[rate]}
    result["metrics"] = metrics
    result["device"] = device_info

    w = model.state.weights.double().cpu().numpy()
    cov = model.state.covars.double().cpu().numpy()
    del model, prof
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_w, ref_cov = reference_tables(cell, rows)
    numbers = check.numbers(w, cov, ref_w, ref_cov)
    numbers["examples"] = float(abs(counted - fits * expected))
    correct, held = check.judge(numbers, cell.traffic["limits"])
    lines.append(f"reference: {time.perf_counter() - t_ref:.3f} s; "
                 + ", ".join(f"{k} {v!r}" for k, v in numbers.items()
                             if k not in cell.traffic["limits"]))
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that no run may hold: {found}")
    result["correct"] = bool(correct)
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in held}
    lines += [f"compared {n}: {v!r} limit {lim!r}" for n, v, lim in held]
    return result, lines
