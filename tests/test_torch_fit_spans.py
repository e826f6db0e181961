"""The fit loop's spans and phases (`models/base.py::fit_linear`) and their
mirror on torch.profiler's host timeline (`runtime/tracing.py`), on the CPU
(`device="cpu"`): train_arow under scan, `-pallas`, `-mini_batch` and
`-batch`, train_scw under `-pallas`.

A fit of E epochs commits one trace of 3 + E spans (`fit`, `fit.stage`,
`fit.init_state`, one `fit.epoch` a pass) whatever its row count; under the
profiler each block's `fit.pack`, `fit.h2d` and `fit.step` and each pass's
`fit.epoch_sync` is one host event (a `cpu_op`, never a user annotation);
with no profiler no range is entered; the fitted tables are bit-equal with
the tracer on, off and under the profiler. Also: the tracer's Chrome export
on the profiler's clock, and no profiler range left open by a span that ends
on another thread."""

import statistics
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hivemall_tpu_torch.models import base
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.runtime import tracing
from hivemall_tpu_torch.runtime.tracing import Tracer

EPOCHS = 3
N_ROWS = 300
CASES = {
    "arow_scan": (TC.train_arow, "-block_size 64"),
    "arow_pallas": (TC.train_arow, "-block_size 64 -pallas"),
    "arow_mini_batch": (TC.train_arow, "-mini_batch 16"),
    "arow_batch": (TC.train_arow, "-block_size 64 -batch 32"),
    "scw_pallas": (TC.train_scw, "-block_size 64 -pallas"),
}
PHASES = ("fit.pack", "fit.h2d", "fit.step")


def rows(n=N_ROWS, d=128, k=8, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d)
    lens = rng.randint(3, k + 1, size=n)
    idx = [rng.randint(0, d, size=m).astype(np.int64) for m in lens]
    val = [rng.randn(m).astype(np.float32) for m in lens]
    y = np.sign([v @ w[i] for i, v in zip(idx, val)])
    return (idx, val), y


def fit(case, tracer, monkeypatch):
    """(model, committed traces) of one fit of `case` under `tracer`."""
    trainer, opts = CASES[case]
    monkeypatch.setattr(base, "TRACER", tracer)
    feats, y = rows()
    model = trainer(feats, y, f"-dims 128 -iters {EPOCHS} -disable_cv "
                    f"{opts}", device="cpu")
    return model, tracer.traces()


def tables(model):
    st = model.state
    return [st.weights, st.covars] + [st.slots[s] for s in sorted(st.slots)]


def assert_bit_equal(a, b):
    for x, y in zip(tables(a), tables(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def blocks_per_epoch(trace):
    root = [s for s in trace["spans"] if s["name"] == "fit"][0]
    return -(-root["args"]["rows"] // root["args"]["block_rows"])


@pytest.fixture
def untraced(monkeypatch):
    """The tables of each case fitted with the tracer disabled."""
    cache = {}

    def get(case):
        if case not in cache:
            with monkeypatch.context() as m:
                cache[case] = fit(case, Tracer(enabled=False), m)[0]
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_fit_commits_one_trace_of_3_plus_epochs_spans(case, monkeypatch,
                                                        untraced):
    model, traces = fit(case, Tracer(), monkeypatch)
    assert len(traces) == 1
    trace = traces[0]
    names = Counter(s["name"] for s in trace["spans"])
    assert trace["root"] == "fit"
    assert names == {"fit": 1, "fit.stage": 1, "fit.init_state": 1,
                     "fit.epoch": EPOCHS}
    assert len(trace["spans"]) == 3 + EPOCHS
    by_id = {s["span_id"]: s for s in trace["spans"]}
    root = [s for s in trace["spans"] if s["name"] == "fit"][0]
    assert all(by_id[s["parent_id"]] is root for s in trace["spans"]
               if s is not root)
    assert root["args"]["rows"] == N_ROWS and \
        root["args"]["epochs"] == EPOCHS
    epochs = [s for s in trace["spans"] if s["name"] == "fit.epoch"]
    assert sum(s["args"]["blocks"] for s in epochs) == \
        -(-N_ROWS // root["args"]["block_rows"]) * EPOCHS
    for s in epochs:
        for key in ("pack_s", "h2d_s", "step_s", "epoch_sync_s"):
            assert 0 < s["args"][key] <= s["dur_us"] / 1e6
        assert sum(s["args"][k] for k in ("pack_s", "h2d_s", "step_s",
                                          "epoch_sync_s")) \
            <= s["dur_us"] / 1e6
    assert_bit_equal(model, untraced(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_profiler_sees_each_phase_once_a_block_as_a_cpu_op(
        case, monkeypatch, untraced):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model, traces = fit(case, Tracer(), monkeypatch)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("fit")]
    count = Counter(e.name() for e in events)
    blocks = blocks_per_epoch(traces[0]) * EPOCHS
    for phase in PHASES:
        assert count[phase] == blocks, (phase, count)
    assert count["fit.epoch_sync"] == EPOCHS
    assert count["fit.epoch"] == EPOCHS
    assert count["fit"] == count["fit.stage"] == count["fit.init_state"] == 1
    for e in events:
        assert e.activity_type() == "cpu_op" and not e.is_user_annotation()
    assert_bit_equal(model, untraced(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_profiler_means_no_range_and_a_disabled_tracer_nothing(
        case, monkeypatch, untraced):
    entered = []
    real = tracing._profiler_range
    monkeypatch.setattr(tracing, "_profiler_range",
                        lambda name: entered.append(name) or real(name))
    model, traces = fit(case, Tracer(), monkeypatch)
    assert entered == [] and len(traces) == 1
    assert_bit_equal(model, untraced(case))

    off = Tracer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]):
        model, traces = fit(case, off, monkeypatch)
    assert traces == [] and off.dropped == 0 and entered == []
    assert_bit_equal(model, untraced(case))


def test_a_span_under_the_profiler_enters_one_range_and_closes_it(
        monkeypatch):
    entered = []
    real = tracing._profiler_range
    monkeypatch.setattr(tracing, "_profiler_range",
                        lambda name: entered.append(name) or real(name))
    t = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("outer"):
            with t.span("inner"):
                torch.ones(4).sum()
            phases = {}
            for _ in range(3):
                with t.phase("inner.phase", phases):
                    torch.ones(4).sum()
    assert entered == ["outer", "inner"] + ["inner.phase"] * 3
    assert phases["inner.phase"] > 0
    assert [s["name"] for s in t.traces()[0]["spans"]] == ["inner", "outer"]
    got = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer, inner = got["outer"], got["inner"]
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= \
        outer.start_ns() + outer.duration_ns()


def test_spans_of_other_threads_leave_no_range_open(monkeypatch):
    """The profiler records per thread: a range must open and close on the
    thread it records. A root begun here and ended on a worker (as the
    batcher's request roots are) and a span() on a worker get no range; the
    tracer still commits both, and a span() here keeps its finished range."""
    import threading

    entered = []
    real = tracing._profiler_range
    monkeypatch.setattr(tracing, "_profiler_range",
                        lambda name: entered.append(name) or real(name))
    t = Tracer()

    def worker(span):
        torch.ones(4).sum()
        t.end(span)
        with t.span("worker.span"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("here"):
            root = t.begin("cross.root", parent=None)
            torch.ones(4).sum()
            th = threading.Thread(target=worker, args=(root,))
            th.start()
            th.join()
        time.sleep(0.05)  # an unfinished range would run on to the stop
    assert entered == ["here"]
    assert sorted(tr["root"] for tr in t.traces()) == \
        ["cross.root", "here", "worker.span"]
    got = [e for e in prof.profiler.kineto_results.events()
           if e.name() in ("here", "cross.root", "worker.span")]
    assert [e.name() for e in got] == ["here"]
    here = [s for tr in t.traces() for s in tr["spans"]
            if s["name"] == "here"][0]
    # finished inside its span, not run on to the profiler's stop
    assert got[0].duration_ns() <= here["dur_us"] * 1e3


def test_chrome_export_is_on_the_profilers_clock():
    t = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(24):
            with t.span(f"probe.{i}"):
                torch.ones(64).sum()
    doc = t.chrome_trace()
    assert doc["otherData"]["clock"] == "unix_epoch_us"
    exported = {e["name"]: e["ts"] for e in doc["traceEvents"]}
    kineto = {e.name(): e.start_ns() / 1e3
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert len(kineto) == 24 and set(kineto) <= set(exported)
    gaps = [abs(exported[n] - kineto[n]) for n in kineto]
    assert statistics.median(gaps) < 1000.0, gaps


def test_the_tracer_imports_no_torch_and_needs_none():
    import subprocess
    import sys

    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('t', {tracing.__file__!r})\n"
        "t = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(t)\n"
        "tracer, phases = t.Tracer(), {}\n"
        "with tracer.span('a'):\n"
        "    with tracer.phase('a.p', phases):\n"
        "        pass\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "assert len(tracer.traces()) == 1 and phases['a.p'] > 0\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
