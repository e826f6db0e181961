"""The readers of the program's own spans (`metrics/idle_stage.scan.py`,
`idle_pack.scan.py`, `idle_dispatch.scan.py` over `spans.py`) on a
synthetic trace with known device intervals and host spans: nested,
overlapping and partly outside the window. Each reads the exact share of
the window, counts a nested span once, and reads nothing where the trace
holds none of its spans (as the program without the spans gives)."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import spans, spec
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
READERS = ("idle_stage.scan", "idle_pack.scan", "idle_dispatch.scan")

# window [1000, 2000) ns; the device runs [1200, 1300) and [1500, 1700), so
# it idles in [1000, 1200), [1300, 1500) and [1700, 2000)
DEVICE = [("linear_scan_kernel", 1200, 1300), ("Memcpy HtoD", 1500, 1600),
          ("linear_scan_kernel", 1550, 1700)]
HOST = [
    ("portbench.fit", 1000, 2000),
    ("fit", 1000, 2000),
    # idle in [1000, 1200): 150 ns of the stage inside the window
    ("fit.stage", 900, 1150),
    # nested and repeated packs: their union [1320, 1360) idles 40 ns;
    # [1650, 1800) idles 100 ns past the device's end at 1700
    ("fit.pack", 1320, 1360), ("fit.pack", 1330, 1350),
    ("fit.pack", 1650, 1800),
    ("aten::copy_", 1335, 1345),
    # dispatch: init_state [1150, 1170) idles 20 ns (inside the stage's
    # stretch too: each metric reads its own spans); h2d and step overlap,
    # their union [1360, 1520) idles 140 ns; the sync [1950, 2100) is
    # clipped to the window: 50 ns
    ("fit.init_state", 1150, 1170),
    ("fit.h2d", 1360, 1420), ("fit.step", 1400, 1520),
    ("fit.step", 1410, 1430),
    ("fit.epoch_sync", 1950, 2100),
]
WANT = {"idle_stage.scan": 15.0, "idle_pack.scan": 14.0,
        "idle_dispatch.scan": 21.0}


def view(host, device=DEVICE, window=(1000, 2000)):
    host = sorted(host, key=lambda e: (e[1], -e[2]))
    trace = Trace(list(device), host, window)
    return SimpleNamespace(trace=trace, window_s=trace.window_s)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_the_exact_idle_share_of_its_spans(name):
    got = spec.reader(name, ROOT)(view(HOST))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_a_nested_or_repeated_span_counts_once(name):
    doubled = HOST + [(n, s, e) for n, s, e in HOST if n.startswith("fit.")]
    assert spec.reader(name, ROOT)(view(doubled)) == \
        pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_no_spans_of_its_own_reads_nothing(name):
    parent = [e for e in HOST if not e[0].startswith("fit")]
    assert spec.reader(name, ROOT)(view(parent)) is None


@pytest.mark.parametrize("name", READERS)
def test_spans_outside_the_window_read_zero(name):
    outside = [(n, s - 5000, e - 5000) for n, s, e in HOST]
    assert spec.reader(name, ROOT)(view(outside)) == 0.0


def test_a_device_that_never_idles_reads_zero():
    busy = [("linear_scan_kernel", 1000, 2000)]
    for name in READERS:
        assert spec.reader(name, ROOT)(view(HOST, busy)) == 0.0


def test_union_and_overlap():
    assert spans.union([(5, 9), (1, 3), (2, 4), (9, 10)]) == [(1, 4),
                                                             (5, 10)]
    assert spans.overlap_ns([(0, 10), (20, 30)],
                            [(5, 25), (28, 40)]) == 5 + 5 + 2


def test_the_benchmark_with_the_readers_is_valid():
    doc = spec.load(ROOT)
    assert spec.validate(doc, ROOT) == []
    for name in READERS:
        entry = [m for m in doc["per_layer"] if m["name"] == name][0]
        assert entry["source"] == "program_span" and entry["unit"] == "%"
        assert entry["moves"] == "scan_rows_per_s"
        assert entry["workloads"] == ["arow_kdd12.scan", "scw_kdd10a.scan"]
