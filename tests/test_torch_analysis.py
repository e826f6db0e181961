"""graftcheck for the port (hivemall_tpu_torch/analysis): its engine and its
retrace (G001, G002, G005, G006, G032-G036), dtype-flow (G003, G017-G021),
collective (G004, G007, G008, G010, G011), API-compatibility (G009),
concurrency (G012-G016), FFI (G022-G026) and exception-flow (G027-G031)
rules, held against the JAX package's analyzer on that analyzer's own rule
fixtures, and run over the port's tree, both of its C ABIs (the host
library's .cpp, the CUDA kernels' extern "C" block) and its failure paths.

The retrace, dtype, collective and G009 fixtures and G013's import jax;
the port is held to them through twins in tests/data/graftcheck_torch/
whose hazard takes torch's channel, each finding on its original's line
(TORCH_DEPARTURES names the lines where torch has none).
tests/test_torch_analysis_trace.py holds the retrace twins line for line
and the capture model against torch idioms.
tests/test_torch_analysis_dtype.py holds the dtype-flow model against
torch's own promotion. tests/test_torch_analysis_collective.py holds the
collective summaries, mesh resolution, the TF32 helper and the G009 table.
CLI runs go through ``_cli`` (the analyzer's ``main()`` in process, stdout
captured); exactly one test starts a true subprocess, to
prove ``python -m hivemall_tpu_torch.analysis`` itself and that a scan in
a fresh interpreter imports neither jax nor the JAX package, and one runs
``scripts/lint_torch.sh --all`` on a copy of the tree.
"""

import ast
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from hivemall_tpu.analysis import analyze_paths as ref_analyze_paths
from hivemall_tpu_torch.analysis import analyze_paths, analyze_source
from hivemall_tpu_torch.analysis import config, modelcache
from hivemall_tpu_torch.analysis.__main__ import main as _analysis_main
from hivemall_tpu_torch.analysis.baseline import (diff_against_baseline,
                                                  load_baseline)
from hivemall_tpu_torch.analysis.ffi import get_ffi, scan_native_decls
from hivemall_tpu_torch.analysis.findings import parse_suppressions
from hivemall_tpu_torch.analysis.program import ProgramModel
from hivemall_tpu_torch.analysis.rules import ALL_RULES, PROGRAM_RULES
from hivemall_tpu_torch.analysis.rules.g025_ffi_abi_drift import \
    compared_symbols

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PKG = os.path.join(REPO, "hivemall_tpu_torch")
DATA = os.path.join(TESTS, "data", "graftcheck")
TWINS = os.path.join(TESTS, "data", "graftcheck_torch")
EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Z0-9,\s]+)")

RULES = ["g001", "g002", "g003", "g004", "g005", "g006",
         "g007", "g008", "g008_serving", "g009", "g010", "g011",
         "g012", "g013", "g014", "g015", "g016",
         "g017", "g018", "g019", "g020", "g021",
         "g022", "g023", "g024", "g025", "g026",
         "g027", "g028", "g029", "g030", "g031",
         "g032", "g033", "g034", "g035", "g036"]
DTYPE_RULES = ("g003", "g017", "g018", "g019", "g020", "g021")
# (twin, line): a finding of the reference on the original that the port
# rightly does not report on the twin, because torch has no such hazard.
# G021: on an H100 these kernels keep a bf16/f16 running sum in float32
# and round once (scripts/torch_accum_probe.py; dtypeflow.
# TORCH_WIDE_ACCUMULATORS). G001(d), G005(a), G033(b): no per-value static
# arguments and no donation in torch (traceflow.py's docstring). G008's
# serving case and G010's passthrough: nothing in torch names a serving
# axis or declares an output replicated (the rules' docstrings).
_NO_SERVING_AXES = ("the port's serving grid (serving/placement.py) is a "
                    "list of device rows and names no axis")
TORCH_DEPARTURES = {
    ("g008_serving_pos", 26): _NO_SERVING_AXES,
    ("g008_serving_pos", 34): _NO_SERVING_AXES,
    ("g008_serving_pos", 39): _NO_SERVING_AXES,
    ("g010_pos", 17): "no out_specs: a torch function declares no "
                      "replicated output, and a rank's stripe returned as "
                      "itself is that rank's stripe by design",
    ("g001_pos", 36): "a capture has no per-value static arguments",
    ("g005_pos", 9): "the port's steps update tables in place: an "
                     "undonated capture keeps no second copy",
    ("g033_pos", 35): "no static positions to receive a device value",
    ("g021_pos", 11): "torch.sum of a bf16 tensor accumulates in float32",
    ("g021_pos", 16): "cumsum of an f16 tensor accumulates in float32",
    ("g021_pos", 21): "mean of a bf16 tensor accumulates in float32",
    ("g021_pos", 31): "segment_reduce 'sum' of bf16 accumulates in float32",
}
FLOW_RULES = ("G027", "G028", "G029", "G030", "G031")
RULE_IDS = sorted({r[:4].upper() for r in RULES})
KERNEL_CU = os.path.join(PKG, "kernels", "csrc", "linear_scan.cu")
KERNEL_PY = os.path.join(PKG, "kernels", "linear_scan.py")


class _CliResult:
    def __init__(self, returncode, stdout, stderr):
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr


def _cli(*argv, cwd=REPO):
    """The analyzer's CLI in process: return code (argparse usage errors
    land as SystemExit(2)), captured stdout/stderr, cwd-relative paths."""
    out, err = io.StringIO(), io.StringIO()
    prev = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                rc = _analysis_main(list(argv))
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 2
    finally:
        os.chdir(prev)
    return _CliResult(rc, out.getvalue(), err.getvalue())


def _expected(path):
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            m = EXPECT_RE.search(line)
            if m:
                out += [(lineno, r.strip()) for r in m.group(1).split(",")]
    return sorted(out)


def _port_fixture(rule, kind):
    twin = os.path.join(TWINS, f"{rule}_{kind}.py")
    return twin if os.path.exists(twin) else \
        os.path.join(DATA, f"{rule}_{kind}.py")


def _triples(findings):
    return sorted((f.line, f.rule, f.severity) for f in findings)


@pytest.fixture(scope="module")
def tree_findings():
    """One scan of the live package (it also leaves the port's disk
    cache of module models up to date)."""
    return analyze_paths([PKG])


# ---------------------------------------------------------------------------
# the reference's fixtures
# ---------------------------------------------------------------------------

def test_the_registry_holds_the_ports_rules():
    """The registry holds every rule of the JAX package, G001-G036, each
    in the reference's tier but G018 (a program rule in the port)."""
    from hivemall_tpu.analysis.rules import ALL_RULES as REF_MODULE_RULES

    assert RULE_IDS == [f"G{i:03d}" for i in range(1, 37)]
    assert sorted({**ALL_RULES, **PROGRAM_RULES}) == RULE_IDS
    assert set(ALL_RULES) == set(REF_MODULE_RULES) - {"G018"}


@pytest.mark.parametrize("kind", ["pos", "neg"])
@pytest.mark.parametrize("rule", RULES)
def test_fixture_findings_equal_the_reference(rule, kind):
    """The port on each fixture (G013's and the dtype rules' on their torch
    twins) reports exactly the (line, rule, severity) set that the JAX
    package's analyzer reports on the original, run here — less the named
    TORCH_DEPARTURES, each a finding of the reference."""
    original = os.path.join(DATA, f"{rule}_{kind}.py")
    ref = _triples(ref_analyze_paths([original], rules=RULE_IDS))
    gone = {line for (name, line) in TORCH_DEPARTURES
            if name == f"{rule}_{kind}"}
    assert gone <= {line for line, _, _ in ref}
    want = [t for t in ref if t[0] not in gone]
    got = _triples(analyze_paths([_port_fixture(rule, kind)]))
    assert got == want
    if kind == "pos":
        assert [(line, r) for line, r, _ in ref] == _expected(original)
        assert [(line, r) for line, r, _ in want] == \
            _expected(_port_fixture(rule, kind))
    else:
        assert ref == []


@pytest.mark.parametrize("kind", ["pos", "neg"])
def test_g013_twins_follow_their_originals_line_for_line(kind):
    """The twin differs from the original only in its docstring, its
    import and the device sync (jax.device_get -> a torch sync), each on
    the same line, and carries the same EXPECT markers."""
    with open(os.path.join(DATA, f"g013_{kind}.py"), encoding="utf-8") as fh:
        orig = fh.read().splitlines()
    with open(os.path.join(TWINS, f"g013_{kind}.py"), encoding="utf-8") as fh:
        twin = fh.read().splitlines()
    assert len(twin) == len(orig)
    doc_end = ast.parse("\n".join(orig)).body[0].end_lineno
    for i, (a, b) in enumerate(zip(orig, twin), start=1):
        if a != b and i > doc_end:
            assert (a, b) == ("import jax", "import torch") or (
                "jax.device_get(" in a and ".cpu()" in b
                and len(a) - len(a.lstrip()) == len(b) - len(b.lstrip())), \
                (i, a, b)
    assert not any("jax" in line for line in twin)
    assert _expected(os.path.join(TWINS, f"g013_{kind}.py")) == \
        _expected(os.path.join(DATA, f"g013_{kind}.py"))


_REF_CHANNEL = re.compile(r"jax|jnp|\bnp\.|\.astype\(|\.at\[")
_HEADER = ("", "import torch", "import numpy as np", "import jax",
           "import jax.numpy as jnp")


@pytest.mark.parametrize("kind", ["pos", "neg"])
@pytest.mark.parametrize("rule", DTYPE_RULES)
def test_dtype_twins_follow_their_originals_line_for_line(rule, kind):
    """Each dtype twin has its original's lines and docstring; it differs
    only in its imports and on the lines that carry the hazard's channel
    (a jax / jnp / np. / astype / .at[] line, or an EXPECT line), each at the
    same indent; it holds no jax and carries the original's EXPECT markers
    less the named departures."""
    name = f"{rule}_{kind}"
    with open(os.path.join(DATA, name + ".py"), encoding="utf-8") as fh:
        orig = fh.read().splitlines()
    with open(os.path.join(TWINS, name + ".py"), encoding="utf-8") as fh:
        twin = fh.read().splitlines()
    assert len(twin) == len(orig)
    doc_end = ast.parse("\n".join(orig)).body[0].end_lineno
    assert twin[:doc_end] == orig[:doc_end]
    for i, (a, b) in enumerate(zip(orig, twin), start=1):
        if a == b:
            continue
        if a in _HEADER and b in _HEADER:
            continue
        assert (_REF_CHANNEL.search(a) or EXPECT_RE.search(a)) and \
            len(a) - len(a.lstrip()) == len(b) - len(b.lstrip()), (i, a, b)
    assert not any("jax" in line or "jnp" in line for line in twin)
    assert any("torch" in line for line in twin)
    gone = {line for (n, line) in TORCH_DEPARTURES if n == name}
    assert _expected(os.path.join(TWINS, name + ".py")) == [
        e for e in _expected(os.path.join(DATA, name + ".py"))
        if e[0] not in gone]


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()", "stream.synchronize()", "loss.item()",
    "scores.cpu()", "engine.warmup()", "servable.run_padded(rows, 8, 16)"])
def test_g013_flags_the_port_syncs_under_a_lock(call):
    """Each torch sync / device dispatch of config.BLOCKING_* is a G013
    finding under a lock in the serving scope, and none outside it."""
    under = ("import threading\n\nlock = threading.Lock()\n\n\n"
             "def bad(torch, stream, loss, scores, engine, servable, rows):\n"
             f"    with lock:\n        {call}\n")
    free = under.replace("    with lock:\n        ", "    ")
    path = "hivemall_tpu_torch/serving/fixture.py"
    assert [(f.line, f.rule) for f in analyze_source(under, path)] == \
        [(8, "G013")]
    assert analyze_source(free, path) == []


def test_observability_modules_are_concurrency_hot():
    """The time-series sampler and the SLO engine are in G013's scope by
    prefix, without a marker comment."""
    for mod in ("hivemall_tpu_torch/runtime/timeseries.py",
                "hivemall_tpu_torch/runtime/slo.py",
                "hivemall_tpu_torch/serving/server.py",
                "hivemall_tpu_torch/pipeline/loop.py"):
        assert mod.startswith(config.CONCURRENCY_HOT_PREFIXES), mod
    src = ("import threading\n\nlock = threading.Lock()\n\n\n"
           "def bad(sock):\n    with lock:\n        sock.recv(1024)\n")
    hits = [f.rule for f in analyze_source(
        src, "hivemall_tpu_torch/runtime/timeseries.py")]
    assert hits == ["G013"]
    assert analyze_source(src, "hivemall_tpu_torch/models/fm.py") == []


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def test_suppression_parser():
    per_line, whole = parse_suppressions(
        "x = 1  # graftcheck: disable=G012,G013 (reviewed lock-free read)\n"
        "# graftcheck: disable-file=G015\n"
        "y = 2  # graftcheck: disable=all\n")
    assert per_line[1] == {"G012", "G013"}
    assert per_line[3] == {"ALL"}
    assert whole == {"G015"}


_LEAK = ("import threading\n\n\n"
         "def go(work):\n"
         "    threading.Thread(target=work).start(){}\n")


@pytest.mark.parametrize("comment,silenced", [
    ("", False),
    ("  # graftcheck: disable=G015 (fixture)", True),
    ("  # graftcheck: disable=G012 (another rule)", False),
    ("  # graftcheck: disable=all", True),
])
def test_inline_suppressions_silence_findings(comment, silenced):
    found = analyze_source(_LEAK.format(comment), "leak.py")
    assert [f.rule for f in found] == ([] if silenced else ["G015"])


def test_file_suppression_silences_the_rule():
    src = "# graftcheck: disable-file=G015 (fixture)\n" + _LEAK.format("")
    assert analyze_source(src, "leak.py") == []


def test_every_port_suppression_carries_a_reason():
    """Inline suppressions in the port's tree name their reason in
    parentheses, like the JAX package's."""
    bare = []
    pattern = re.compile(r"#\s*graftcheck:\s*disable(-file)?=[A-Za-z0-9_,]+"
                         r"(?P<rest>.*)$")
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py") or "analysis" in root.split(os.sep):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as fh:
                for i, line in enumerate(fh, start=1):
                    m = pattern.search(line)
                    if m and not re.match(r"\s*\(.+\)", m.group("rest")):
                        bare.append(f"{path}:{i}")
    assert not bare, bare


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

def test_live_tree_matches_baseline_exactly(tree_findings):
    new, stale = diff_against_baseline(tree_findings, load_baseline())
    assert not new, "\n".join(f.format() for f in new)
    assert not stale, [(b.rule, b.path, b.snippet) for b in stale]


def test_hot_paths_are_clean_without_baseline(tree_findings):
    """Nothing of the port's rules in serving/, pipeline/, runtime/,
    kernels/ or native/ — fixed or suppressed with a reason, never
    baselined."""
    scopes = ("hivemall_tpu_torch/serving/", "hivemall_tpu_torch/pipeline/",
              "hivemall_tpu_torch/runtime/", "hivemall_tpu_torch/kernels/",
              "hivemall_tpu_torch/native/")
    hot = [f for f in list(tree_findings) + load_baseline()
           if f.path.startswith(scopes)]
    assert hot == [], "\n".join(f.format() for f in hot)


def test_smoke_script_and_examples_are_clean():
    paths = [os.path.join(REPO, "chip_smoke.py")] + sorted(
        os.path.join(REPO, "examples", n)
        for n in os.listdir(os.path.join(REPO, "examples"))
        if n.startswith("torch_") and n.endswith(".py"))
    found = analyze_paths(paths)
    assert found == [], "\n".join(f.format() for f in found)


def test_cli_exits_zero_against_baseline():
    proc = _cli("--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["new"] == [] and payload["stale"] == []


def test_g025_compares_every_bound_symbol():
    """The symbols whose ctypes declarations G025 holds against a C
    definition are all the hm_ symbols the port binds: 9 of the CUDA
    kernels' extern "C" block, 14 of the host library — each with every
    argtype and the restype of a known width."""
    program = ProgramModel({})
    bound = set()
    for rel in ("kernels/linear_scan.py", "native/__init__.py"):
        with open(os.path.join(PKG, *rel.split("/")), encoding="utf-8") as fh:
            bound |= set(re.findall(r"\blib\.(hm_\w+)\.argtypes\s*=",
                                    fh.read()))
    defined = {}
    for src in (KERNEL_CU, os.path.join(REPO, "native",
                                        "hivemall_native.cpp")):
        with open(src, encoding="utf-8") as fh:
            text = re.sub(r"//[^\n]*", "", fh.read())
        for sym in re.findall(r"\b(hm_\w+)\s*\([^;{]*\)\s*\{", text):
            defined[sym] = os.path.basename(src)
    compared = compared_symbols(program, set(program.modules))
    assert compared == bound
    assert bound <= set(defined)
    per_file = {}
    for sym in bound:
        per_file[defined[sym]] = per_file.get(defined[sym], 0) + 1
    assert per_file == {"linear_scan.cu": 9, "hivemall_native.cpp": 14}
    cdecls = scan_native_decls()
    for mod in get_ffi(program).modules.values():
        for sym, decl in mod.decls.items():
            if sym in bound:
                assert decl.argtypes_kinds == \
                    [p.kind for p in cdecls.sigs[sym].params], sym
                assert "other" not in decl.argtypes_kinds, sym
                assert decl.restype_kind == cdecls.sigs[sym].ret, sym


def test_c_scanner_reads_the_kernel_block():
    """The .cu block's kinds: void* stream, long long extents, int32_t*
    tables and const char* returns."""
    sigs = scan_native_decls(KERNEL_CU).sigs
    scan = sigs["hm_linear_scan"]
    assert [p.kind for p in scan.params] == \
        ["i32", "ptr", "i32"] + ["ptr"] * 12 + \
        ["i32", "i32", "i64", "i32", "i32", "ptr"]
    assert scan.params[1].const and not scan.params[9].const
    assert scan.ret == "i32"
    assert sigs["hm_cuda_error_string"].ret == "ptr"
    assert sigs["hm_linear_scan_stage_names"].params == []
    assert sigs["hm_linear_scan_stage_cycles"].params[16].kind == "ptr"


@pytest.mark.parametrize("old,new,what", [
    ("int step0, int depth, void* stream) {\n  Hyper hp;\n  int rc = "
     "check_and_pack(rule,", "int step0, long long depth, void* stream) {\n"
     "  Hyper hp;\n  int rc = check_and_pack(rule,",
     "argument 19 is declared as a 32-bit int in Python but the C "
     "definition takes a 64-bit int"),
    ("long long D, int step0, int depth, void* stream) {\n  Hyper hp;\n"
     "  int rc = check_and_pack(rule,", "long long D, int depth, void* "
     "stream) {\n  Hyper hp;\n  int rc = check_and_pack(rule,",
     "declares 21 argtypes but the C definition takes 20 parameters"),
])
def test_g025_catches_seeded_kernel_abi_drift(tmp_path, monkeypatch, old,
                                              new, what):
    """A parameter of hm_linear_scan changed in a copy of the kernel
    source: G025 reports it on the Python declaration, with the copy's C
    definition as its second location (also in SARIF)."""
    with open(KERNEL_CU, encoding="utf-8") as fh:
        text = fh.read()
    assert text.count(old) == 1
    drifted = tmp_path / "linear_scan.cu"
    drifted.write_text(text.replace(old, new))
    monkeypatch.setenv(config.FFI_KERNEL_CU_ENV, str(drifted))
    found = [f for f in analyze_paths([KERNEL_PY]) if f.rule == "G025"]
    assert len(found) == 1, [f.format() for f in found]
    f = found[0]
    assert f.path == "hivemall_tpu_torch/kernels/linear_scan.py"
    assert f.snippet == "lib.hm_linear_scan.argtypes = ["
    assert what in f.message and "hm_linear_scan" in f.message
    ((r_path, r_line, r_snippet),) = f.related
    assert r_path == str(drifted).replace(os.sep, "/")
    assert r_snippet.startswith("int hm_linear_scan(int rule")
    assert text.splitlines()[r_line - 1] == r_snippet
    proc = _cli(KERNEL_PY, "--no-baseline", "--format", "sarif")
    assert proc.returncode == 1
    (res,) = [r for r in json.loads(proc.stdout)["runs"][0]["results"]
              if r["ruleId"] == "G025"]
    uris = [loc["physicalLocation"]["artifactLocation"]["uri"]
            for loc in res["locations"]]
    assert uris == [f.path, r_path]
    monkeypatch.delenv(config.FFI_KERNEL_CU_ENV)
    assert [f for f in analyze_paths([KERNEL_PY]) if f.rule == "G025"] == []


# ---------------------------------------------------------------------------
# fixer, SARIF, --jobs, baseline, callers
# ---------------------------------------------------------------------------

def _fix_round_trip(tmp_path, fixture, rule):
    target = tmp_path / os.path.basename(fixture)
    shutil.copy(fixture, target)
    proc = _cli(str(target), "--fix", "--no-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--- a/" in proc.stdout, "fix must print a diff preview"
    fixed = target.read_text()
    remaining = [f for f in analyze_paths([str(target)]) if f.rule == rule]
    assert all(f.fix is None for f in remaining)
    proc2 = _cli(str(target), "--fix", "--no-baseline")
    assert proc2.returncode == 0, proc2.stdout + proc2.stderr
    assert "no applicable fixes" in proc2.stdout
    assert target.read_text() == fixed
    assert _cli(str(target), "--fix-check", "--no-baseline").returncode == 0
    return fixed, remaining


def test_fixer_round_trip_g014_wait_loop(tmp_path):
    fixed, remaining = _fix_round_trip(
        tmp_path, os.path.join(DATA, "g014_pos.py"), "G014")
    assert "while not self._ready:" in fixed
    assert "if not self._ready:" not in fixed
    assert len(remaining) == 2  # notify unheld, double acquire


def test_fixer_round_trip_g015_daemon(tmp_path):
    fixed, remaining = _fix_round_trip(
        tmp_path, os.path.join(DATA, "g015_pos.py"), "G015")
    assert "t = threading.Thread(target=work, daemon=True)" in fixed
    assert "threading.Thread(target=work, daemon=True).start()" in fixed
    assert len(remaining) == 1  # the multi-line constructor


def test_fixer_round_trip_g022_ascontiguousarray(tmp_path):
    fixed, remaining = _fix_round_trip(
        tmp_path, os.path.join(DATA, "g022_pos.py"), "G022")
    assert "np.ascontiguousarray(vals, dtype=np.float32)" in fixed
    assert "np.asarray(vals, dtype=np.float32)" not in fixed
    assert len(remaining) == 3


def test_fixer_round_trip_g024_restype(tmp_path):
    fixed, remaining = _fix_round_trip(
        tmp_path, os.path.join(DATA, "g024_pos.py"), "G024")
    assert ("lib.hm_fx_scale.restype = ctypes.c_int64; "
            "lib.hm_fx_scale.argtypes") in fixed
    assert len(remaining) == 2  # no argtypes; called under a lock


def test_fixer_g024_declares_the_kernel_return_width(tmp_path):
    """For a symbol a C source defines, the spliced restype is its return
    width: the kernels' launches return int, so ctypes.c_int — which G025
    then holds against the definition without a finding."""
    (tmp_path / "src").mkdir()
    target = tmp_path / "src" / "binding.py"
    target.write_text(
        "import ctypes\n\nlib = ctypes.CDLL('liblinear_scan.so')\n"
        "lib.hm_linear_scan_max_k.argtypes = []\n\n\n"
        "def max_k():\n    return lib.hm_linear_scan_max_k()\n")
    fixed, remaining = _fix_round_trip(tmp_path, str(target), "G024")
    assert "lib.hm_linear_scan_max_k.restype = ctypes.c_int; " \
           "lib.hm_linear_scan_max_k.argtypes = []" in fixed
    assert remaining == []
    assert analyze_paths([str(tmp_path / "binding.py")]) == []


def test_fixer_round_trip_g009_tf32_helper(tmp_path):
    """--fix rewrites the legacy TF32 flag's read in the G009 twin to the
    compat helper and imports it; the moved spellings with no helper keep
    their findings, without a fix."""
    fixed, remaining = _fix_round_trip(
        tmp_path, os.path.join(TWINS, "g009_pos.py"), "G009")
    assert "    return tf32_matmul_enabled()" in fixed
    assert "from hivemall_tpu_torch.runtime.torch_compat import " \
        "tf32_matmul_enabled" in fixed
    assert "allow_tf32" not in fixed
    assert [f.snippet.split("  #")[0] for f in remaining] == [
        "from torch._six import inf",
        "with torch.cuda.amp.autocast(dtype=torch.bfloat16):"]


def test_fixer_g009_routes_a_flag_write_to_the_setter(tmp_path):
    """A one-line write of a legacy flag becomes the compat setter's call
    with the written value; inside the package the import is relative."""
    pkg = tmp_path / "hivemall_tpu_torch" / "knn"
    pkg.mkdir(parents=True)
    target = pkg / "probe.py"
    target.write_text(
        "import torch\n\n\ndef exact(flag):\n"
        "    torch.backends.cuda.matmul.allow_tf32 = flag and False\n"
        "    torch.backends.cudnn.allow_tf32 = False\n")
    proc = _cli(str(target), "--fix", "--no-baseline", cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    fixed = target.read_text()
    assert "    set_tf32_matmul(flag and False)\n" in fixed
    assert "    set_tf32_cudnn(False)\n" in fixed
    assert "from ..runtime.torch_compat import set_tf32_cudnn, " \
        "set_tf32_matmul" in fixed
    assert _cli(str(target), "--no-baseline",
                cwd=str(tmp_path)).returncode == 0


def test_sarif_output_is_valid_2_1_0(tmp_path):
    """--format sarif: schema/version pinned, rules indexed by every
    result, 1-based physical locations, stable fingerprints; --output
    writes it to a file and keeps the text on stdout."""
    args = (os.path.join(DATA, "g012_pos.py"),
            os.path.join(TWINS, "g013_pos.py"), "--no-baseline",
            "--format", "sarif")
    proc = _cli(*args)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["version"] == "2.1.0"
    assert payload["$schema"].endswith("sarif-schema-2.1.0.json")
    run = payload["runs"][0]
    assert run["tool"]["driver"]["name"] == "graftcheck"
    rule_ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert rule_ids == RULE_IDS
    results = run["results"]
    assert {r["ruleId"] for r in results} == {"G012", "G013"}
    for r in results:
        assert rule_ids[r["ruleIndex"]] == r["ruleId"]
        assert r["level"] in ("error", "warning")
        loc = r["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith(".py")
        assert loc["region"]["startLine"] >= 1
        assert r["partialFingerprints"]["graftcheckKey/v1"]
    assert json.loads(_cli(*args).stdout) == payload
    out = tmp_path / "analysis.sarif"
    proc3 = _cli(*args, "--output", str(out))
    assert proc3.returncode == 1
    assert "G012" in proc3.stdout and f"sarif written to {out}" in \
        proc3.stdout
    assert json.loads(out.read_text()) == payload
    proc4 = _cli(os.path.join(DATA, "g012_pos.py"), "--output",
                 str(tmp_path / "nope.txt"))
    assert proc4.returncode == 2
    assert "--output requires --format" in proc4.stderr


def test_jobs_parallel_findings_match_serial():
    paths = [_port_fixture(r, "pos") for r in RULES]
    serial = [f.format() for f in analyze_paths(paths, jobs=1)]
    threaded = [f.format() for f in analyze_paths(paths, jobs=4)]
    assert serial and threaded == serial
    from hivemall_tpu_torch.analysis.sarif import render_sarif
    assert json.dumps(render_sarif(analyze_paths(paths, jobs=4)),
                      sort_keys=True) == \
        json.dumps(render_sarif(analyze_paths(paths, jobs=1)),
                   sort_keys=True)


def test_cli_usage_and_rule_list(tmp_path):
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    assert [line.split()[0] for line in proc.stdout.splitlines()] == \
        RULE_IDS
    assert _cli(str(tmp_path / "nowhere")).returncode == 2
    proc = _cli(os.path.join(DATA, "g015_pos.py"), "--no-baseline",
                "--rules", "G012")
    assert proc.returncode == 0, proc.stdout


def test_partial_update_baseline_carries_unscanned_debt(tmp_path):
    """--update-baseline over one file keeps accepted entries of files it
    did not scan."""
    base = tmp_path / "baseline.json"
    carried = {"rule": "G012", "path": "hivemall_tpu_torch/serving/server.py",
               "line": 1, "severity": "error", "message": "accepted",
               "snippet": "x = 1"}
    base.write_text(json.dumps({"version": 1, "findings": [carried]}))
    proc = _cli("hivemall_tpu_torch/models/fm.py", "--baseline", str(base),
                "--update-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    keys = [b.key for b in load_baseline(str(base))]
    scanned = "hivemall_tpu_torch/models/fm.py"
    assert [k for k in keys if k[1] != scanned] == \
        [("G012", "hivemall_tpu_torch/serving/server.py", "x = 1")]
    assert [k for k in keys if k[1] == scanned] == \
        [b.key for b in load_baseline() if b.path == scanned]


def test_expand_to_callers_pulls_in_importers():
    from hivemall_tpu_torch.analysis.runner import (expand_to_callers,
                                                    normalize_path)

    got = {normalize_path(p) for p in expand_to_callers([KERNEL_PY])}
    assert "hivemall_tpu_torch/kernels/linear_scan.py" in got
    # a direct (function-local) importer, and one of its importers
    assert "hivemall_tpu_torch/models/base.py" in got
    assert "hivemall_tpu_torch/models/classifier.py" in got


def test_model_cache_is_the_ports_own(tmp_path):
    """The memory layer returns the same model for an unchanged file and
    rebuilds on change; the disk layer is a file of the port's own beside
    the JAX package's analyzer's, which it never reads."""
    from hivemall_tpu.analysis import modelcache as ref_cache

    assert os.path.dirname(modelcache.cache_file()) == \
        os.path.dirname(ref_cache.cache_file())
    assert modelcache.cache_file() != ref_cache.cache_file()
    assert modelcache._MAGIC != ref_cache._MAGIC
    src = tmp_path / "mod.py"
    src.write_text("X = 1\n")
    m1 = modelcache.cached_model(str(src), "mod.py")
    assert modelcache.cached_model(str(src), "mod.py") is m1
    src.write_text("X = 2  # grew\n")
    m3 = modelcache.cached_model(str(src), "mod.py")
    assert m3 is not m1
    m3._graftcheck_probe = object()
    assert not any(k.startswith("_graftcheck_")
                   for k in vars(modelcache._stripped(m3)))
    assert hasattr(m3, "_graftcheck_probe")


def test_analysis_imports_only_the_stdlib_and_itself():
    bad = []
    root = os.path.join(PKG, "analysis")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                bad += [f"{path}: {m}" for m in mods
                        if m.split(".")[0] not in sys.stdlib_module_names]
    assert not bad, bad


def test_python_m_entrypoint_in_a_fresh_interpreter(tree_findings):
    """The one true subprocess of the CLI: ``python -m
    hivemall_tpu_torch.analysis``
    (run the way -m runs it) exits 0 against the baseline, reading its
    models from the port's disk cache, and leaves neither jax, the JAX
    package nor torch imported."""
    assert os.path.exists(modelcache.cache_file())
    code = textwrap.dedent("""
        import json, runpy, sys
        sys.argv = ["hivemall_tpu_torch.analysis"]
        try:
            runpy.run_module("hivemall_tpu_torch.analysis",
                             run_name="__main__", alter_sys=True)
            rc = 0
        except SystemExit as e:
            rc = e.code
        from hivemall_tpu_torch.analysis import modelcache
        print(json.dumps({
            "rc": rc,
            "foreign": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib",
                                                     "hivemall_tpu",
                                                     "torch")),
            "disk": len(modelcache._DISK or {}),
            "rebuilt": modelcache._DIRTY}))
    """)
    env = dict(os.environ, GRAFTCHECK_CACHE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == (f"graftcheck: clean ({len(load_baseline())} "
                        f"baselined finding(s), 0 stale)"), proc.stdout
    got = json.loads(lines[-1])
    assert got["rc"] == 0
    assert got["foreign"] == []
    assert got["disk"] > 100 and got["rebuilt"] is False


# ---------------------------------------------------------------------------
# exception flow (G027-G031): the port's failure paths
# ---------------------------------------------------------------------------

def _ref_fix(path):
    """The JAX package's analyzer's --fix on ``path``, in process."""
    from hivemall_tpu.analysis.__main__ import main as ref_main

    with contextlib.redirect_stdout(io.StringIO()):
        assert ref_main([str(path), "--fix", "--no-baseline"]) == 0


def test_fixer_round_trip_g028_warn_splice(tmp_path):
    """--fix splices a warnings.warn() ahead of each silent fallback of the
    G028 fixture and adds the import — the reference's repair, byte for
    byte; the re-scan is G028-clean and a second run is a no-op."""
    fixed, remaining = _fix_round_trip(
        tmp_path, os.path.join(DATA, "g028_pos.py"), "G028")
    assert "from warnings import warn" in fixed
    assert fixed.count("warn(") >= 2, "both handlers must become loud"
    assert remaining == []
    ref = tmp_path / "ref" / "g028_pos.py"
    ref.parent.mkdir()
    shutil.copy(os.path.join(DATA, "g028_pos.py"), ref)
    _ref_fix(ref)
    assert ref.read_text() == fixed


def test_fixer_round_trip_g030_wrap_finally(tmp_path):
    """--fix wraps G030's manual acquire()..release() region in
    try/finally (findings.WrapFinally) as the reference does; the
    torn-state finding has no machine fix and survives."""
    fixed, remaining = _fix_round_trip(
        tmp_path, os.path.join(DATA, "g030_pos.py"), "G030")
    assert "    try:" in fixed and "    finally:" in fixed
    assert "        _LOCK.release()" in fixed, \
        "release must move under finally"
    assert len(remaining) == 1, "only the torn-state finding may remain"
    ref = tmp_path / "ref" / "g030_pos.py"
    ref.parent.mkdir()
    shutil.copy(os.path.join(DATA, "g030_pos.py"), ref)
    _ref_fix(ref)
    assert ref.read_text() == fixed


def test_failure_path_sarif_fingerprints_stable():
    """G027-G031 ship in the SARIF rules array under tool version 7.0, and
    their results carry partialFingerprints that are byte-stable across
    runs."""
    fixtures = [os.path.join(DATA, "g027_pos.py"),
                os.path.join(DATA, "g030_pos.py")]
    proc = _cli(*fixtures, "--no-baseline", "--format", "sarif")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    driver = payload["runs"][0]["tool"]["driver"]
    assert driver["version"] == "7.0"
    rule_ids = [r["id"] for r in driver["rules"]]
    assert set(FLOW_RULES) <= set(rule_ids)
    results = payload["runs"][0]["results"]
    assert {r["ruleId"] for r in results} == {"G027", "G030"}
    for r in results:
        assert rule_ids[r["ruleIndex"]] == r["ruleId"]
        assert r["partialFingerprints"]["graftcheckKey/v1"]
    assert json.loads(_cli(*fixtures, "--no-baseline", "--format",
                           "sarif").stdout) == payload


def test_serving_pipeline_runtime_are_failure_path_clean():
    """serving/, pipeline/ and runtime/ carry no G027-G031 finding: each
    handler is loud, re-raises, or carries an inline suppression with its
    reason; none of it hides in the baseline."""
    paths = [os.path.join(PKG, d) for d in ("serving", "pipeline",
                                              "runtime")]
    flow = [f for f in analyze_paths(paths) if f.rule in FLOW_RULES]
    assert flow == [], "\n".join(f.format() for f in flow)
    assert [b for b in load_baseline() if b.rule in FLOW_RULES] == [], \
        "failure-path debt must be fixed, not baselined"


def test_g031_dogfood_restart_loops_back_off():
    """Both restart supervisors of the port (the pipeline's trainer loop
    and the elastic recovery driver) pace their restarts with a capped
    linear backoff."""
    import dataclasses

    from hivemall_tpu_torch.pipeline.loop import PipelineConfig
    from hivemall_tpu_torch.runtime import recovery

    backoff = {f.name: f for f in
               dataclasses.fields(PipelineConfig)}["restart_backoff_s"]
    assert backoff.default > 0
    assert recovery.RESTART_BACKOFF_S > 0
    for rel in (("pipeline", "loop.py"), ("runtime", "recovery.py")):
        with open(os.path.join(PKG, *rel), encoding="utf-8") as fh:
            assert "time.sleep(min(" in fh.read(), "/".join(rel)


FAILURE_PATH_MODULES = ("kernels/linear_scan.py", "kernels/build.py",
                        "device.py", "native/__init__.py")


def test_kernel_and_device_modules_opt_into_the_failure_path_rules():
    """The modules that build, load and launch the kernels and choose the
    device carry the failure-path marker, and G027-G031 find nothing in
    them."""
    paths = [os.path.join(PKG, *rel.split("/"))
             for rel in FAILURE_PATH_MODULES]
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            assert config.EXCEPTION_MARKER in fh.read(), path
    found = analyze_paths(paths, rules=list(FLOW_RULES))
    assert found == [], "\n".join(f.format() for f in found)


def test_g028_catches_a_planted_kernel_fallback(tmp_path):
    """A copy of kernels/linear_scan.py whose wrapper, when the kernel
    reports an error, quietly replays the block on the plain version: G028
    flags the handler (the marker puts the copy in scope), the untouched
    copy is clean."""
    with open(KERNEL_PY, encoding="utf-8") as fh:
        text = fh.read()
    check = '    _check(lib, rc, "linear_scan")\n'
    assert text.count(check) == 1
    clean = tmp_path / "clean_scan.py"
    clean.write_text(text)
    assert analyze_paths([str(clean)], rules=list(FLOW_RULES)) == []
    planted = tmp_path / "planted_scan.py"
    planted.write_text(text.replace(check, (
        "    try:\n"
        "        _check(lib, rc, \"linear_scan\")\n"
        "    except Exception:\n"
        "        return linear_scan_reference(rule, hyper, state, indices,\n"
        "                                     values, labels)\n")))
    line = planted.read_text().splitlines().index(
        "    except Exception:") + 1
    found = analyze_paths([str(planted)], rules=list(FLOW_RULES))
    assert [(f.line, f.rule) for f in found] == [(line, "G028")], \
        [f.format() for f in found]
    assert "silent fallback" in found[0].message


def test_lint_torch_script_all_on_a_copy(tmp_path):
    """``scripts/lint_torch.sh --all`` on a copy of the port's tree exits 0,
    writes its SARIF to analysis_torch.sarif (never the reference's
    analysis.sarif) and changes no file of the tree."""
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    shutil.copytree(PKG, tmp_path / "hivemall_tpu_torch", ignore=ignore)
    (tmp_path / "scripts").mkdir()
    (tmp_path / "native").mkdir()
    shutil.copy(os.path.join(REPO, "scripts", "lint_torch.sh"),
                tmp_path / "scripts")
    shutil.copy(os.path.join(REPO, "native", "hivemall_native.cpp"),
                tmp_path / "native")

    def snapshot():
        out = {}
        for dirpath, _, files in os.walk(tmp_path):
            for name in files:
                path = os.path.join(dirpath, name)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, tmp_path)] = fh.read()
        return out

    before = snapshot()
    env = dict(os.environ, GRAFTCHECK_CACHE="0", PYTHONDONTWRITEBYTECODE="1")
    proc = subprocess.run(["bash", str(tmp_path / "scripts" /
                                       "lint_torch.sh"), "--all"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graftcheck: clean" in proc.stdout
    assert "sarif written to analysis_torch.sarif" in proc.stdout
    after = snapshot()
    sarif = json.loads(after.pop("analysis_torch.sarif"))
    assert after == before
    run = sarif["runs"][0]
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == RULE_IDS
    assert run["results"] == []
