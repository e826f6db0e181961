"""The port's retrace layer (hivemall_tpu_torch/analysis/traceflow.py and
G001, G002, G005, G006, G032-G036) against torch idioms.

Each of the 18 retrace fixtures has a torch twin in
tests/data/graftcheck_torch/ that follows its original line for line
(tests/test_torch_analysis.py holds the port's findings on each twin equal
to the reference analyzer's on the original, less TORCH_DEPARTURES). Here:
the twins' shape, the capture model and taint walker on torch
expressions, the rules' torch forms (graphed outputs, capture blocks,
host RNG, whole-value reads), the two machine fixes on copies of the
twins, the port's hot-loop and capture-hot modules, and the static half
of the planted churn that chip_smoke's phase retrace runs on the card.
The port's tree is scanned once for the module; no subprocess starts.
"""

import ast
import contextlib
import io
import os
import re
import shutil

import pytest

from hivemall_tpu_torch.analysis import analyze_paths, analyze_source
from hivemall_tpu_torch.analysis import config, traceflow
from hivemall_tpu_torch.analysis.__main__ import main as _analysis_main
from hivemall_tpu_torch.analysis.baseline import load_baseline
from hivemall_tpu_torch.analysis.modmodel import build_model

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PKG = os.path.join(REPO, "hivemall_tpu_torch")
DATA = os.path.join(TESTS, "data", "graftcheck")
TWINS = os.path.join(TESTS, "data", "graftcheck_torch")
PLANTED = os.path.join(TWINS, "planted_churn.py")
EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Z0-9,\s]+)")
TRACE_RULES = ("g001", "g002", "g005", "g006",
               "g032", "g033", "g034", "g035", "g036")
TRACEFLOW_IDS = ("G032", "G033", "G034", "G035", "G036")
# The lines of an original that carry the reference's channel: a twin may
# rewrite them (at the same indent) to take torch's.
_CHANNEL = re.compile(r"jax|jnp|\bnp\.|jit|donat|device_get|hivemall_tpu\.")
# (twin, line) rewritten although the original line carries no channel,
# each with its reason.
TWIN_REWRITES = {
    ("g001_neg", 16): "a str annotation marks the static parameter, "
                      "static_argnums' part (line 15)",
    ("g035_pos", 14): "the loop keeps its outputs in a list: the hazard "
                      "is a graphed output kept across replays",
}
# the departures of tests/test_torch_analysis.py that fall on these twins
DEPARTURES = {("g001_pos", 36), ("g005_pos", 9), ("g033_pos", 35)}


def _expected(path):
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            m = EXPECT_RE.search(line)
            if m:
                out += [(lineno, r.strip()) for r in m.group(1).split(",")]
    return sorted(out)


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    prev = os.getcwd()
    os.chdir(REPO)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                rc = _analysis_main(list(argv))
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 2
    finally:
        os.chdir(prev)
    return rc, out.getvalue() + err.getvalue()


@pytest.fixture(scope="module")
def tree_findings():
    """One scan of the port's package, chip_smoke.py and the examples'
    twins, without the baseline."""
    paths = [PKG, os.path.join(REPO, "chip_smoke.py")] + sorted(
        os.path.join(REPO, "examples", n)
        for n in os.listdir(os.path.join(REPO, "examples"))
        if n.startswith("torch_") and n.endswith(".py"))
    return analyze_paths(paths)


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pos", "neg"])
@pytest.mark.parametrize("rule", TRACE_RULES)
def test_trace_twins_follow_their_originals_line_for_line(rule, kind):
    """Each twin has its original's line count and docstring; it differs
    only on lines that carry the reference's channel (jax / jnp / np. /
    jit / donation / device_get / the JAX package's import) or an EXPECT
    marker, and on the named TWIN_REWRITES, each at the same indent; it
    holds no jax and carries the original's EXPECT markers less the
    departures."""
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
        assert _CHANNEL.search(a) or EXPECT_RE.search(a) \
            or (name, i) in TWIN_REWRITES, (i, a, b)
        assert len(a) - len(a.lstrip()) == len(b) - len(b.lstrip()), (i, b)
    assert not any("jax" in line or "jnp" in line for line in twin)
    assert any("torch" in line for line in twin)
    gone = {line for (n, line) in DEPARTURES if n == name}
    assert _expected(os.path.join(TWINS, name + ".py")) == [
        e for e in _expected(os.path.join(DATA, name + ".py"))
        if e[0] not in gone]


def test_twin_rewrites_are_real():
    for (name, line) in TWIN_REWRITES:
        with open(os.path.join(DATA, name + ".py"), encoding="utf-8") as fh:
            a = fh.read().splitlines()[line - 1]
        with open(os.path.join(TWINS, name + ".py"), encoding="utf-8") as fh:
            b = fh.read().splitlines()[line - 1]
        assert a != b and not _CHANNEL.search(a), (name, line)


def test_traceflow_docstring_names_each_departure():
    doc = traceflow.__doc__
    for name, line in DEPARTURES:
        assert f"``{name}`` line {line}" in doc, (name, line)


# ---------------------------------------------------------------------------
# the capture model and the taint walker
# ---------------------------------------------------------------------------

_TAINT_SRC = """\
import numpy as np
import torch
import torch.nn.functional as F


def make_train_step(rule):
    return rule


def probe(dev, a, rule, fn, sample):
    x = torch.ones(4, device=dev)
    h = torch.from_numpy(a)
    step = make_train_step(rule)
    graphed = torch.cuda.make_graphed_callables(fn, sample)
    compiled = torch.compile(fn)
    y = {expr}
"""


@pytest.mark.parametrize("expr,device", [
    ("torch.zeros(4, device=dev)", True),
    ("torch.as_tensor(a, device=dev)", True),
    ("x.sum()", True),
    ("x.float().abs()", True),
    ("x[1:3]", True),
    ("h.to(dev)", True),
    ("h.to(dev, torch.float32)", True),
    ("h.cuda()", True),
    ("F.relu(x)", True),
    ("step(x)", True),
    ("graphed(x)", True),
    ("compiled(h)", True),
    ("x.cpu()", False),
    ("x.cpu().numpy()", False),
    ("x.item()", False),
    ("x.tolist()", False),
    ("x.to('cpu')", False),
    ("x.to(torch.device('cpu'))", False),
    ("torch.zeros(4, device='cpu')", False),
    ("torch.from_numpy(a)", False),
    ("h.to(torch.float32)", False),
    ("x.shape[0]", False),
    ("x.size(0)", False),
    ("x.numel()", False),
    ("x.dtype", False),
    ("np.asarray(a)", False),
    ("float(x)", False),
    ("_split_to_host(x)", False),
    ("torch.cuda.device_count()", False),
])
def test_taint_walker_on_torch_expressions(expr, device):
    model = build_model("probe.py", _TAINT_SRC.format(expr=expr))
    fn = next(f for f in model.functions if f.name == "probe")
    tainted, callables = model.taint_function(fn)
    assert ("y" in tainted) is device
    assert {"step", "graphed", "compiled"} <= callables


def test_capture_model_records_each_form():
    src = ("import torch\n\n\n"
           "@torch.compile\ndef a(x, mode: str):\n    return x\n\n\n"
           "def b(x):\n    return x\n\n\n"
           "def c(x):\n    return x\n\n\n"
           "def d(x):\n    return x\n\n\n"
           "sb = torch.jit.script(b)\n"
           "sc = torch.compile(c, mode=\"reduce-overhead\")\n"
           "g = torch.cuda.make_graphed_callables(d, (S,))\n\n\n"
           "def run(x, gr):\n"
           "    with torch.cuda.graph(gr):\n"
           "        y = a(x, 'relu')\n"
           "    return y\n")
    model = build_model("m.py", src)
    assert {f.name for f in model.traced} == {"a", "b", "c", "d"}
    (a,) = [f for f in model.functions if f.name == "a"]
    assert model.static_params[a] == {"mode"}
    assert {k: w.graphed for k, w in model.jit_aliases.items()} == \
        {"sb": False, "sc": True, "g": True}
    assert len(model.capture_regions) == 1


# ---------------------------------------------------------------------------
# the rules' torch forms
# ---------------------------------------------------------------------------

def _hits(src, path="hivemall_tpu_torch/fixture.py"):
    return [(f.line, f.rule) for f in analyze_source(src, path)]


_GRAPHED = ("import torch\n\n\n"
            "def _double(v):\n    return v * 2\n\n\n"
            "g = torch.cuda.make_graphed_callables(_double, (S,))\n\n\n"
            "def run(a, b, blocks):\n{body}")


@pytest.mark.parametrize("body,want", [
    ("    first = g(a)\n    second = g(b)\n    return first\n",
     [(14, "G005")]),
    ("    first = g(a).clone()\n    second = g(b)\n    return first\n", []),
    ("    first, second = g(a), g(b)\n    return first + second\n",
     [(13, "G005")]),
    ("    first = g(a)\n    return g(b) + first\n", [(13, "G005")]),
    ("    out = g(a)\n    out = g(out)\n    return out\n", []),
    ("    kept = []\n    for blk in blocks:\n        kept.append(g(blk))\n"
     "    return kept\n", [(14, "G035")]),
    ("    kept = []\n    for blk in blocks:\n        y = g(blk)\n"
     "        kept.append(y)\n    return kept\n", [(15, "G035")]),
    ("    kept = []\n    for blk in blocks:\n"
     "        kept.append(g(blk).clone())\n    return kept\n", []),
    ("    best = a\n    for blk in blocks:\n        best = g(best)\n"
     "    return best\n", []),
])
def test_graphed_outputs_are_static_buffers(body, want):
    """G005 flags a graphed output read after a later replay, G035 one
    kept across a loop's replays; .clone() and the rebinding carry are
    clean."""
    assert _hits(_GRAPHED.format(body=body)) == want


def test_g035_resolves_a_factory_built_graph():
    src = ("import torch\n\n\n"
           "def _build_step():\n"
           "    return torch.compile(_f, mode=\"reduce-overhead\")\n\n\n"
           "class Runner:\n"
           "    def __init__(self):\n"
           "        self._step = _build_step()\n\n"
           "    def go(self, a, b):\n"
           "        out = self._step(a)\n"
           "        self._step(b)\n"
           "        return out\n")
    assert _hits(src) == [(15, "G035")]


@pytest.mark.parametrize("line,flagged", [
    ("print(x)", True),
    ("torch.manual_seed(0)", True),
    ("gen = torch.Generator()", True),
    ("gen = torch.Generator(device='cuda')", False),
    ("LOG.append(x)", True),
    ("x.add_(1)", False),
])
def test_g006_in_a_capture_block(line, flagged):
    """A ``with torch.cuda.graph(g):`` body is a capture: its host
    effects run once."""
    src = ("import torch\n\nLOG = []\n\n\n"
           "def capture(g, x):\n    with torch.cuda.graph(g):\n"
           f"        {line}\n        y = x * 2\n    return y\n")
    assert _hits(src) == ([(8, "G006")] if flagged else [])


def test_g001_in_a_capture_block_and_a_capture_in_a_loop():
    src = ("import torch\n\n\n"
           "def capture(g, n):\n"
           "    x = torch.ones(n, device='cuda')\n"
           "    with torch.cuda.graph(g):\n"
           "        if x.sum() > 0:\n"
           "            x.mul_(2)\n"
           "    for _ in range(3):\n"
           "        h = torch.cuda.CUDAGraph()\n"
           "    return x, h\n")
    assert _hits(src) == [(7, "G001"), (10, "G001")]


_HOT = ("# graftcheck: hot-module\nimport torch\n\n\n"
        "def drive(rule, state, blocks):\n"
        "    step = make_train_step(rule)\n"
        "    for blk in blocks:\n"
        "        state, stats = step(state, blk)\n"
        "        {line}\n"
        "    return state\n")


@pytest.mark.parametrize("line,flagged", [
    ("host = stats.cpu()", False),
    ("host = stats.tolist()", False),
    ("host = stats[0].cpu()", True),
    ("host = stats[0].tolist()", True),
    ("host = stats.item()", True),
    ("host = float(stats)", True),
    ("host = stats.cpu().numpy()", False),
    ("torch.cuda.synchronize()", True),
])
def test_g002_whole_value_reads_pass_per_element_reads_do_not(line,
                                                              flagged):
    assert _hits(_HOT.format(line=line)) == \
        ([(9, "G002")] if flagged else [])


@pytest.mark.parametrize("call,flagged", [
    ("servable.run_padded(rows[:n], 512, 64)", True),
    ("servable.run_padded(rows[:512], 512, 64)", False),
    ("servable.run_padded(rows, 512, 64)", False),
])
def test_g034_guards_the_bucketed_dispatch_entry_point(call, flagged):
    src = ("# graftcheck: jit-hot-module\n\n\n"
           f"def serve(servable, rows, n):\n    return {call}\n")
    assert _hits(src) == ([(5, "G034")] if flagged else [])


def test_g036_follows_a_helper_to_its_cpu_read():
    src = ("# graftcheck: jit-hot-module\n\n\n"
           "def _peek(t):\n    return t.cpu()\n\n\n"
           "def drive(step, state, blocks):\n"
           "    for blk in blocks:\n"
           "        state = step(state, blk)\n"
           "        _peek(state)\n"
           "    return state\n")
    found = analyze_source(src, "hivemall_tpu_torch/fixture.py")
    assert [(f.line, f.rule) for f in found] == [(11, "G036")]
    assert found[0].related[0][1] == 5


# ---------------------------------------------------------------------------
# the machine fixes, on copies of the twins
# ---------------------------------------------------------------------------

def test_fixer_round_trip_g032_eta(tmp_path):
    """--fix rewrites the eta-expanded lambda to the named function; the
    closure/partial/loop findings carry no fix and survive, and a second
    run plans nothing."""
    target = tmp_path / "g032_case.py"
    shutil.copy(os.path.join(TWINS, "g032_pos.py"), target)
    rc, out = _cli(str(target), "--fix", "--no-baseline")
    assert rc == 0, out
    fixed = target.read_text()
    assert "torch.compile(lambda v: _score(v))" not in fixed
    assert "scorer = torch.compile(_score)" in fixed
    remaining = [f for f in analyze_paths([str(target)])
                 if f.rule == "G032"]
    assert len(remaining) == 3, "closure, partial and loop findings stay"
    assert all(f.fix is None for f in remaining)
    rc, out = _cli(str(target), "--fix", "--no-baseline")
    assert rc == 0 and "no applicable fixes" in out, out


def test_fixer_round_trip_g034_bucket_route(tmp_path):
    """--fix routes the bare-name dynamic-slice argument through the
    port's bucket_rows (adding the import) and slices the result back; the
    inline-slice finding keeps no fix; --fix-check then agrees (rc 0)."""
    target = tmp_path / "g034_case.py"
    shutil.copy(os.path.join(TWINS, "g034_pos.py"), target)
    rc, out = _cli(str(target), "--fix", "--no-baseline")
    assert rc == 0, out
    fixed = target.read_text()
    assert "from hivemall_tpu_torch.core.batch import bucket_rows" in fixed
    assert "scorer(bucket_rows(live))[:live.shape[0]]" in fixed
    remaining = [f for f in analyze_paths([str(target)])
                 if f.rule == "G034"]
    assert len(remaining) == 1, "only the inline slice may remain"
    assert remaining[0].fix is None
    rc, out = _cli(str(target), "--fix-check", "--no-baseline")
    assert rc == 0, out


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

_G001_G002_SUPPRESSION = re.compile(
    r"graftcheck:\s*disable(-file)?=[A-Za-z0-9_,]*\b(G001|G002|all)\b")


@pytest.mark.parametrize("mod", config.HOT_LOOP_MODULES)
def test_hot_modules_have_zero_g001_g002(tree_findings, mod):
    """G001/G002 fixed, not baselined and not suppressed, in the hot-loop
    modules."""
    hits = [f for f in tree_findings
            if f.path == mod and f.rule in ("G001", "G002")]
    assert hits == [], "\n".join(f.format() for f in hits)
    with open(os.path.join(REPO, *mod.split("/")), encoding="utf-8") as fh:
        assert not _G001_G002_SUPPRESSION.search(fh.read()), mod
    assert [b for b in load_baseline() if b.path == mod
            and b.rule in ("G001", "G002")] == []


def test_capture_hot_modules_are_traceflow_clean(tree_findings):
    """The capture-hot surface — serving dispatch plus the op and kernel
    layers — carries no G032-G036 finding, and none of that debt hides in
    the baseline."""
    hot = [f for f in tree_findings if f.rule in TRACEFLOW_IDS
           and traceflow.in_traceflow_scope(f.path, None)]
    assert hot == [], "\n".join(f.format() for f in hot)
    assert [b for b in load_baseline() if b.rule in TRACEFLOW_IDS] == []


def test_the_tree_has_no_retrace_finding(tree_findings):
    """No G001, G002, G005, G006 or G032-G036 finding anywhere in the
    port, chip_smoke.py or the examples' twins: each is fixed or carries
    an inline suppression with its reason."""
    rules = ("G001", "G002", "G005", "G006") + TRACEFLOW_IDS
    hits = [f for f in tree_findings if f.rule in rules]
    assert hits == [], "\n".join(f.format() for f in hits)


# ---------------------------------------------------------------------------
# the planted churn (the dynamic half runs in chip_smoke's phase retrace)
# ---------------------------------------------------------------------------

def test_planted_churn_caught_statically():
    """The port's analyzer finds exactly the two G032 lines of the planted
    source: the capture of the churned closure and the loop's call of the
    function that makes it (related to that capture); the memoised path is
    clean."""
    found = analyze_paths([PLANTED])
    assert [f.rule for f in found] == ["G032", "G032"], \
        [f.format() for f in found]
    site, loop = sorted(found, key=lambda f: f.line)
    assert "churn_score" in site.snippet
    assert loop.snippet == "out.append(fresh_scorer(b)(b))"
    assert loop.related[0][1] == site.line
    with open(PLANTED, encoding="utf-8") as fh:
        assert "jax" not in fh.read()
