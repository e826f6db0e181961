"""The port's dtype-flow layer (hivemall_tpu_torch/analysis/dtypeflow.py and
G003, G017-G021) held against torch and numpy themselves, and run over the
port's tree.

``dtypeflow.promote`` is compared with ``torch.promote_types`` on every pair
of the lattice's torch dtypes, with the result dtype of a real CPU op for
each weak Python / numpy scalar and 0-dim case, and with numpy's own
promotion; the flow's result dtype of small expressions is compared with
the expressions run in torch. The fixer round trips run on copies of the
torch twins (tests/data/graftcheck_torch/). The tree is scanned once, in a
module-scoped fixture; no test starts a subprocess.
"""

import collections
import contextlib
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from hivemall_tpu_torch.analysis import analyze_paths, analyze_source
from hivemall_tpu_torch.analysis import dtypeflow
from hivemall_tpu_torch.analysis.__main__ import main as _analysis_main
from hivemall_tpu_torch.analysis.baseline import load_baseline
from hivemall_tpu_torch.analysis.dtypeflow import promote, true_divide
from hivemall_tpu_torch.analysis.modmodel import build_model
from hivemall_tpu_torch.analysis.program import ProgramModel

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PKG = os.path.join(REPO, "hivemall_tpu_torch")
TWINS = os.path.join(TESTS, "data", "graftcheck_torch")
REF_BASELINE = os.path.join(REPO, "hivemall_tpu", "analysis",
                            "baseline.json")
DTYPE_RULES = ("G003", "G017", "G018", "G019", "G020", "G021")
FLOW_RULES = ("G017", "G018", "G019", "G020", "G021")

_TORCH = {n: getattr(torch, "bool" if n == "bool_" else n)
          for n in dtypeflow.TORCH_DTYPES}
_NP_NAMES = ("bool_", "int8", "int16", "int32", "int64", "uint8", "uint16",
             "uint32", "uint64", "float16", "float32", "float64")


def _tensor(name):
    return dtypeflow._CONCRETE[name]._replace(lib="torch")


def _array(name):
    return dtypeflow._CONCRETE[name]._replace(lib="np")


def _name(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return "bool_" if name == "bool" else name


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = _analysis_main(list(argv))
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def tree_findings():
    """One scan of the live package."""
    return analyze_paths([PKG])


# ---------------------------------------------------------------------------
# promote against torch and numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", dtypeflow.TORCH_DTYPES)
@pytest.mark.parametrize("a", dtypeflow.TORCH_DTYPES)
def test_promote_matches_torch_promote_types(a, b):
    got = promote(_tensor(a), _tensor(b))
    assert got is not None and got.lib == "torch" and got.scalar is False
    assert got.name == _name(torch.promote_types(_TORCH[a], _TORCH[b]))


# the other operand of a dimensioned tensor: (its abstract value, a real
# value of that kind)
_OTHERS = {
    "py_float": (dtypeflow.WEAK_FLOAT, 2.5),
    "py_int": (dtypeflow.WEAK_INT, 3),
    "np_float64": (_array("float64")._replace(scalar=True),
                   np.float64(2.5)),
    "np_float32": (_array("float32")._replace(scalar=True),
                   np.float32(2.5)),
    "np_int32": (_array("int32")._replace(scalar=True), np.int32(3)),
    "0dim_float64": (_tensor("float64")._replace(scalar=True),
                     torch.tensor(2.5, dtype=torch.float64)),
    "0dim_float16": (_tensor("float16")._replace(scalar=True),
                     torch.tensor(2.5, dtype=torch.float16)),
    "0dim_int64": (_tensor("int64")._replace(scalar=True), torch.tensor(3)),
    "0dim_bool": (_tensor("bool_")._replace(scalar=True),
                  torch.tensor(True)),
    "ndarray_float64": (_array("float64"), np.full(4, 2.5)),
    "ndarray0d_float64": (_array("float64"), np.asarray(2.5)),
    "ndarray_int32": (_array("int32"), np.full(4, 3, dtype=np.int32)),
}


@pytest.mark.parametrize("other", sorted(_OTHERS))
@pytest.mark.parametrize("a", dtypeflow.TORCH_DTYPES)
def test_promote_matches_a_torch_op_on_scalars(a, other):
    """A dimensioned tensor against a weak Python / numpy scalar, a 0-dim
    tensor or a numpy array: the result dtype of ``tensor * other`` on the
    CPU (None where it raises), whichever operand comes first."""
    abstract, value = _OTHERS[other]
    x = torch.ones(4, dtype=_TORCH[a])
    try:
        want = _name((x * value).dtype)
    except TypeError:  # a bf16 tensor against a numpy array
        want = None
    for got in (promote(_tensor(a), abstract),
                promote(abstract, _tensor(a))):
        assert (got.name, got.lib) == (want, "torch") if want \
            else got is None


@pytest.mark.parametrize("a,b", [
    ("int32", "float16"), ("bfloat16", "float16"), ("int64", "float16"),
    ("uint8", "int8"), ("bool_", "int8"), ("float32", "float64")])
def test_promote_of_two_0dim_tensors_and_a_scalar(a, b):
    """0-dim against 0-dim is promote_types; a Python float against a
    0-dim int tensor is the default float."""
    x = torch.tensor(1, dtype=_TORCH[a])
    y = torch.tensor(1, dtype=_TORCH[b])
    zero = [_tensor(n)._replace(scalar=True) for n in (a, b)]
    got = promote(*zero)
    assert got.name == _name((x * y).dtype) and got.scalar is True
    got = promote(zero[0], dtypeflow.WEAK_FLOAT)
    assert got.name == _name((x * 2.5).dtype) and got.scalar is True


@pytest.mark.parametrize("b", _NP_NAMES)
@pytest.mark.parametrize("a", _NP_NAMES)
def test_promote_matches_numpy(a, b):
    """numpy arrays: np.promote_types; a Python float / int against the
    array: NEP 50's weak scalars, as numpy computes them."""
    got = promote(_array(a), _array(b))
    assert got is not None and got.lib == "np"
    assert got.name == np.promote_types(a, b).name.replace("bool", "bool_")
    x = np.ones(2, dtype=a)
    for weak, value in ((dtypeflow.WEAK_FLOAT, 2.5),
                        (dtypeflow.WEAK_INT, 3)):
        got = promote(_array(a), weak)
        assert got.name == (x * value).dtype.name.replace("bool", "bool_")


def test_unknown_library_is_the_intersection():
    """Operands whose library is unknown: the result only where torch and
    numpy agree (int32 + float16 is float16 in torch, float64 in numpy)."""
    plain = dtypeflow._CONCRETE
    agree = disagree = 0
    for a in dtypeflow.TORCH_DTYPES:
        for b in dtypeflow.TORCH_DTYPES:
            t = torch.promote_types(_TORCH[a], _TORCH[b])
            if "bfloat16" in (a, b):
                n = None
            else:
                n = np.promote_types(a.rstrip("_"), b.rstrip("_"))
            got = promote(plain[a], plain[b])
            if n is not None and _name(t) == n.name.replace("bool",
                                                            "bool_"):
                assert got.name == _name(t) and got.lib == ""
                agree += 1
            elif n is not None:
                assert got is None, (a, b)
                disagree += 1
    assert agree and disagree
    assert promote(plain["int32"], plain["float16"]) is None
    assert promote(_tensor("int32"), _tensor("float16")).name == "float16"
    assert promote(_array("int32"), _array("float16")).name == "float64"


@pytest.mark.parametrize("a,b", [("int32", "int32"), ("int64", "int8"),
                                 ("float16", "int32"), ("bool_", "int16")])
def test_true_divide_matches_both_libraries(a, b):
    x, y = torch.ones(2, dtype=_TORCH[a]), torch.ones(2, dtype=_TORCH[b])
    assert true_divide(_tensor(a), _tensor(b)).name == _name((x / y).dtype)
    u = np.ones(2, dtype=a.rstrip("_"))
    v = np.ones(2, dtype=b.rstrip("_"))
    assert true_divide(_array(a), _array(b)).name == (u / v).dtype.name


# ---------------------------------------------------------------------------
# the flow against torch: an expression's dtype
# ---------------------------------------------------------------------------

_EXPRESSIONS = [
    "torch.as_tensor(np.zeros(3))",
    "torch.tensor(np.float64(1.0))",
    "torch.ones(2) * torch.from_numpy(np.ones(2))",
    "torch.ones(2, dtype=torch.int32) * np.ones(2, dtype=np.float16)",
    "torch.tensor(2, dtype=torch.int32) * np.ones(2, dtype=np.float16)",
    "torch.tensor([1.0])",
    "torch.tensor([1, 2])",
    "torch.tensor(1.0)",
    "torch.ones(2, dtype=torch.int32) + torch.ones(2, dtype=torch.float16)",
    "torch.ones(2, dtype=torch.bfloat16) + torch.ones(2, dtype=torch.half)",
    "torch.ones(2, dtype=torch.float16) * 2.0",
    "torch.ones(2, dtype=torch.float16) * np.float64(2.0)",
    "torch.ones(2) * torch.tensor(2.0, dtype=torch.float64)",
    "torch.ones(2, dtype=torch.int32) * torch.tensor(2.0, "
    "dtype=torch.double)",
    "torch.ones(2, dtype=torch.int32) * 2.0",
    "torch.ones(2, dtype=torch.int32).sum()",
    "torch.ones(2, dtype=torch.int32).cumsum(0)",
    "torch.ones(2, dtype=torch.float16).sum()",
    "torch.ones(2, dtype=torch.bool).sum()",
    "torch.sum(torch.ones(2, dtype=torch.float16), dtype=torch.float32)",
    "torch.ones(2, dtype=torch.int32) / 2",
    "torch.ones(2, dtype=torch.float16) / 2",
    "torch.full((2,), 1.0)",
    "torch.full((2,), 1)",
    "torch.arange(3)",
    "torch.arange(3.0)",
    "torch.zeros(3)",
    "torch.ones(2, dtype=torch.float16).float()",
    "torch.ones(2).to(torch.float16)",
    "torch.ones(2).to('cpu', torch.bfloat16)",
    "torch.ones(2).to(dtype=torch.double)",
    "torch.ones(2, dtype=torch.half).to('cpu')",
    "torch.ones(2).type(torch.int64)",
    "torch.ones(2).long()",
    "torch.ones(2).int()",
    "torch.ones(2, dtype=torch.float16).new_zeros(3)",
    "torch.zeros_like(torch.ones(2, dtype=torch.int8))",
    "torch.maximum(torch.ones(2, dtype=torch.bfloat16), "
    "torch.ones(2, dtype=torch.float64))",
    "torch.where(torch.ones(2) > 0, torch.ones(2, dtype=torch.half), 0.0)",
    "torch.ones(2, dtype=torch.float16).index_add_(0, torch.arange(2), "
    "torch.ones(2, dtype=torch.float16))",
    "np.asarray([0.5, 1.0])",
    "np.ones(2, dtype=np.float32) * 2.0",
    "np.ones(2, dtype=np.int32) * 2.0",
    "np.linspace(0, 1, 3)",
]


@pytest.mark.parametrize("expr", _EXPRESSIONS)
def test_flow_matches_torch(expr):
    """The flow's dtype of ``expr`` (a function's return) equals the dtype
    torch / numpy give it on the CPU."""
    src = ("import numpy as np\nimport torch\n\n\ndef f():\n"
           f"    return {expr}\n")
    program = ProgramModel({})
    model = build_model("probe.py", src)
    program.modules["probe.py"] = model
    fn = model.functions[0]
    got = dtypeflow.get_model(program).facts("probe.py", fn).return_dt
    value = eval(expr, {"np": np, "torch": torch})  # noqa: S307
    want = _name(value.dtype) if isinstance(value, torch.Tensor) \
        else value.dtype.name.replace("bool", "bool_")
    assert got is not None and got.name == want


# ---------------------------------------------------------------------------
# the rules on torch code
# ---------------------------------------------------------------------------

_HOT = "hivemall_tpu_torch/ops/fixture.py"


@pytest.mark.parametrize("expr,flagged", [
    ("q * torch.ones(4)", True),
    ("q * w[idx]", True),
    ("q * 2.0", False),
    ("q * np.float32(2.0)", False),
    ("q * torch.tensor(2.0)", False),
    ("q * torch.tensor(2.0, dtype=torch.float64)", False),
    ("q * w[0]", False),
    ("q * w.sum()", False),
    ("q @ torch.ones(4)", False),
    ("q.float() * torch.ones(4)", False),
])
def test_g017_reads_torch_promotion(expr, flagged):
    """A bf16 tensor widens only against a dimensioned f32 operand: a
    wrapped number, a 0-dim tensor (a full reduction, a constant index)
    and an explicit cast do not, and ``@`` raises rather than promote."""
    src = ("import numpy as np\nimport torch\n\n\ndef f():\n"
           "    q = torch.zeros(4, dtype=torch.bfloat16)\n"
           "    w = torch.ones(4)\n    idx = torch.arange(4)\n"
           f"    return {expr}\n")
    got = [(f.line, f.rule) for f in analyze_source(src, _HOT)
           if f.rule == "G017"]
    assert got == ([(9, "G017")] if flagged else [])


@pytest.mark.parametrize("body,flagged", [
    ("for b in blocks:\n        out.append(table.to(dev)[b])", False),
    ("for b in blocks:\n        out.append(table.to(torch.half)[b])", True),
    ("for b in blocks:\n        out.append(table[b].float())", False),
    ("for b in blocks:\n        out.append(table.cpu().numpy()[b])", False),
])
def test_g019_casts_and_device_moves(body, flagged):
    src = ("import torch\n\n\ndef f(table, blocks, dev):\n    out = []\n"
           f"    {body}\n    return out\n")
    got = [f.rule for f in analyze_source(src, _HOT) if f.rule == "G019"]
    assert got == (["G019"] if flagged else [])


@pytest.mark.parametrize("call,flagged", [
    ("acc.index_add_(0, idx, upd)", True),
    ("acc.scatter_add_(0, idx, upd)", True),
    ("acc.scatter_reduce_(0, idx, upd, 'sum')", True),
    ("acc.scatter_reduce_(0, idx, upd, reduce='amax')", False),
    ("acc.index_put_((idx,), upd, accumulate=True)", False),
    ("acc.index_put_((idx,), upd)", False),
    ("torch.index_add(acc, 0, idx, upd)", True),
    ("acc.cumprod(0)", True),
    ("acc.prod()", False),
    ("acc.to(torch.float32).index_add_(0, idx, upd)", False),
    ("h.sum()", True),
    ("np.cumsum(h)", True),
    ("np.sum(h, dtype=np.float32)", False),
])
def test_g021_follows_the_cards_accumulators(call, flagged):
    """On the card, index_put_(accumulate) and full reductions keep a
    float32 running sum; index_add_ / scatter_add_ / scatter_reduce_
    'sum' and cumprod accumulate bf16; numpy's sum accumulates 16 bits."""
    src = ("import numpy as np\nimport torch\n\n\ndef f(idx, upd):\n"
           "    acc = torch.zeros(8, dtype=torch.bfloat16)\n"
           "    h = np.ones(8, dtype=np.float16)\n"
           f"    return {call}\n")
    got = [f.rule for f in analyze_source(src, _HOT) if f.rule == "G021"]
    assert got == (["G021"] if flagged else [])


@pytest.mark.parametrize("expr,flagged", [
    ("torch.as_tensor(np.asarray([0.5, 1.0]))", True),
    ("torch.from_numpy(np.linspace(0.0, 1.0, 5))", True),
    ("torch.tensor(np.ones(3, dtype=np.float32) * np.float64(0.5))", True),
    ("torch.as_tensor(np.linspace(0.0, 1.0, 5), dtype=torch.float32)",
     False),
    ("torch.as_tensor(np.linspace(0.0, 1.0, 5)).float()", False),
    ("torch.as_tensor(np.linspace(0.0, 1.0, 5)).to('cuda')", True),
    ("torch.tensor([0.5, 1.0])", False),
    ("torch.as_tensor(np.asarray([1, 2]))", False),
    ("torch.as_tensor(payload)", False),
])
def test_g018_sees_numpy_float64_reach_a_tensor(expr, flagged):
    src = ("import numpy as np\nimport torch\n\n\ndef f(payload):\n"
           f"    return {expr}\n")
    path = "hivemall_tpu_torch/serving/fixture.py"
    got = [(f.line, f.rule) for f in analyze_source(src, path)
           if f.rule == "G018"]
    assert got == ([(6, "G018")] if flagged else [])


def test_g003_flags_torch_float64_in_update_math():
    src = ("import torch\n\n\ndef f(x, w):\n"
           "    a = x.to(torch.float64)\n    b = w.double()\n"
           "    return torch.zeros(2, dtype=torch.double) + a + b\n")
    got = [(f.line, f.rule, f.severity) for f in
           analyze_source(src, "hivemall_tpu_torch/models/fixture.py")]
    assert got == [(5, "G003", "error"), (6, "G003", "error"),
                   (7, "G003", "error")]
    assert analyze_source(src, "hivemall_tpu_torch/sql/fixture.py") == []


# ---------------------------------------------------------------------------
# the fixer
# ---------------------------------------------------------------------------

def test_fixer_round_trip_g018_f64(tmp_path):
    """--fix on the G018 twin: torch.float64 rewrites to torch.float32,
    dtype-less numpy constructors gain dtype=np.float32, the unfixable
    .double() survives without a fix, and --fix-check agrees afterwards
    (the twin of the reference's round trip)."""
    target = tmp_path / "g018_case.py"
    shutil.copy(os.path.join(TWINS, "g018_pos.py"), target)
    rc, out = _cli(str(target), "--fix", "--no-baseline")
    assert rc == 0, out
    assert "--- a/" in out, "fix must print a diff preview"
    fixed = target.read_text()
    assert "float64" not in fixed
    assert "torch.as_tensor(instances, dtype=torch.float32)" in fixed
    assert "torch.as_tensor(np.zeros(n, dtype=np.float32))" in fixed
    assert "torch.from_numpy(np.zeros((0, n), dtype=np.float32))" in fixed
    assert "torch.tensor(np.ones(n, dtype=np.float32))" in fixed
    assert "torch.as_tensor(np.full((n,), 0.5, dtype=np.float32))" in fixed
    remaining = [f for f in analyze_paths([str(target)])
                 if f.rule == "G018"]
    assert [(f.snippet, f.fix) for f in remaining] == \
        [("return w.double()  # EXPECT: G018", None)]
    rc, out = _cli(str(target), "--fix-check", "--no-baseline")
    assert rc == 0 and "no applicable fixes" in out
    assert target.read_text() == fixed


def test_fixer_pins_a_numpy_float64_handed_to_torch(tmp_path):
    target = tmp_path / "stage.py"
    target.write_text("# graftcheck: serving-module\nimport numpy as np\n"
                      "import torch\n\n\ndef stage():\n"
                      "    return torch.as_tensor(np.asarray([0.5, 1.0]))\n")
    rc, out = _cli(str(target), "--fix", "--no-baseline")
    assert rc == 0, out
    assert "torch.as_tensor(np.asarray([0.5, 1.0]), dtype=torch.float32)" \
        in target.read_text()
    assert analyze_paths([str(target)]) == []
    assert _cli(str(target), "--fix", "--no-baseline")[1].startswith(
        "graftcheck: no applicable fixes")


def test_fixer_leaves_g003_as_the_reference_does(tmp_path):
    """The reference's G003 emits no fix; neither does the port's: --fix on
    the G003 twin plans nothing and the findings stay."""
    target = tmp_path / "g003_case.py"
    shutil.copy(os.path.join(TWINS, "g003_pos.py"), target)
    before = target.read_text()
    found = analyze_paths([str(target)])
    assert [f.rule for f in found] == ["G003"] * 5
    assert all(f.fix is None for f in found)
    rc, out = _cli(str(target), "--fix", "--no-baseline")
    assert rc == 0 and "no applicable fixes" in out
    assert target.read_text() == before
    assert _cli(str(target), "--fix-check", "--no-baseline")[0] == 0


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

def test_ops_and_serving_are_dtype_clean(tree_findings):
    """The bar of the reference's test of the same name: ops/, kernels/,
    serving/, io/, core/batch_update.py and core/native_batch.py carry
    no G017-G021 finding, and none is baselined."""
    scopes = tuple(f"hivemall_tpu_torch/{p}" for p in (
        "ops/", "kernels/", "serving/", "io/", "core/batch_update.py",
        "core/native_batch.py"))
    hits = [f for f in list(tree_findings) + load_baseline()
            if f.rule in FLOW_RULES and f.path.startswith(scopes)]
    assert hits == [], "\n".join(f.format() for f in hits)


def test_the_baseline_holds_only_the_references_g003_debt():
    """Each accepted finding is a G003 whose snippet the reference's
    baseline accepts at the same module of the JAX package."""
    with open(REF_BASELINE, encoding="utf-8") as fh:
        ref = collections.Counter(
            (f["rule"], f["path"].replace("hivemall_tpu/", "", 1),
             f["snippet"]) for f in json.load(fh)["findings"])
    ours = collections.Counter(
        (b.rule, b.path.replace("hivemall_tpu_torch/", "", 1), b.snippet)
        for b in load_baseline())
    assert sum(ref.values()) == 13 and {r for r, _, _ in ref} == {"G003"}
    assert ours and not ours - ref, ours - ref


# each inline suppression of a dtype rule in the port's tree, by module
# and rule: the reference's three G018 sites and the port's own float64
# designs (ROADMAP Queue 3), each with its reason on the line
DTYPE_SUPPRESSIONS = {
    ("serving/engine.py", "G018"): 1,
    ("serving/artifact.py", "G018"): 2,
    ("ops/mxu_scatter.py", "G003"): 3,
    ("ops/scatter.py", "G003"): 1,
    ("models/trees/grow.py", "G003"): 1,
    ("models/trees/forest.py", "G003"): 2,
}


def test_dtype_suppressions_are_the_reviewed_sites():
    import re

    pattern = re.compile(r"#\s*graftcheck:\s*disable=([A-Z0-9,]+)"
                         r"\s*\(.+\)")
    found = {}
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py") or "analysis" in root.split(os.sep):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, PKG).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    m = pattern.search(line)
                    for rule in (m.group(1).split(",") if m else ()):
                        if rule in DTYPE_RULES:
                            found[(rel, rule)] = found.get((rel, rule), 0) + 1
    assert found == DTYPE_SUPPRESSIONS


# ---------------------------------------------------------------------------
# the accumulators (scripts/torch_accum_probe.py)
# ---------------------------------------------------------------------------

def _probe():
    spec = importlib.util.spec_from_file_location(
        "torch_accum_probe", os.path.join(REPO, "scripts",
                                          "torch_accum_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_cpu_shares_the_cards_wide_full_reductions():
    """The calls dtypeflow names as float32 accumulators on the card that
    accumulate wide on this CPU too — and the CPU's differences that the
    module's docstring states."""
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = _probe().probe("cpu")
    wide = {k.split("/")[0] for k, v in cpu.items() if v == "wide"}
    assert wide & dtypeflow.TORCH_WIDE_ACCUMULATORS == \
        {"sum", "nansum", "mean", "cumsum"}
    assert dtypeflow.TORCH_WIDE_ACCUMULATORS - wide == \
        {"prod", "segment_reduce", "index_put_"}
    assert {"scatter_add_", "scatter_reduce_"} <= wide


def test_dtypeflow_docstring_names_each_departure():
    for word in ("weak", "0-dim", "wrapped number", "float32", "int64",
                 "index_add_", "TORCH_WIDE_ACCUMULATORS", ".to(device)"):
        assert word in dtypeflow.__doc__, word
