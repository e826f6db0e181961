"""graftcheck's collective layer for the port and the TF32 repair it
guards: the per-function collective summaries against the port's
collective signatures (core/collectives.py), mesh resolution through
locals, ``self`` attributes and call edges, the collective rules G004,
G007, G008, G010 and G011 on torch snippets, the TF32 helper of
runtime/torch_compat.py under each of torch's spellings, and G009's
table against the installed torch's own files.

The rules' fixtures (tests/data/graftcheck_torch/g004_*, g007_* ... g011_*)
are held against the JAX package's analyzer in tests/test_torch_analysis.py.
"""

import ast
import os
import types
from importlib import metadata

import numpy as np
import pytest
import torch

from hivemall_tpu_torch.analysis import analyze_source, apicompat, config
from hivemall_tpu_torch.analysis.modmodel import build_model
from hivemall_tpu_torch.analysis.program import ProgramModel
from hivemall_tpu_torch.runtime import torch_compat

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
HEADER = ("import torch\nimport torch.distributed as dist\n\n"
          "from hivemall_tpu_torch.parallel.mesh import (\n"
          "    SHARD_AXIS, WORKER_AXIS, all_gather_host, gather_fields,\n"
          "    make_mesh, make_mesh_2d, pmean, psum)\n\n\n")
HEADER_LINES = HEADER.count("\n")


def _summary(body: str, name: str = "f"):
    model = build_model("hivemall_tpu_torch/fixture.py", HEADER + body)
    program = ProgramModel({model.rel_path: model})
    fn = next(n for n in model.functions if n.name == name)
    return program, model, fn, program.summary(model.rel_path, fn)


def _found(body: str, path: str = "hivemall_tpu_torch/fixture.py"):
    """(line within `body`, rule) of every finding on the snippet."""
    return sorted((f.line - HEADER_LINES, f.rule)
                  for f in analyze_source(HEADER + body, path))


# ---------------------------------------------------------------------------
# repair (a): the summaries record the axis, not the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call,tail,axis", [
    ("psum(x, mesh, WORKER_AXIS)", "psum", ("name", "WORKER_AXIS")),
    ("pmean(x, mesh, 'shards')", "pmean", ("str", "shards")),
    ("all_gather_host(x, mesh, SHARD_AXIS)", "all_gather_host",
     ("name", "SHARD_AXIS")),
    ("gather_fields(s, names, mesh, ax)", "gather_fields", ("name", "ax")),
    ("mesh.index(ax)", "index", ("name", "ax")),
    ("self.mesh.index(self.axis)", "index", ("self", "axis")),
    ("psum(x, mesh=mesh, axis=ax)", "psum", ("name", "ax")),
])
def test_summaries_record_the_axis_not_the_mesh(call, tail, axis):
    """Each of the port's collective signatures puts the axis where
    config.COLLECTIVE_CALLS says, and the mesh beside it."""
    _, _, _, summ = _summary(
        f"def f(self, x, s, names, mesh, ax):\n    return {call}\n")
    ((node, got_tail, kind, value, mesh_expr),) = summ.collectives
    assert (got_tail, (kind, value)) == (tail, axis)
    assert ast.unparse(mesh_expr) in ("mesh", "self.mesh")


def test_torch_distributed_collectives_name_no_axis():
    """dist.* collectives are summarized (G011 reads them) with no axis
    and no mesh; a list's index and a bare all_reduce are no
    collectives."""
    _, _, _, summ = _summary(
        "def f(x, items):\n    dist.all_reduce(x)\n    dist.barrier()\n"
        "    torch.distributed.broadcast(x, 0)\n    items.index(3)\n"
        "    all_reduce(x)\n")
    assert [(t, k, v, m) for _, t, k, v, m in sorted(
        summ.collectives, key=lambda c: c[0].lineno)] == [
        ("all_reduce", None, None, None), ("barrier", None, None, None),
        ("broadcast", None, None, None)]


def test_collective_table_matches_the_ports_signatures():
    """The axis and mesh positions of config.COLLECTIVE_CALLS are the
    parameters named ``axis`` and ``mesh`` of core/collectives.py's
    functions; Mesh.index takes the axis first."""
    path = os.path.join(REPO, "hivemall_tpu_torch", "core", "collectives.py")
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    defs = {n.name: [a.arg for a in n.args.args] for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}
    for name in ("psum", "pmean", "all_gather_host", "gather_fields"):
        assert config.COLLECTIVE_CALLS[name] == (
            defs[name].index("axis"), defs[name].index("mesh")), name
    assert defs["index"] == ["self", "axis"]
    assert config.COLLECTIVE_CALLS["index"] == (0, config.MESH_RECEIVER)
    for name in config.DIST_COLLECTIVES:
        assert config.COLLECTIVE_CALLS[name] == (None, None)


def test_the_ports_collective_sites_record_their_axes():
    """Across the port's tree, no summarized collective of core/
    collectives.py's family records a mesh variable in its axis slot."""
    program = ProgramModel({})
    sites = 0
    for path, model in program.modules.items():
        if "/analysis/" in path:
            continue
        for fn in model.functions:
            for _, tail, kind, value, _ in program.summary(
                    path, fn).collectives:
                if tail in config.DIST_COLLECTIVES:
                    continue
                sites += 1
                assert not (kind == "name" and "mesh" in value), \
                    (path, tail, value)
    assert sites >= 40


# ---------------------------------------------------------------------------
# mesh resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr,axes", [
    ("make_mesh()", {"workers"}),
    ("make_mesh(axis_name=SHARD_AXIS)", {"shards"}),
    ("make_mesh(None, 'rows')", {"rows"}),
    ("make_mesh_2d(2, 2)", {"workers", "shards"}),
    ("make_mesh_2d(2, 2, shard_axis='cols')", {"workers", "cols"}),
    ("make_mesh(axis_name=name)", None),
])
def test_mesh_axes_of_the_ports_constructors(expr, axes):
    program, model, fn, _ = _summary(
        f"def f(name):\n    mesh = {expr}\n    return mesh\n")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    assert program.mesh_axes(model.rel_path, ret.value, fn) == axes


def test_mesh_resolution_trusts_what_the_path_decides():
    """A mesh assigned twice, or assigned over a parameter, is unknown."""
    program, model, fn, _ = _summary(
        "def f(mesh=None, flag=False):\n"
        "    if mesh is None:\n        mesh = make_mesh()\n"
        "    return mesh\n")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    assert program.mesh_axes(model.rel_path, ret.value, fn) is None


def test_g007_follows_self_mesh_and_gather_fields():
    """A mesh stored on self in __init__ binds the axis set of every
    method's collectives; gather_fields' axis is its fourth argument."""
    body = ("class Trainer:\n"
            "    def __init__(self):\n"
            "        self.mesh = make_mesh()\n"
            "        self.axis = SHARD_AXIS\n\n"
            "    def sync(self, state):\n"
            "        return gather_fields(state, ('w',), self.mesh,\n"
            "                             self.axis)\n\n"
            "    def loss(self, x):\n"
            "        return psum(x, self.mesh, WORKER_AXIS)\n")
    assert _found(body) == [(7, "G007")]


def test_g007_follows_a_mesh_across_two_call_edges():
    body = ("def leaf(x, m, ax):\n    return all_gather_host(x, m, ax)\n\n\n"
            "def mid(x, row_mesh):\n    return leaf(x, row_mesh, 'shards')\n"
            "\n\ndef root(x):\n    mesh = make_mesh_2d(2, 2, shard_axis='cols')\n"
            "    return mid(x, mesh)\n")
    assert _found(body) == [(2, "G007")]


def test_g008_reads_coords_groups_and_positional_mesh_args():
    body = ("def f(x):\n    mesh = make_mesh_2d(2, 2)\n"
            "    a = mesh.coords['rows']\n    b = mesh.groups[SHARD_AXIS]\n"
            "    return a, b, mesh.shape[WORKER_AXIS]\n")
    assert _found(body) == [(3, "G008")]


def test_g004_reads_the_axis_where_the_table_puts_it():
    """A typo'd literal axis in gather_fields' fourth slot is G004; a mesh
    built with a tuple of literal axis names declares them."""
    body = ("def f(s, mesh):\n"
            "    other = Mesh(('rows', 'cols'), {}, {}, {}, None)\n"
            "    a = gather_fields(s, ('w',), mesh, 'shard')\n"
            "    return a, psum(s, other, 'cols'), dist.barrier()\n")
    header_mesh = "from hivemall_tpu_torch.core.collectives import Mesh\n"
    found = analyze_source(header_mesh + HEADER + body,
                           "hivemall_tpu_torch/fixture.py")
    assert [(f.line - HEADER_LINES - 1, f.rule) for f in found] == \
        [(3, "G004")]


# ---------------------------------------------------------------------------
# G010 and G011 on the port's idioms
# ---------------------------------------------------------------------------

def test_g010_flags_a_closure_that_drops_its_psum():
    """The stripe_score factory's body, with its psum taken out: the
    closure's partial sum over the factory's stripe escapes."""
    good = ("def stripe_score(mesh, axis_name):\n"
            "    shard = mesh.index(axis_name)\n\n"
            "    def local_score(w, x):\n"
            "        return psum(torch.sum(w[shard] * x), mesh, axis_name)\n"
            "\n    return local_score\n")
    bad = good.replace("psum(torch.sum(w[shard] * x), mesh, axis_name)",
                       "torch.sum(w[shard] * x)")
    assert _found(good) == []
    assert _found(bad) == [(5, "G010")]


def test_g010_counts_only_a_reduction_over_the_sliced_axis():
    body = ("def f(w, mesh):\n    part = (w * mesh.index(SHARD_AXIS)).sum()\n"
            "    return pmean(part, mesh, {axis})\n")
    assert _found(body.format(axis="SHARD_AXIS")) == []
    assert _found(body.format(axis="WORKER_AXIS")) == [(3, "G010")]


@pytest.mark.parametrize("test", [
    "dist.get_rank() == 0", "rank == 0", "mesh.coords[WORKER_AXIS] > 0",
    "self.shard == 0", "torch.any(flag)", "flag.all()"])
def test_g011_flags_a_barrier_below_a_rank_test(test):
    """A rank-dependent test (this rank's place, or its own tensor data)
    around a call whose callee reaches a collective: the collective is
    flagged where it is, through the call graph."""
    body = ("def sync():\n    dist.barrier()\n\n\n"
            "class T:\n    def __init__(self, mesh):\n"
            "        self.shard = mesh.index(WORKER_AXIS)\n\n"
            "    def step(self, mesh, flag):\n"
            "        rank = dist.get_rank()\n"
            f"        if {test}:\n            sync()\n")
    assert _found(body) == [(2, "G011")]


@pytest.mark.parametrize("test", [
    "dist.get_world_size() > 1", "dist.is_initialized()",
    "flag.item() > 0", "mesh.shape[WORKER_AXIS] > 1"])
def test_g011_trusts_world_uniform_tests(test):
    """The world size, an initialised world, a flag MAX-reduced over the
    ranks first and an axis' size are the same on every rank."""
    body = ("def f(mesh, x):\n    flag = torch.zeros(1)\n"
            "    dist.all_reduce(flag, op=dist.ReduceOp.MAX)\n"
            f"    if {test}:\n        dist.barrier()\n"
            "        return psum(x, mesh, WORKER_AXIS)\n    return x\n")
    assert _found(body) == []


# ---------------------------------------------------------------------------
# repair (b): the TF32 helper
# ---------------------------------------------------------------------------

MATMUL = torch.backends.cuda.matmul
NEW_API = hasattr(torch.backends, "fp32_precision")


@pytest.fixture
def tf32_flags():
    """Restore every TF32 setting a case makes: the global and matmul
    fp32_precision and the legacy matmul precision, in the order that
    leaves torch's two states as they were."""
    if not NEW_API:
        prev = MATMUL.allow_tf32
        yield
        MATMUL.allow_tf32 = prev
        return
    before = (torch.backends.fp32_precision, MATMUL.fp32_precision,
              torch.get_float32_matmul_precision(), MATMUL.allow_tf32)
    yield
    torch.backends.fp32_precision = before[0]
    torch.set_float32_matmul_precision(before[2])
    MATMUL.fp32_precision = before[1]
    assert (torch.backends.fp32_precision, MATMUL.fp32_precision,
            torch.get_float32_matmul_precision(), MATMUL.allow_tf32) == \
        before


def _set_legacy():
    MATMUL.allow_tf32 = True


def _set_matmul():
    MATMUL.fp32_precision = "tf32"


def _set_global():
    torch.backends.fp32_precision = "tf32"
    MATMUL.fp32_precision = "none"


def _set_precision():
    torch.set_float32_matmul_precision("high")


SPELLINGS = [_set_legacy, _set_precision]
if NEW_API:
    SPELLINGS += [_set_matmul, _set_global]


def test_the_helper_reads_off_by_default(tf32_flags):
    assert torch_compat.tf32_matmul_enabled() is False


@pytest.mark.parametrize("spelling", SPELLINGS,
                         ids=lambda f: f.__name__[5:])
def test_the_helper_reads_tf32_however_it_was_set(tf32_flags, spelling):
    """True after each spelling, without raising; off again after
    set_tf32_matmul(False), which leaves every reader working."""
    spelling()
    assert torch_compat.tf32_matmul_enabled() is True
    torch_compat.set_tf32_matmul(False)
    assert torch_compat.tf32_matmul_enabled() is False
    assert MATMUL.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.skipif(not NEW_API, reason="a torch without fp32_precision")
def test_the_legacy_read_raises_once_the_new_api_set_tf32(tf32_flags):
    """The hazard repaired: torch's own error on the legacy read, where
    the helper answers."""
    _set_matmul()
    with pytest.raises(RuntimeError, match="legacy and new APIs"):
        MATMUL.allow_tf32
    assert torch_compat.tf32_matmul_enabled() is True


@pytest.mark.parametrize("spelling", SPELLINGS,
                         ids=lambda f: f.__name__[5:])
def test_the_guards_refuse_with_the_ports_message(tf32_flags, spelling):
    """For a tensor on the card (a stand-in here), refuse_tf32 raises the
    port's message, naming both spellings, under each spelling; a CPU
    tensor passes, and both guards' CPU paths run."""
    from hivemall_tpu_torch.knn.distance import euclid_distance_batch
    from hivemall_tpu_torch.serving.retrieval import _check_f32_product

    spelling()
    card = types.SimpleNamespace(is_cuda=True)
    for what, guard in (
            ("knn batch distances compute", None),
            ("top-K retrieval scores", _check_f32_product)):
        with pytest.raises(RuntimeError) as err:
            if guard is None:
                torch_compat.refuse_tf32(card, what)
            else:
                guard(card)
        msg = str(err.value)
        assert msg.startswith(f"{what} in float32") and "allow_tf32" in msg \
            and "fp32_precision" in msg and "legacy and new" not in msg
    _check_f32_product(torch.zeros(2))
    a = np.eye(2, 3, dtype=np.float32)
    out = euclid_distance_batch(a, a, device="cpu")
    np.testing.assert_allclose(out.numpy(), [[0.0, 1.4142135],
                                             [1.4142135, 0.0]], rtol=1e-6)


def test_only_the_compat_module_touches_the_raw_flags():
    """Outside runtime/torch_compat.py, no module of the port, example or
    chip_smoke.py reads or writes a TF32 flag but through a suppression
    with its reason (chip_smoke's knn check sets both on purpose)."""
    hits = []
    roots = [os.path.join(REPO, "hivemall_tpu_torch"),
             os.path.join(REPO, "examples")]
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root in roots:
        for dirpath, _, names in os.walk(root):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    for path in files:
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        if rel == apicompat.COMPAT_MODULE_PATH or "/analysis/" in rel:
            continue
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
            fh.seek(0)
            lines = fh.read().splitlines()
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "allow_tf32", "fp32_precision"):
                line = lines[node.lineno - 1]
                if "graftcheck: disable=G009 (" not in line:
                    hits.append(f"{rel}:{node.lineno}")
    assert hits == []


# ---------------------------------------------------------------------------
# G009's table
# ---------------------------------------------------------------------------

def test_version_parsing_and_override(monkeypatch):
    assert apicompat.parse_version("2.13.0+cpu") == (2, 13, 0)
    assert apicompat.parse_version("2.11.0a0+git1234") == (2, 11, 0)
    monkeypatch.setenv("GRAFTCHECK_TORCH_VERSION", "2.9.1")
    assert apicompat.installed_torch_version() == (2, 9, 1)
    monkeypatch.delenv("GRAFTCHECK_TORCH_VERSION")
    assert apicompat.installed_torch_version() == \
        apicompat.parse_version(metadata.version("torch"))


@pytest.mark.parametrize("version,severity", [
    ("2.12.1", "warning"), ("2.13.0", "error"), ("2.14.0", "error")])
def test_g009_grades_by_the_version(monkeypatch, version, severity):
    """A spelling the given torch provably lacks is an error; before the
    bound, and for every unbounded entry, a warning."""
    monkeypatch.setenv("GRAFTCHECK_TORCH_VERSION", version)
    src = ("from torch._six import inf\nimport torch\n\n\n"
           "def f():\n    return torch.backends.cuda.matmul.allow_tf32\n")
    found = analyze_source(src, "probe.py", rules=["G009"])
    assert [(f.line, f.severity) for f in found] == \
        [(1, severity), (6, "warning")]


def test_the_table_holds_against_the_installed_torch():
    """Every module entry is in the installed torch's files exactly when
    the table says the installed version has it, and every flag is named
    in the source of the module that defines it."""
    dist = metadata.distribution("torch")
    files = {str(f).replace(os.sep, "/") for f in dist.files}
    version = apicompat.installed_torch_version()
    for name, entry in apicompat.LEGACY_IMPORT_MODULES.items():
        rel = name.replace(".", "/")
        present = f"{rel}.py" in files or f"{rel}/__init__.py" in files
        assert present == apicompat.available_in(entry, version), name
    sources = {"torch.backends.cuda.matmul": "torch/backends/cuda/__init__.py",
               "torch.backends.cudnn": "torch/backends/cudnn/__init__.py",
               "torch.backends": "torch/backends/__init__.py"}
    for entry in apicompat.API_TABLE:
        if entry.kind != "flag":
            continue
        owner, attr = entry.dotted.rsplit(".", 1)
        text = dist.locate_file(sources[owner]).read_text()
        assert attr in text, entry.dotted


@pytest.mark.parametrize("rel,module", [
    ("hivemall_tpu_torch/knn/distance.py", "..runtime.torch_compat"),
    ("hivemall_tpu_torch/models/trees/grow.py", "...runtime.torch_compat"),
    ("hivemall_tpu_torch/runtime/recovery.py", ".torch_compat"),
    ("examples/torch_knn.py", "hivemall_tpu_torch.runtime.torch_compat"),
])
def test_compat_import_module(rel, module):
    assert apicompat.compat_import_module(rel) == module


def test_the_compat_module_is_exempt():
    with open(os.path.join(REPO, *apicompat.COMPAT_MODULE_PATH.split("/")),
              encoding="utf-8") as fh:
        src = fh.read()
    assert "allow_tf32" in src
    assert analyze_source(src, apicompat.COMPAT_MODULE_PATH,
                          rules=["G009"]) == []
    found = analyze_source(src, "hivemall_tpu_torch/elsewhere.py",
                           rules=["G009"])
    assert "return bool(matmul.allow_tf32)" in {f.snippet for f in found}
