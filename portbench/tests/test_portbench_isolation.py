"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port. Imports are read from the sources
(import statements, and string names handed to `import_module`,
`__import__` or `spec_from_file_location`) and from the configuration
files' `module`; each is compared by its top-level name, whole, since
`hivemall_tpu_torch` begins with `hivemall_tpu`."""

import ast
import json
import sys
from pathlib import Path

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hivemall_tpu"}
PORT = "hivemall_tpu_torch"
DYNAMIC = {"import_module", "__import__"}


def imported(path: Path):
    """Top-level names of the modules `path` imports, string imports
    included."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call):
            func = node.func
            called = getattr(func, "attr", getattr(func, "id", None))
            if called in DYNAMIC and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    return sorted(HERE.rglob("*.py"))


def test_sources_are_found():
    found = {p.relative_to(HERE).as_posix() for p in sources()}
    assert {"run.py", "harness.py", "reference/linear.py",
            "metrics/mfu.scan.py"} <= found


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p.relative_to(HERE).as_posix(): imported(p) & FORBIDDEN
           for p in sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_configurations_name_no_forbidden_module():
    for path in (HERE / "configs").glob("*.json"):
        module = json.loads(path.read_text())["module"]
        assert module.split(".")[0] not in FORBIDDEN, path


def test_reference_and_yardstick_import_nothing_of_the_port():
    yardstick = [p for p in sources() if p.name not in
                 ("harness.py", "control.py", "faults.py")
                 and "tests" not in p.parts]
    bad = {p.name: imported(p) for p in yardstick if PORT in imported(p)}
    assert not bad


def test_string_imports_are_read(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import importlib\nimportlib.import_module('jax.numpy')\n")
    assert imported(probe) == {"importlib", "jax"}


def test_loaded_modules_compared_whole(monkeypatch):
    loaded = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "hivemall_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_probe.sub", sys)
    assert set(harness.forbidden_modules()) == loaded
    monkeypatch.setitem(sys.modules, "hivemall_tpu.probe", sys)
    assert set(harness.forbidden_modules()) == loaded | {"hivemall_tpu"}
