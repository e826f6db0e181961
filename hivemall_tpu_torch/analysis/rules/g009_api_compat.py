"""G009 version-incompatible-torch-api: torch spellings that moved.

Some torch spellings moved between the versions the port meets (the
table is apicompat.py). The TF32 switch is the one that bit: on a torch
with the new ``fp32_precision`` API, a read of the legacy
``torch.backends.cuda.matmul.allow_tf32`` raises ``RuntimeError`` ("mix
of the legacy and new APIs") once a caller set TF32 the way torch now
documents, so a guard that reads it answers with torch's error instead of
its own refusal; and a read of ``fp32_precision`` alone breaks on a torch
from before it. ``torch.cuda.amp.*`` and ``torch.distributed._tensor``
are deprecated shims, ``torch._six`` is gone. The portable surface for
the flags is ``runtime/torch_compat.py``: a flag's read or write carries a
machine-applicable fix (``--fix``) that rewrites it to the helper and
routes the import through the compat module, which is itself exempt.

The rule reads calls, attribute reads and writes (the flags are
attributes, also through a local bound to their namespace: ``matmul =
torch.backends.cuda.matmul``), and imports. Severity: error when the installed torch
(package metadata or ``GRAFTCHECK_TORCH_VERSION``) provably lacks the
spelling — the code cannot run here; warning otherwise — it runs today
but breaks, or answers with torch's error, on another torch.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from ..apicompat import (API_BY_DOTTED, API_TABLE, COMPAT_MODULE_PATH,
                         ApiEntry, available_in, compat_import_module,
                         installed_torch_version, module_entry)
from ..findings import Edit, Finding, Fix, Severity
from ..modmodel import ModuleModel, dotted_name

RULE_ID = "G009"

# the last name of every spelling: a module without one has no finding
_NEEDLES = frozenset(e.dotted.rsplit(".", 1)[-1] for e in API_TABLE)


def _grade(entry: ApiEntry, version) -> str:
    avail = available_in(entry, version)
    return Severity.ERROR if avail is False else Severity.WARNING


def _clause(entry: ApiEntry, version) -> str:
    if available_in(entry, version) is False:
        v = ".".join(str(p) for p in version)
        return f"not available in the installed torch {v}"
    return "version-fragile"


def _aliases(model: ModuleModel) -> Dict[str, str]:
    """Local names bound to a torch namespace: ``matmul =
    torch.backends.cuda.matmul``, ``from torch.backends.cuda import
    matmul``."""
    out: Dict[str, str] = {}
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            dotted = dotted_name(node.value)
            if dotted and dotted.startswith("torch."):
                out[node.targets[0].id] = dotted
        elif isinstance(node, ast.ImportFrom) and not node.level \
                and (node.module or "").startswith("torch."):
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _flag_fix(model: ModuleModel, node: ast.Attribute, dotted: str,
              entry: ApiEntry, compat_mod: str) -> Optional[Fix]:
    """A read becomes the helper's call; a one-line single-target write
    becomes the setter's call with the written value."""
    parent = getattr(node, "graftcheck_parent", None)
    line = model.snippet(node.lineno)
    if isinstance(node.ctx, ast.Load):
        text = ast.get_source_segment(model.source, node)
        if entry.compat_read is None or not text or text not in line \
                or isinstance(parent, ast.Call) and parent.func is node:
            return None
        return Fix(edits=(Edit(node.lineno, text,
                               entry.compat_read + "()"),),
                   add_import=(compat_mod, entry.compat_read))
    if entry.compat_write is None or not isinstance(parent, ast.Assign) \
            or len(parent.targets) != 1 or parent.lineno != parent.end_lineno:
        return None
    stmt = ast.get_source_segment(model.source, parent)
    value = ast.get_source_segment(model.source, parent.value)
    if not stmt or not value or stmt not in line:
        return None
    return Fix(edits=(Edit(node.lineno, stmt,
                           f"{entry.compat_write}({value})"),),
               add_import=(compat_mod, entry.compat_write))


def check(model: ModuleModel) -> List[Finding]:
    if model.rel_path == COMPAT_MODULE_PATH:
        return []  # the portability layer itself touches both spellings
    if not any(needle in model.source for needle in _NEEDLES):
        return []  # cheap pre-filter before the full AST walk
    version = installed_torch_version()
    compat_mod = compat_import_module(model.rel_path)
    findings: List[Finding] = []

    def add(line: int, entry: ApiEntry, what: str,
            fix: Optional[Fix] = None) -> None:
        findings.append(Finding(
            model.rel_path, line, RULE_ID, _grade(entry, version),
            f"{what} is {_clause(entry, version)}: {entry.note}; use "
            + (f"`{fix.add_import[1]}` from runtime/torch_compat.py "
               f"(machine-fixable: --fix)" if fix is not None
               else f"`{entry.replacement}`"),
            model.snippet(line), fix=fix))

    aliases = _aliases(model)
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Attribute):
            if isinstance(getattr(node, "graftcheck_parent", None),
                          ast.Attribute):
                continue  # only the whole chain is a spelling
            dotted = dotted_name(node)
            if dotted is None:
                continue
            root, _, rest = dotted.partition(".")
            full = f"{aliases[root]}.{rest}" if root in aliases else dotted
            entry = API_BY_DOTTED.get(full)
            if entry is not None and entry.kind != "module":
                fix = _flag_fix(model, node, dotted, entry, compat_mod) \
                    if entry.kind == "flag" else None
                verb = "call of" if entry.kind == "call" else (
                    "write of" if isinstance(node.ctx, ast.Store)
                    else "read of")
                add(node.lineno, entry, f"{verb} `{full}`", fix)
                continue
            entry = module_entry(dotted)
            if entry is not None:
                add(node.lineno, entry, f"use of `{dotted}`")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                entry = module_entry(alias.name)
                if entry is not None:
                    add(node.lineno, entry, f"import of `{alias.name}`")
        elif isinstance(node, ast.ImportFrom) and not node.level:
            mod = node.module or ""
            entry = module_entry(mod)
            if entry is not None:
                add(node.lineno, entry, f"import from `{mod}`")
                continue
            # `from torch.distributed import _tensor`
            for alias in node.names:
                entry = module_entry(f"{mod}.{alias.name}")
                if entry is not None:
                    add(node.lineno, entry,
                        f"import of `{mod}.{alias.name}`")
    return findings
