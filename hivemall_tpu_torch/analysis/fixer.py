"""Autofix engine: apply the machine-applicable edits findings carry.

A fix is deliberately tiny — within-line substring replacements plus an
optional "make sure this import exists" request (findings.Fix) — which
buys two properties the rules rely on:

- **one-pass safety**: within-line edits never shift line numbers, so
  every fix collected in a single scan applies against the same line
  numbering; import insertion (which does add a line) runs last, per
  file, against the already-edited source;
- **ordered multi-line wraps**: G030's try/finally wrap
  (findings.WrapFinally) DOES insert lines, so wraps apply after every within-line edit,
  bottom-up by start line (lower wraps first never shift an upper wrap's
  numbering), each re-validated against the release line's current text;
- **idempotence**: an applied fix removes its own finding, so a second
  ``--fix`` run collects no edits and writes nothing — the property
  ``--fix-check`` (and the round-trip tests) lock in.

Import requests are merged per target module: three findings that each
want a name from one module produce one import statement (or extend an
existing one) with the union of names, inserted after the module's last
top-level import (falling back to after the docstring).
"""

from __future__ import annotations

import ast
import difflib
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

Result = Dict[str, Tuple[str, str]]  # path -> (old_source, new_source)


def finding_fs_path(path: str, root: str) -> str:
    """Filesystem location of a finding's (normalized) path. normalize_path
    emits cwd-relative paths for files outside the hivemall_tpu_torch
    package, so try the cwd interpretation first, then anchor package
    paths at the repo root (covers scans launched from other
    directories)."""
    if os.path.isabs(path):
        return path
    cand = os.path.abspath(path)
    if os.path.exists(cand):
        return cand
    return os.path.join(root, *path.split("/"))


def _insertion_line(tree: ast.Module) -> int:
    """1-based line AFTER which a new import goes: the last top-level
    import's end, else the docstring's end, else line 0 (file start)."""
    last = 0
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            last = max(last, node.end_lineno or node.lineno)
    if last:
        return last
    if tree.body and isinstance(tree.body[0], ast.Expr) \
            and isinstance(tree.body[0].value, ast.Constant) \
            and isinstance(tree.body[0].value.value, str):
        return tree.body[0].end_lineno or tree.body[0].lineno
    return 0


def _existing_from_import(tree: ast.Module, module: str
                          ) -> Optional[ast.ImportFrom]:
    """A top-level single-line `from <module> import ...` to extend."""
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            rendered = "." * node.level + (node.module or "")
            if rendered == module \
                    and (node.end_lineno or node.lineno) == node.lineno:
                return node
    return None


def _ensure_imports(source: str, wanted: Dict[str, Set[str]]) -> str:
    """Insert/extend `from <module> import <names>` for each requested
    module, skipping names already imported from it."""
    if not wanted:
        return source
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return source
    lines = source.splitlines(keepends=True)
    inserts: List[Tuple[int, str]] = []  # (after-line, text)
    replaces: Dict[int, str] = {}  # lineno -> new text
    for module in sorted(wanted):
        names = set(wanted[module])
        existing = _existing_from_import(tree, module)
        if existing is not None:
            # only an UNALIASED import satisfies a request for the bare
            # name (`import shard_map as smap` does not bind `shard_map`)
            have_bare = {a.name for a in existing.names
                         if a.asname is None}
            missing = sorted(names - have_bare)
            if not missing:
                continue
            # preserve `as` aliases on the names already there, and any
            # trailing comment (it may be a lint suppression)
            kept = [f"{a.name} as {a.asname}" if a.asname else a.name
                    for a in existing.names]
            entries = sorted(set(kept) | set(missing))
            old_line = lines[existing.lineno - 1]
            comment = ""
            if "#" in old_line:
                comment = "  #" + old_line.split("#", 1)[1].rstrip("\n")
            replaces[existing.lineno] = "from {} import {}{}\n".format(
                module, ", ".join(entries), comment)
        else:
            inserts.append((
                _insertion_line(tree),
                f"from {module} import {', '.join(sorted(names))}\n"))
    for lineno, text in replaces.items():
        lines[lineno - 1] = text
    for after, text in sorted(inserts, reverse=True):
        lines.insert(after, text)
    return "".join(lines)


def _apply_wraps(lines: List[str], wraps, path: str, notes: List[str],
                 rules: Dict[int, str]) -> bool:
    """Apply WrapFinally repairs bottom-up (highest start first), so an
    applied wrap's inserted lines never shift a pending wrap above it."""
    applied = False
    for w in sorted(wraps, key=lambda w: -w.start):
        if not (1 <= w.start <= w.release_line <= len(lines)):
            notes.append(f"{path}:{w.start}: wrap for "
                         f"{rules.get(w.start, '?')} skipped — lines out "
                         f"of range (stale finding?)")
            continue
        release_raw = lines[w.release_line - 1]
        if release_raw.strip() != w.release_text:
            notes.append(
                f"{path}:{w.release_line}: wrap skipped — expected "
                f"release {w.release_text!r}, found "
                f"{release_raw.strip()!r} (stale finding?)")
            continue
        indent = release_raw[:len(release_raw) - len(release_raw.lstrip())]
        body = [("    " + ln if ln.strip() else ln)
                for ln in lines[w.start - 1:w.release_line - 1]]
        lines[w.start - 1:w.release_line] = (
            [indent + "try:\n"] + body +
            [indent + "finally:\n", indent + "    " + w.release_text + "\n"])
        applied = True
    return applied


def plan_fixes(findings: Sequence[Finding], root: str = "."
               ) -> Tuple[Result, List[str]]:
    """Compute the post-fix sources for every file a fixable finding
    points at. Returns ({path: (old, new)}, notes) — notes record edits
    that no longer matched their line (stale finding, manual edit since
    the scan) and were skipped."""
    notes: List[str] = []
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        if f.fix is not None:
            by_path.setdefault(f.path, []).append(f)
    out: Result = {}
    for path, flist in sorted(by_path.items()):
        fs_path = finding_fs_path(path, root)
        try:
            with open(fs_path, "r", encoding="utf-8") as fh:
                old_source = fh.read()
        except OSError as e:
            notes.append(f"{path}: unreadable, fixes skipped ({e})")
            continue
        lines = old_source.splitlines(keepends=True)
        wanted_imports: Dict[str, Set[str]] = {}
        wraps = []
        wrap_rules: Dict[int, str] = {}
        applied_any = False
        for f in flist:
            ok = True
            for edit in f.fix.edits:
                if not (1 <= edit.line <= len(lines)) \
                        or edit.old not in lines[edit.line - 1]:
                    notes.append(
                        f"{path}:{edit.line}: fix for {f.rule} skipped — "
                        f"expected text {edit.old!r} not found (stale "
                        f"finding?)")
                    ok = False
                    break
            if not ok:
                continue
            for edit in f.fix.edits:
                lines[edit.line - 1] = lines[edit.line - 1].replace(
                    edit.old, edit.new, 1)
            if f.fix.add_import is not None:
                module, name = f.fix.add_import
                wanted_imports.setdefault(module, set()).add(name)
            if f.fix.wrap is not None:
                wraps.append(f.fix.wrap)
                wrap_rules[f.fix.wrap.start] = f.rule
            applied_any = bool(f.fix.edits) or f.fix.add_import is not None \
                or applied_any
        if _apply_wraps(lines, wraps, path, notes, wrap_rules):
            applied_any = True
        if not applied_any:
            continue
        new_source = _ensure_imports("".join(lines), wanted_imports)
        if new_source != old_source:
            out[path] = (old_source, new_source)
    return out, notes


def render_diffs(result: Result) -> str:
    chunks = []
    for path, (old, new) in sorted(result.items()):
        chunks.append("".join(difflib.unified_diff(
            old.splitlines(keepends=True), new.splitlines(keepends=True),
            fromfile=f"a/{path}", tofile=f"b/{path}")))
    return "".join(chunks)


def write_fixes(result: Result, root: str = ".") -> List[str]:
    written = []
    for path, (_, new) in sorted(result.items()):
        fs_path = finding_fs_path(path, root)
        with open(fs_path, "w", encoding="utf-8") as fh:
            fh.write(new)
        written.append(path)
    return written
