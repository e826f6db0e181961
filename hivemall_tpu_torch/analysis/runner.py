"""File walking + rule dispatch + diagnostics formatting.

Stdlib-only by design: graftcheck reads source and must run on hosts
without torch, a card or a CUDA toolkit.

Two rule tiers run over every scan:

- **module rules** (G003, G015) see one ModuleModel at a time;
- **program rules** (G012-G014, G016-G031) see the whole-program
  model (program.py), which is always built with the full package tree
  as context — a single-file scan resolves cross-module call edges
  exactly like a full scan, but only *emits* findings for the scanned
  files.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from .findings import (Finding, Severity, apply_suppressions,
                       parse_suppressions, sort_findings)
from .modmodel import ModuleModel
from .program import ProgramModel

_SKIP_DIRS = {"__pycache__", ".git", ".mypy_cache", ".pytest_cache"}
_PACKAGE = "hivemall_tpu_torch"


def normalize_path(path: str) -> str:
    """Stable repo-relative path: anchored at the `hivemall_tpu_torch`
    package when the file lives inside it (so baselines don't depend on
    the checkout location), else relative to cwd, else absolute."""
    ap = os.path.abspath(path)
    parts = Path(ap).parts
    if _PACKAGE in parts:
        idx = len(parts) - 1 - tuple(reversed(parts)).index(_PACKAGE)
        return "/".join(parts[idx:])
    rp = os.path.relpath(ap)
    if not rp.startswith(".."):
        return rp.replace(os.sep, "/")
    return ap.replace(os.sep, "/")


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        elif p.endswith(".py"):
            yield p


def default_jobs() -> int:
    return min(4, os.cpu_count() or 1)


def _run_rules(models: Dict[str, ModuleModel],
               parse_failures: List[Finding],
               sources: Dict[str, str],
               rules: Optional[Sequence[str]] = None,
               jobs: Optional[int] = None) -> List[Finding]:
    """Module rules per model + program rules over the whole set, then
    per-file suppressions.

    Module rules are independent per file, so with ``jobs > 1`` they run
    on a thread pool (default ``min(4, cpus)``). Results are collected
    per file in the submission order and the whole set goes through
    ``sort_findings`` at the end, so finding order — and therefore
    baseline and SARIF fingerprint stability — is identical to a serial
    run. Program rules share one mutable ProgramModel (memoized
    summaries, lazily-built concurrency/exception models) and stay
    serial."""
    from .rules import ALL_RULES, PROGRAM_RULES

    selected_module_rules = [
        (rule_id, check) for rule_id, check in ALL_RULES.items()
        if rules is None or rule_id in rules]

    def module_findings(model: ModuleModel) -> List[Finding]:
        out: List[Finding] = []
        for _rule_id, check in selected_module_rules:
            out.extend(check(model))
        return out

    findings: List[Finding] = list(parse_failures)
    jobs = default_jobs() if jobs is None else max(1, jobs)
    if jobs > 1 and len(models) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            for per_file in pool.map(module_findings, models.values()):
                findings.extend(per_file)
    else:
        for model in models.values():
            findings.extend(module_findings(model))
    selected_program_rules = [
        (rule_id, check_program)
        for rule_id, check_program in PROGRAM_RULES.items()
        if rules is None or rule_id in rules]
    if selected_program_rules:  # skip the package parse when filtered out
        program = ProgramModel(models)
        scanned = set(models)
        for rule_id, check_program in selected_program_rules:
            findings.extend(f for f in check_program(program, scanned)
                            if f.path in scanned)
    out: List[Finding] = []
    suppressions = {p: parse_suppressions(src) for p, src in sources.items()}
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    for p, flist in by_path.items():
        if p in suppressions:
            per_line, whole_file = suppressions[p]
            out.extend(apply_suppressions(flist, per_line, whole_file))
        else:
            out.extend(flist)
    return sort_findings(out)


def analyze_source(source: str, rel_path: str,
                   rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run graftcheck over one module's source. `rel_path` is the
    normalized path used for scope decisions (hot modules, dtype modules)
    and reporting."""
    try:
        model = ModuleModel(rel_path, source, ast.parse(source,
                                                        filename=rel_path))
    except SyntaxError as e:
        return [Finding(rel_path, e.lineno or 0, "G000", Severity.ERROR,
                        f"syntax error: {e.msg}", "")]
    return _run_rules({rel_path: model}, [], {rel_path: source}, rules)


def analyze_paths(paths: Sequence[str],
                  rules: Optional[Sequence[str]] = None,
                  jobs: Optional[int] = None) -> List[Finding]:
    from . import modelcache
    models: Dict[str, ModuleModel] = {}
    sources: Dict[str, str] = {}
    parse_failures: List[Finding] = []
    for path in iter_python_files(paths):
        rel = normalize_path(path)
        model = modelcache.cached_model(path, rel)
        if model is not None:
            # shared cache hit/build: package-context and scanned models
            # are the SAME objects, so per-module analysis memos persist
            # across scans instead of being rebuilt per analyze_paths call
            models[rel] = model
            sources[rel] = model.source
            continue
        # unreadable or unparsable: re-read for the precise G000 message
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            parse_failures.append(Finding(rel, 0, "G000", Severity.ERROR,
                                          f"unreadable: {e}", ""))
            continue
        try:
            models[rel] = ModuleModel(rel, source,
                                      ast.parse(source, filename=rel))
            sources[rel] = source
        except SyntaxError as e:
            parse_failures.append(Finding(rel, e.lineno or 0, "G000",
                                          Severity.ERROR,
                                          f"syntax error: {e.msg}", ""))
    findings = _run_rules(models, parse_failures, sources, rules, jobs)
    modelcache.save()
    return findings


def expand_to_callers(paths: Sequence[str]) -> List[str]:
    """The scanned set plus every package module that (transitively)
    imports one of the scanned modules — interprocedural rules can fire in
    an unchanged caller when its callee changed, so changed-files scans
    must include the callers. Returns filesystem paths; non-package inputs
    pass through untouched."""
    file_list = list(iter_python_files(paths))
    rel_of = {normalize_path(p): p for p in file_list}
    program = ProgramModel({}, with_package_context=True)
    targets = {r for r in rel_of if r in program.modules}
    if not targets:
        return file_list
    from .program import package_root
    root = os.path.dirname(package_root())
    extra = []
    for rel in sorted(program.importers_of(targets)):
        if rel in rel_of:
            continue
        fs = os.path.join(root, *rel.split("/"))
        if os.path.exists(fs):
            extra.append(fs)
    return file_list + extra
