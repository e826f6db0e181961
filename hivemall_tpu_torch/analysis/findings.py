"""Finding record + inline-suppression parsing.

A finding's identity for baseline purposes is ``(rule, path, snippet)`` —
the stripped source line, not the line number — so unrelated edits above a
known finding don't invalidate the baseline, while any edit to the flagged
line itself surfaces it again.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


class Severity:
    ERROR = "error"
    WARNING = "warning"

    ORDER = {ERROR: 0, WARNING: 1}


@dataclass(frozen=True)
class Edit:
    """One within-line text replacement: on `line`, the first occurrence of
    `old` becomes `new`. Within-line edits never shift other findings' line
    numbers, so every fix collected in one scan applies in one pass."""
    line: int  # 1-based
    old: str
    new: str


@dataclass(frozen=True)
class WrapFinally:
    """A multi-line repair for G030: indent lines `start`..`release_line-1`
    one level under an inserted ``try:`` and turn the release statement at
    `release_line` into ``finally:`` + the indented release.
    `release_text` is the stripped source of the release line at plan
    time — the fixer re-validates it so a stale plan never rewrites
    changed code."""
    start: int  # 1-based first line of the wrapped region
    release_line: int  # 1-based line of the X.release() statement
    release_text: str


@dataclass(frozen=True)
class Fix:
    """A machine-applicable repair attached to a finding. `add_import` is
    (module, name) — the fixer merges all requested names per module into
    one import statement and inserts/extends it idempotently. `wrap` is a
    try/finally wrap; wraps shift line numbers, so the fixer applies them
    after every within-line edit, bottom-up."""
    edits: Tuple[Edit, ...] = ()
    add_import: Optional[Tuple[str, str]] = None
    wrap: Optional[WrapFinally] = None


@dataclass(frozen=True)
class Finding:
    path: str  # repo-relative, forward slashes
    line: int  # 1-based
    rule: str  # "G012".."G031" ("G000" = parse failure)
    severity: str  # Severity.*
    message: str
    snippet: str  # stripped source of the flagged line (baseline key)
    # optional autofix; not part of identity/baseline and not serialized
    fix: Optional[Fix] = field(default=None, compare=False)
    # additional (path, line, snippet) locations — G025 points into the C
    # source alongside the Python declaration; SARIF renders them as extra
    # physicalLocations. Not part of identity/baseline and not serialized.
    related: Tuple[Tuple[str, int, str], ...] = field(default=(),
                                                     compare=False)

    @property
    def key(self):
        return (self.rule, self.path, self.snippet)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.severity}] {self.message}")

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "severity": self.severity,
            "message": self.message,
            "snippet": self.snippet,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(path=d["path"], line=int(d.get("line", 0)),
                   rule=d["rule"], severity=d.get("severity", Severity.ERROR),
                   message=d.get("message", ""), snippet=d.get("snippet", ""))


_DISABLE_RE = re.compile(
    r"#\s*graftcheck:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\s]+)")


def parse_suppressions(source: str):
    """Return (per_line, whole_file): per_line maps 1-based line number to the
    set of rule ids disabled on that line; whole_file is the set disabled for
    the entire module (``# graftcheck: disable-file=G0XX`` anywhere).
    ``all`` disables every rule."""
    per_line: Dict[int, Set[str]] = {}
    whole_file: Set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(text)
        if not m:
            continue
        rules = {r.strip().upper() for r in m.group("rules").split(",")
                 if r.strip()}
        if m.group("file"):
            whole_file |= rules
        else:
            per_line[i] = per_line.get(i, set()) | rules
    return per_line, whole_file


def apply_suppressions(findings: List[Finding], per_line, whole_file
                       ) -> List[Finding]:
    out = []
    for f in findings:
        disabled = whole_file | per_line.get(f.line, set())
        if "ALL" in disabled or f.rule in disabled:
            continue
        out.append(f)
    return out


def sort_findings(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule, f.message))
