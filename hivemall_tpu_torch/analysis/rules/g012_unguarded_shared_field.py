"""G012 unguarded-shared-field: a field two threads touch with no common lock.

The guarded-by inference (analysis/concurrency.py) computes, per class,
which ``self._x`` fields are touched under which locks — through ``with
self._lock:`` scopes and helper calls. A class that declares concurrency
(owns a lock, spawns a thread, or serves HTTP ``do_*`` handlers) must
then be consistent about it; two provable failure modes are flagged:

- **inconsistent discipline**: the field is guarded by a lock at some
  accesses but read/written bare at others — the unlocked access races
  with the locked writers (``registry.get()`` reading ``_entries`` while
  ``deploy()`` publishes under ``_lock``). Designed lock-free reads
  (GIL-atomic dict reads) are suppressed inline with a justification.
- **cross-thread, no lock at all**: the field is written on a spawned
  thread (``threading.Thread(target=self._loop)``) and accessed from
  caller-side methods, with no lock anywhere.

Fields written only in ``__init__`` are immutable-after-publish and
skipped; purely dynamic receivers are trusted.
"""

from __future__ import annotations

from typing import List, Set

from ..concurrency import get_model
from ..findings import Finding, Severity
from ..program import ProgramModel

RULE_ID = "G012"


def check_program(program: ProgramModel, scanned: Set[str]
                  ) -> List[Finding]:
    findings: List[Finding] = []
    cm = get_model(program)
    for (path, _cname), cls in sorted(cm.classes.items()):
        if path not in scanned or not cls.concurrent:
            continue
        model = program.modules[path]
        for field in sorted(cls.eff_accesses):
            accesses = [a for a in cls.eff_accesses[field]
                        if a.method not in ("__init__", "__new__")]
            if not accesses:
                continue
            writes = [a for a in accesses if a.write]
            if not writes:
                continue  # written only at construction: publish-immutable
            lock_names = set(cls.locks)
            guards = [frozenset(a.held) & lock_names for a in accesses]
            common = frozenset.intersection(*guards) if guards else frozenset()
            if common:
                continue  # consistently guarded
            guarded = [a for a, g in zip(accesses, guards) if g]
            unguarded = [a for a, g in zip(accesses, guards) if not g]
            if guarded and unguarded:
                locks = sorted({lk for g in guards for lk in g})
                ex = min(guarded, key=lambda a: a.line)
                seen_lines: Set[int] = set()
                for a in sorted(unguarded, key=lambda a: a.line):
                    if a.line in seen_lines:
                        continue
                    seen_lines.add(a.line)
                    verb = "written" if a.write else "read"
                    findings.append(Finding(
                        path, a.line, RULE_ID, Severity.ERROR,
                        f"field `self.{field}` of {cls.name} is guarded by "
                        f"`self.{'`/`self.'.join(locks)}` elsewhere "
                        f"({ex.method}(), line {ex.line}) but {verb} here "
                        f"with no lock held — inconsistent lock discipline "
                        f"is a data race under concurrent load",
                        model.snippet(a.line)))
            elif guarded:
                # every access is locked, but by DISJOINT locks: two locks
                # that never coincide don't exclude each other
                w = min(writes, key=lambda a: a.line)
                w_guard = frozenset(w.held) & lock_names
                seen_lines = set()
                for a in sorted(accesses, key=lambda a: a.line):
                    g = frozenset(a.held) & lock_names
                    if a.line == w.line or (g & w_guard) \
                            or a.line in seen_lines:
                        continue
                    seen_lines.add(a.line)
                    verb = "written" if a.write else "read"
                    findings.append(Finding(
                        path, a.line, RULE_ID, Severity.ERROR,
                        f"field `self.{field}` of {cls.name} is {verb} "
                        f"here under `self.{'`/`self.'.join(sorted(g))}` "
                        f"but written under "
                        f"`self.{'`/`self.'.join(sorted(w_guard))}` "
                        f"({w.method}(), line {w.line}) — disjoint locks "
                        f"do not exclude each other; guard every access "
                        f"with one common lock",
                        model.snippet(a.line)))
            else:
                # no lock anywhere: flag only when cross-thread is proven
                t_side = [a for a in accesses
                          if a.method in cls.thread_side]
                c_side = [a for a in accesses
                          if a.method not in cls.thread_side]
                if not (t_side and c_side):
                    continue
                other = min(c_side if writes[0] in t_side else t_side,
                            key=lambda a: a.line)
                seen_lines = set()
                for a in sorted(writes, key=lambda a: a.line):
                    if a.line in seen_lines:
                        continue
                    seen_lines.add(a.line)
                    findings.append(Finding(
                        path, a.line, RULE_ID, Severity.ERROR,
                        f"field `self.{field}` of {cls.name} is written "
                        f"here and accessed from {other.method}() (line "
                        f"{other.line}) on a different thread with no lock "
                        f"— guard both sides with one "
                        f"threading.Lock/Condition",
                        model.snippet(a.line)))
    return findings
