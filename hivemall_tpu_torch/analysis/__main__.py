"""CLI: ``python -m hivemall_tpu_torch.analysis [paths] [options]``.

Exit codes: 0 = clean against the baseline; 1 = new findings; 2 = usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from .baseline import (DEFAULT_BASELINE, diff_against_baseline,
                       load_baseline, write_baseline)
from .findings import Severity
from .runner import analyze_paths, iter_python_files, normalize_path


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(DEFAULT_BASELINE))))


def _new_findings(findings, paths, args):
    """Findings the baseline gate would report (all of them under
    --no-baseline) — the set --fix/--fix-check operates on, so
    baseline-accepted debt never fails the fix gate."""
    if args.no_baseline:
        return list(findings)
    scanned = [normalize_path(p) for p in iter_python_files(paths)]
    new, _ = diff_against_baseline(findings, load_baseline(args.baseline),
                                   scanned_paths=scanned)
    return new


def _run_fixes(findings, rules, check_only: bool, args) -> int:
    """--fix / --fix-check: plan every attached fix, show the diff, then
    (fix mode) write and re-scan the touched files to confirm the repairs
    landed. Idempotent by construction: applied fixes remove their own
    findings, so a second run plans nothing."""
    from .fixer import plan_fixes, render_diffs, write_fixes

    root = _repo_root()
    planned, notes = plan_fixes(findings, root=root)
    for note in notes:
        print(f"note: {note}")
    if not planned:
        print("graftcheck: no applicable fixes"
              + (" (clean)" if check_only else ""))
        return 0
    diff = render_diffs(planned)
    print(diff, end="" if diff.endswith("\n") else "\n")
    if check_only:
        print(f"graftcheck: --fix would modify {len(planned)} file(s) — "
              f"run `python -m hivemall_tpu_torch.analysis --fix`")
        return 1
    written = write_fixes(planned, root=root)
    print(f"graftcheck: fixed {len(written)} file(s): "
          + ", ".join(written))
    from .fixer import finding_fs_path
    fixed_paths = [finding_fs_path(p, root) for p in written]
    rescanned = _new_findings(analyze_paths(fixed_paths, rules=rules),
                              fixed_paths, args)
    refixable = [f for f in rescanned if f.fix is not None]
    if refixable:
        print("graftcheck: WARNING — findings with fixes remain after "
              "applying:")
        for f in refixable:
            print("  " + f.format())
        return 1
    print("graftcheck: re-scan of fixed files reports no remaining "
          "fixable findings")
    return 0


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hivemall_tpu_torch.analysis",
        description="graftcheck for the port: static analysis of "
                    "hivemall_tpu_torch — dtype and precision flow G003, "
                    "G017-G021 (float64 in update math, silent promotion "
                    "in hot paths, float64 reaching the card, casts in "
                    "loops, unpinned artifact reloads, 16-bit "
                    "accumulation) under torch's promotion rules, "
                    "concurrency/serving safety "
                    "G012-G016 (unguarded shared fields, blocking calls "
                    "under a lock, condition-variable misuse, thread "
                    "leaks, lock-ordering cycles) and FFI boundary safety "
                    "G022-G026 (unvalidated and borrowed pointers, missing "
                    "prototypes, ABI drift against the C and CUDA sources, "
                    "dropped status codes) and exception-flow / "
                    "failure-path safety G027-G031 (future leaks, silent "
                    "fallbacks, swallowed exceptions, unwind-unsafe "
                    "locking, unbounded retries) — with a --fix autofix "
                    "engine and SARIF output")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: hivemall_tpu_torch)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline json (default: packaged baseline)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept the current findings as the new baseline")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (e.g. G012,G022)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text",
                    help="sarif emits SARIF 2.1.0 of the non-baselined "
                         "findings for CI annotations")
    ap.add_argument("--output", default=None, metavar="FILE",
                    help="write the --format payload to FILE instead of "
                         "stdout; stdout then keeps the human-readable "
                         "text rendering (so the CI gate can archive a "
                         "SARIF artifact without losing the console "
                         "summary)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--fix", action="store_true",
                    help="apply machine-applicable fixes (with a unified-"
                         "diff preview), then re-scan the fixed files")
    ap.add_argument("--fix-check", action="store_true",
                    help="exit 1 if --fix would change anything (CI guard);"
                         " prints the would-be diff, writes nothing")
    ap.add_argument("--with-callers", action="store_true",
                    help="also scan package modules that (transitively) "
                         "import the given paths — interprocedural rules "
                         "can fire in an unchanged caller")
    ap.add_argument("--jobs", type=int, default=None, metavar="N",
                    help="thread-pool width for per-file module rules "
                         "(default min(4, cpus); 1 forces serial); "
                         "finding order is deterministic either way")
    args = ap.parse_args(argv)

    if args.output is not None:
        # a silently-unwritten artifact is worse than a usage error: a CI
        # step would upload a stale file from a previous run
        if args.format == "text":
            ap.error("--output requires --format sarif or --format json")
        if args.fix or args.fix_check or args.update_baseline:
            ap.error("--output applies to report runs only, not "
                     "--fix/--fix-check/--update-baseline")

    if args.list_rules:
        from .rules import RULE_DOCS
        for rule_id in sorted(RULE_DOCS):
            print(f"{rule_id}  {RULE_DOCS[rule_id]}")
        return 0

    paths = args.paths or ["hivemall_tpu_torch"]
    # a typo'd path must be a loud usage error, not a silent 'clean' exit —
    # a CI gate pointed at nothing would otherwise check nothing
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print("graftcheck: no such path(s): " + ", ".join(missing),
              file=sys.stderr)
        return 2
    if not any(True for _ in iter_python_files(paths)):
        print("graftcheck: no python files under: " + ", ".join(paths),
              file=sys.stderr)
        return 2
    rules = [r.strip().upper() for r in args.rules.split(",")] \
        if args.rules else None
    if args.with_callers:
        from .runner import expand_to_callers
        paths = expand_to_callers(paths)
    findings = analyze_paths(paths, rules=rules, jobs=args.jobs)

    if args.fix or args.fix_check:
        # fix only what the baseline gate would report: baseline-accepted
        # debt must not fail --fix-check (the documented --update-baseline
        # workflow has to unblock CI)
        return _run_fixes(_new_findings(findings, paths, args), rules,
                          check_only=args.fix_check, args=args)

    if args.update_baseline:
        # a partial scan refreshes only the scanned files' entries; accepted
        # debt in unscanned (still-existing) files is carried over so
        # single-file `--update-baseline` runs cannot clobber it
        scanned = {normalize_path(p) for p in iter_python_files(paths)}
        repo_root = _repo_root()
        carried = [b for b in load_baseline(args.baseline)
                   if b.path not in scanned
                   and os.path.exists(os.path.join(repo_root,
                                                   *b.path.split("/")))]
        merged = sorted(carried + list(findings),
                        key=lambda f: (f.path, f.line, f.rule, f.message))
        out = write_baseline(merged, args.baseline)
        print(f"graftcheck: baseline updated: {out} ({len(findings)} "
              f"scanned + {len(carried)} carried finding(s))")
        return 0

    if args.no_baseline:
        new, stale = list(findings), []
    else:
        scanned = [normalize_path(p) for p in iter_python_files(paths)]
        new, stale = diff_against_baseline(findings, load_baseline(
            args.baseline), scanned_paths=scanned)

    payload = None
    if args.format == "sarif":
        from .sarif import render_sarif
        payload = json.dumps(render_sarif(new), indent=1)
    elif args.format == "json":
        payload = json.dumps({
            "new": [f.to_dict() for f in new],
            "stale": [f.to_dict() for f in stale],
            "total": len(findings),
        }, indent=1)
    if payload is not None and args.output is not None:
        # archive the machine payload, keep the console human-readable —
        # the CI gate uploads the file as an annotation artifact while the
        # log still shows the findings
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(payload + "\n")
        _print_text(new, stale, findings)
        print(f"graftcheck: {args.format} written to {args.output}")
    elif payload is not None:
        print(payload)
    else:
        _print_text(new, stale, findings)
    return 1 if new else 0


def _print_text(new, stale, findings) -> None:
    for f in new:
        print(f.format())
    for b in stale:
        print(f"note: stale baseline entry ({b.rule} {b.path}: "
              f"{b.snippet!r}) — refresh with --update-baseline")
    n_err = sum(1 for f in new if f.severity == Severity.ERROR)
    n_warn = len(new) - n_err
    if new:
        print(f"graftcheck: {n_err} error(s), {n_warn} warning(s) not "
              f"in baseline ({len(findings)} total findings)")
    else:
        print(f"graftcheck: clean ({len(findings)} baselined finding(s)"
              f", {len(stale)} stale)" if (findings or stale)
              else "graftcheck: clean")


if __name__ == "__main__":
    sys.exit(main())
