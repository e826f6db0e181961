"""SARIF 2.1.0 output: graftcheck findings as CI annotations.

SARIF (Static Analysis Results Interchange Format) is the log format
CI systems ingest to render findings as inline review annotations.
``python -m hivemall_tpu_torch.analysis --format sarif`` emits one run whose
``results`` are the findings the baseline gate would report (all of
them under ``--no-baseline``) — the same set that drives the exit code,
so the annotations and the gate never disagree.

Shape notes (the parts consumers actually key on):

- ``tool.driver.rules`` carries every registered rule with its one-line
  doc; ``results[].ruleIndex`` points back into that array;
- levels map severity directly (``error`` / ``warning``);
- ``partialFingerprints`` uses the baseline identity ``(rule, path,
  snippet)`` — stable across unrelated edits, exactly like
  ``analysis/baseline.py`` — so CI dedupes findings the same way the
  baseline does.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

from .findings import Finding, Severity

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://docs.oasis-open.org/sarif/sarif/v2.1.0/errata01/"
                "os/schemas/sarif-schema-2.1.0.json")
TOOL_VERSION = "7.0"
INFO_URI = "https://github.com/hivemall-tpu/hivemall-tpu" \
           "/blob/main/docs/static_analysis.md"

_LEVELS = {Severity.ERROR: "error", Severity.WARNING: "warning"}


def _fingerprint(f: Finding) -> str:
    key = f"{f.rule}\x1f{f.path}\x1f{f.snippet}"
    return hashlib.sha256(key.encode("utf-8")).hexdigest()[:32]


def _location(path: str, line: int, snippet: str) -> dict:
    return {
        "physicalLocation": {
            "artifactLocation": {
                "uri": path,
                "uriBaseId": "SRCROOT",
            },
            "region": {
                "startLine": max(1, line),
                "snippet": {"text": snippet},
            },
        },
    }


def render_sarif(findings: Sequence[Finding]) -> dict:
    from .rules import RULE_DOCS

    rule_ids = sorted(set(RULE_DOCS) | {f.rule for f in findings})
    rule_index: Dict[str, int] = {rid: i for i, rid in enumerate(rule_ids)}
    rules: List[dict] = []
    for rid in rule_ids:
        doc = RULE_DOCS.get(
            rid, "parse failure" if rid == "G000" else rid)
        rules.append({
            "id": rid,
            "name": doc.split(":", 1)[0].strip(),
            "shortDescription": {"text": doc},
            "helpUri": INFO_URI,
            "defaultConfiguration": {"level": "error"},
        })
    results: List[dict] = []
    for f in findings:
        # primary location first; `related` carries the extra ends of a
        # cross-file finding (G025: the C declaration the Python binding
        # drifted from) as further physicalLocations in the same list
        locations = [_location(f.path, f.line, f.snippet)]
        for r_path, r_line, r_snippet in f.related:
            locations.append(_location(r_path, r_line, r_snippet))
        results.append({
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": _LEVELS.get(f.severity, "error"),
            "message": {"text": f.message},
            "locations": locations,
            "partialFingerprints": {
                "graftcheckKey/v1": _fingerprint(f),
            },
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "graftcheck",
                    "version": TOOL_VERSION,
                    "informationUri": INFO_URI,
                    "rules": rules,
                },
            },
            "originalUriBaseIds": {
                "SRCROOT": {"description": {
                    "text": "repository root (paths are repo-relative, "
                            "forward slashes)"}},
            },
            "results": results,
        }],
    }
