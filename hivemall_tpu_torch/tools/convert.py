"""Dataset-format converters — the `resources/misc/*.awk` +
`resources/examples/kddtrack2/kddconv.awk` counterparts, as composable
generators plus a CLI (`python -m hivemall_tpu_torch.tools.convert <name>`),
reading/writing the same TSV row shapes the reference's Hive LOAD expects.

- `libsvm_rows` (ref: resources/misc/conv.awk): "label idx:val idx:val" ->
  (rowid, label, [features]); rowids are 1-based line numbers.
- `kdd_expand` (ref: resources/examples/kddtrack2/kddconv.awk): KDD2012
  Track 2's (rowid, #clicks, #impressions-#clicks, features...) rows
  expand to one labeled row PER impression (1.0 x clicks, 0.0 x
  non-clicks) — how the reference turns aggregated ad logs into per-row
  online-learning input.
- `one_vs_rest` (ref: resources/misc/one-vs-rest.awk): multiclass rows
  (possible_labels, rowid, label, features) expand to one binary row per
  candidate label (+1 for the true label, -1 otherwise) — the manual
  one-vs-rest trick for binary-only learners.
"""

from __future__ import annotations

import re
import sys
from typing import Iterable, Iterator, List, Sequence, Tuple


def libsvm_rows(lines: Iterable[str]) -> Iterator[Tuple[int, str, List[str]]]:
    """svmlight/libsvm lines -> (rowid, label, features). rowid is the
    1-based input line number (conv.awk prints NR)."""
    for nr, line in enumerate(lines, start=1):
        parts = line.split()
        if not parts:
            continue
        yield nr, parts[0], parts[1:]


_NUM_PREFIX = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)")


def _int0(s: str) -> int:
    """awk-style numeric coercion: the leading numeric prefix, truncated
    (int("2.0")=2, int("3abc")=3), non-numeric (e.g. a header cell) -> 0 —
    so a stray header row expands to nothing instead of aborting the run."""
    m = _NUM_PREFIX.match(s.strip())
    return int(float(m.group(0))) if m else 0


def kdd_expand(lines: Iterable[str]) -> Iterator[Tuple[str, float, List[str]]]:
    """Tab-separated (rowid, clicks, non_clicks, feat, feat, ...) ->
    one (rowid, label, features) row per impression."""
    for line in lines:
        parts = line.rstrip("\r\n").split("\t")
        if len(parts) < 4:
            continue
        rowid, clicks, non_clicks = parts[0], _int0(parts[1]), _int0(parts[2])
        features = parts[3:]
        for _ in range(clicks):
            yield rowid, 1.0, features
        for _ in range(non_clicks):
            yield rowid, 0.0, features


def one_vs_rest(rows: Iterable[Tuple[Sequence, object, object, object]]
                ) -> Iterator[Tuple[object, object, int, object]]:
    """(possible_labels, rowid, label, features) -> one
    (rowid, candidate_label, +/-1, features) row per candidate."""
    for possible_labels, rowid, label, features in rows:
        for cand in possible_labels:
            yield rowid, cand, (1 if cand == label else -1), features


def _main(argv: List[str]) -> int:
    usage = ("usage: python -m hivemall_tpu_torch.tools.convert "
             "(libsvm|kdd_expand|one_vs_rest) < input > output.tsv")
    if len(argv) != 1:
        print(usage, file=sys.stderr)
        return 1
    name = argv[0]
    out = sys.stdout
    if name == "libsvm":
        for rowid, label, feats in libsvm_rows(sys.stdin):
            out.write(f"{rowid}\t{label}\t{','.join(feats)}\n")
    elif name == "kdd_expand":
        for rowid, label, feats in kdd_expand(sys.stdin):
            out.write(f"{rowid}\t{label}\t{','.join(feats)}\n")
    elif name == "one_vs_rest":
        # input TSV: possible_labels(comma-joined) \t rowid \t label \t
        # features... (additional tab-separated feature columns are comma-
        # joined into ONE field, like the libsvm/kdd outputs, so the output
        # stays a strict 4-column TSV)
        def rows():
            for line in sys.stdin:
                p = line.rstrip("\r\n").split("\t")
                if len(p) >= 4:
                    yield p[0].split(","), p[1], p[2], ",".join(p[3:])

        for rowid, cand, y, feats in one_vs_rest(rows()):
            out.write(f"{rowid}\t{cand}\t{y}\t{feats}\n")
    else:
        print(usage, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
