"""Segmentation accuracy scoring for tokenize_ja against a gold standard.

The standard word-segmentation metric: tokens become character spans
(cumulative offsets over the concatenated token text), and precision /
recall / F1 are micro-averaged over exact span matches — the same scheme
used to score Japanese/Chinese segmenters against corpora. The bundled
gold fixture (tests/data/tokenize_ja_gold.tsv: 100+ hand-verified everyday
sentences at IPADic granularity) gates the built-in lattice analyzer's
quality as a NUMBER rather than a structural claim (reference behavior
bar: KuromojiUDF NORMAL mode over IPADic,
nlp/src/main/java/hivemall/nlp/tokenizer/KuromojiUDF.java:55-86)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def token_spans(tokens: Sequence[str]) -> List[Tuple[int, int]]:
    """Tokens -> (start, end) character spans over their concatenation."""
    spans = []
    pos = 0
    for t in tokens:
        spans.append((pos, pos + len(t)))
        pos += len(t)
    return spans


def segmentation_prf(
        pairs: Sequence[Tuple[Sequence[str], Sequence[str]]]) -> Dict:
    """Micro-averaged span precision/recall/F1 over (gold, predicted)
    token-list pairs. Both sides must cover the same character stream
    (punctuation excluded on both, as the analyzer drops it); a coverage
    mismatch shows up as span misses, i.e. a lower score, never a crash."""
    tp = fp = fn = 0
    for gold, pred in pairs:
        g = set(token_spans(gold))
        p = set(token_spans(pred))
        tp += len(g & p)
        fp += len(p - g)
        fn += len(g - p)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "gold_tokens": tp + fn, "predicted_tokens": tp + fp}


def load_gold(path: str) -> List[Tuple[str, List[str]]]:
    """Read a `sentence<TAB>tok1 tok2 ...` fixture."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            sent, toks = line.split("\t")
            out.append((sent, toks.split(" ")))
    return out
