"""Text feature UDAFs (ref: ftvec/text/TermFrequencyUDAF.java:34)."""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable


def tf(words: Iterable[str]) -> Dict[str, float]:
    """`tf(word)` aggregate — relative term frequency over the group."""
    counts = Counter(words)
    total = sum(counts.values())
    if total == 0:
        return {}
    return {w: c / total for w, c in counts.items()}
