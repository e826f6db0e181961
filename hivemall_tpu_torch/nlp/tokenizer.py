"""`tokenize_ja` — Japanese tokenization.

Mirrors KuromojiUDF (ref: nlp/src/main/java/hivemall/nlp/tokenizer/KuromojiUDF.java:55-120):
`tokenize_ja(text [, mode [, stopwords [, stoptags]]])` with mode
NORMAL/SEARCH/EXTENDED, a stopword list, and POS stoptag filtering.

Backend resolution: an external morphological analyzer (fugashi/MeCab or
janome) is used when installed; otherwise the BUILT-IN lattice analyzer
(nlp/lattice.py — Viterbi over the bundled lexicon + unknown-word models,
the same algorithm Kuromoji runs over IPADic) is the default, so the
in-image behavior is always morphological, with POS tags for stoptag
filtering. The character-class segmenter (_charclass_tokenize) remains as a
library function for callers that want raw script-run splitting.

A copy of `hivemall_tpu/nlp/tokenizer.py`: the same backend order, so both
packages pick the same backend in one environment.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional, Sequence

from .lattice import _char_class

_BACKEND = None
_BACKEND_NAME = "charclass"


def _resolve_backend():
    global _BACKEND, _BACKEND_NAME
    if _BACKEND is not None:
        return _BACKEND
    try:
        import fugashi  # type: ignore

        _BACKEND = fugashi.Tagger()
        _BACKEND_NAME = "fugashi"
        return _BACKEND
    except ImportError:
        pass
    try:
        from janome.tokenizer import Tokenizer  # type: ignore

        _BACKEND = Tokenizer()
        _BACKEND_NAME = "janome"
        return _BACKEND
    except ImportError:
        pass
    from .lattice import LatticeTokenizer

    _BACKEND = LatticeTokenizer()
    _BACKEND_NAME = "lattice"
    return _BACKEND


def _charclass_tokenize(text: str) -> List[str]:
    tokens: List[str] = []
    cur = ""
    cur_cls = None
    for ch in text:
        # digits group with latin here (historical raw-run behavior:
        # "JAX2026" stays one token), unlike the lattice's own unknown-word
        # model which prices digit runs separately
        cls = _char_class(ch)
        if cls == "num":
            cls = "latin"
        if cls in ("space", "punct"):
            if cur:
                tokens.append(cur)
                cur, cur_cls = "", None
            continue
        if cls != cur_cls and cur:
            tokens.append(cur)
            cur = ""
        cur += ch
        cur_cls = cls
    if cur:
        tokens.append(cur)
    return tokens


def backend_name() -> str:
    _resolve_backend()
    return _BACKEND_NAME


def tokenize_ja_bulk(texts: Sequence[str], mode: str = "normal",
                     stopwords: Optional[Sequence[str]] = None,
                     stoptags: Optional[Sequence[str]] = None
                     ) -> List[List[str]]:
    """Corpus-shaped tokenize_ja: one call over many documents. With the
    built-in lattice backend and NORMAL mode, segmentation runs through the
    native bulk Viterbi (nlp/lattice.py::tokenize_bulk — parity-tested
    against the per-text path); SEARCH/EXTENDED and external backends fall
    back to per-text tokenize_ja. Feeds tf/feature_hashing pipelines
    (the KuromojiUDF-over-a-corpus usage)."""
    mode_l = (mode or "normal").lower()
    backend = _resolve_backend()
    if _BACKEND_NAME != "lattice" or mode_l != "normal":
        return [tokenize_ja(t, mode, stopwords, stoptags) for t in texts]
    normalized = [unicodedata.normalize("NFKC", t or "") for t in texts]
    stop_top = {t for t in (stoptags or ()) if "-" not in t}
    stop = set(stopwords or ())
    out: List[List[str]] = []
    for pairs in backend.tokenize_bulk(normalized):
        toks = [s for s, pos in pairs if pos not in stop_top]
        if stop:
            toks = [t for t in toks if t not in stop]
        out.append(toks)
    return out


def tokenize_ja(text: str, mode: str = "normal",
                stopwords: Optional[Sequence[str]] = None,
                stoptags: Optional[Sequence[str]] = None) -> List[str]:
    if text is None:
        return []
    mode = (mode or "normal").lower()
    if mode not in ("normal", "search", "extended"):
        raise ValueError(f"unsupported mode {mode!r} (normal/search/extended)")
    text = unicodedata.normalize("NFKC", text)
    backend = _resolve_backend()
    tokens: List[str] = []
    if _BACKEND_NAME == "lattice":
        # Kuromoji stoptags are hierarchical ("助詞-格助詞"); the built-in
        # lattice carries top-level POS only, so a top-level stoptag filters
        # that whole class, while a narrower hierarchical tag matches
        # nothing here (never over-filter an entire class because the user
        # asked to drop one subtype)
        stop_top = {t for t in (stoptags or ()) if "-" not in t}
        for surface, pos in backend.tokenize(text):
            if pos in stop_top:
                continue
            tokens.append(surface)
    elif _BACKEND_NAME == "fugashi":
        stop_pos = set(stoptags or [])
        for word in backend(text):
            pos = word.feature.pos1 if hasattr(word.feature, "pos1") else ""
            if stop_pos and pos in stop_pos:
                continue
            tokens.append(word.surface)
    elif _BACKEND_NAME == "janome":
        stop_pos = set(stoptags or [])
        for tok in backend.tokenize(text):
            pos = tok.part_of_speech.split(",")[0]
            if stop_pos and pos in stop_pos:
                continue
            tokens.append(tok.surface)
    if mode in ("search", "extended"):
        # SEARCH mode additionally decompounds long tokens (Kuromoji keeps
        # the compound AND emits its parts). The lattice backend re-segments
        # the compound with whole-token candidates suppressed (dictionary-
        # backed split); other backends fall back to kanji 2-grams.
        extra: List[str] = []
        decompounded = set()
        for t in tokens:
            # Kuromoji SEARCH penalizes long kanji (>=4 here) and long
            # other-script runs (>=7) so lexicalized splits win; katakana
            # compounds only decompound dictionary-backed (no 2-gram
            # fallback — kana 2-grams are noise)
            is_kanji = len(t) >= 4 and all(_char_class(c) == "kanji" for c in t)
            is_long_kata = len(t) >= 7 and all(_char_class(c) == "kata" for c in t)
            if is_kanji or is_long_kata:
                parts: List[str] = []
                if _BACKEND_NAME == "lattice":
                    parts = backend.decompound(t)
                if parts:
                    decompounded.add(t)
                elif mode == "search" and is_kanji:
                    # recall-oriented 2-gram fallback for OOV compounds;
                    # EXTENDED skips it — its own unigram stage below covers
                    # OOV (emitting both would duplicate every character)
                    parts = [t[i : i + 2] for i in range(len(t) - 1)]
                extra.extend(parts)
        tokens = tokens + extra
    if mode == "extended":
        # EXTENDED additionally replaces UNKNOWN words with their character
        # 1-grams (Kuromoji Mode.EXTENDED: unknown terms are n-grammed so
        # OOV text still matches at search time; known terms pass through).
        # "Unknown" = not a dictionary word for the lattice backend; other
        # backends have no cheap membership test, so only multi-char
        # katakana/latin loanword runs — the dominant OOV class — n-gram.
        def _is_unknown(t: str) -> bool:
            if _BACKEND_NAME == "lattice":
                return t not in backend.lexicon
            cls = {_char_class(c) for c in t}
            return len(t) >= 2 and (cls == {"kata"} or cls == {"latin"})

        expanded: List[str] = []
        for t in tokens:
            # a compound whose dictionary-backed split was already emitted
            # stays whole; unigramming it too would double-count every char
            if len(t) >= 2 and _is_unknown(t) and t not in decompounded:
                expanded.extend(t)
            else:
                expanded.append(t)
        tokens = expanded
    if stopwords:
        stop = set(stopwords)
        tokens = [t for t in tokens if t not in stop]
    return tokens
