"""Text UDFs (ref: hivemall/tools/text/*.java, utils/codec/Base91.java) — a
copy of `hivemall_tpu/tools/text.py`; the basE91 encoder is utils/codec's."""

from __future__ import annotations

import re
import unicodedata
from typing import List, Union

from ..utils.codec import _B91_ALPHABET
from ..utils.codec import base91 as _base91_bytes

_B91_DECODE = {c: i for i, c in enumerate(_B91_ALPHABET)}


def base91(data: Union[bytes, str]) -> str:
    """basE91 encode (ref: tools/text/Base91UDF.java, utils/codec/Base91.java);
    a str is encoded as UTF-8 first."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _base91_bytes(data)


def unbase91(text: str, as_text: bool = False) -> Union[bytes, str]:
    """basE91 decode (ref: tools/text/Unbase91UDF.java)."""
    v = -1
    b = 0
    n = 0
    out = bytearray()
    for c in text:
        if c not in _B91_DECODE:
            continue
        d = _B91_DECODE[c]
        if v < 0:
            v = d
        else:
            v += d * 91
            b |= v << n
            n += 13 if (v & 8191) > 88 else 14
            while n > 7:
                out.append(b & 255)
                b >>= 8
                n -= 8
            v = -1
    if v >= 0:
        out.append((b | v << n) & 255)
    return out.decode("utf-8") if as_text else bytes(out)


def ascii85(data: Union[bytes, str]) -> str:
    """Ascii85 encode (ref: utils/io/ASCII85OutputStream.java substrate)."""
    import base64

    if isinstance(data, str):
        data = data.encode("utf-8")
    return base64.a85encode(data).decode("ascii")


def unascii85(text: str, as_text: bool = False) -> Union[bytes, str]:
    import base64

    out = base64.a85decode(text.encode("ascii"))
    return out.decode("utf-8") if as_text else out


_STOPWORDS = frozenset(
    """a about above after again against all am an and any are aren't as at be
    because been before being below between both but by can't cannot could
    couldn't did didn't do does doesn't doing don't down during each few for
    from further had hadn't has hasn't have haven't having he he'd he'll he's
    her here here's hers herself him himself his how how's i i'd i'll i'm i've
    if in into is isn't it it's its itself let's me more most mustn't my myself
    no nor not of off on once only or other ought our ours ourselves out over
    own same shan't she she'd she'll she's should shouldn't so some such than
    that that's the their theirs them themselves then there there's these they
    they'd they'll they're they've this those through to too under until up
    very was wasn't we we'd we'll we're we've were weren't what what's when
    when's where where's which while who who's whom why why's with won't would
    wouldn't you you'd you'll you're you've your yours yourself yourselves""".split()
)


def is_stopword(word: str) -> bool:
    """English stopword test (ref: tools/text/StopwordUDF.java)."""
    return word.lower() in _STOPWORDS


def tokenize(text: str, to_lower: bool = False) -> List[str]:
    """Simple word tokenizer (ref: tools/text/TokenizeUDF.java)."""
    if to_lower:
        text = text.lower()
    return re.findall(r"\w+", text, re.UNICODE)


def split_words(text: str, regex: str = r"[\s]+") -> List[str]:
    """`split_words(query, regex)` (ref: tools/text/SplitWordsUDF.java)."""
    return [w for w in re.split(regex, text) if w]


def normalize_unicode(text: str, form: str = "NFKC") -> str:
    """`normalize_unicode(str[, form])` (ref: tools/text/NormalizeUnicodeUDF.java)."""
    return unicodedata.normalize(form, text)
