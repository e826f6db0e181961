"""Compression UDFs (ref: hivemall/tools/compress/{DeflateUDF,InflateUDF}.java,
utils/codec/DeflateCodec.java)."""

from __future__ import annotations

import zlib
from typing import Union


def deflate(data: Union[str, bytes], level: int = -1) -> bytes:
    """zlib-deflate; strings are UTF-8 encoded first."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return zlib.compress(data, level)


def inflate(data: bytes, as_text: bool = True) -> Union[str, bytes]:
    out = zlib.decompress(data)
    return out.decode("utf-8") if as_text else out
