"""Binary codecs for model compression.

Mirrors the reference codec substrate (ref: utils/codec/{ZigZagLEB128Codec,
DeflateCodec}.java and utils/lang/HalfFloat.java:34-80), byte for byte the
sparse-model blobs of the JAX package's `utils/codec.py`: a blob written by either
package decodes in the other. `io/checkpoint.save_model_rows(compressed=
True)` writes model rows through `encode_sparse_model`.

Half-float is IEEE 754 binary16 (numpy float16). The LEB128 array paths run
through the native host library's zigzag-LEB128 codec over int64 values, as
in the JAX package; a value outside int64 takes the per-value Python path.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, List, Tuple

import numpy as np

# ---------------------------------------------------------------- half float


def float_to_half(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).astype(np.float16)


def half_to_float(h) -> np.ndarray:
    return np.asarray(h, dtype=np.float16).astype(np.float32)


def half_float_bits(x: float) -> int:
    """float -> uint16 bit pattern (HalfFloat.floatToHalfFloat analog)."""
    return int(np.float16(x).view(np.uint16))


def bits_to_half_float(bits: int) -> float:
    return float(np.uint16(bits).view(np.float16))


# ---------------------------------------------------------------- zigzag

def zigzag_encode(v: int) -> int:
    """Signed -> unsigned zigzag (ref: ZigZagLEB128Codec.java), in the
    closed form that holds for unbounded Python ints."""
    return (-v << 1) - 1 if v < 0 else v << 1


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


# ---------------------------------------------------------------- LEB128

def leb128_encode(value: int, out: bytearray) -> None:
    """Unsigned LEB128 append."""
    if value < 0:
        raise ValueError("leb128 encodes unsigned values; zigzag first")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def leb128_decode(buf: bytes, pos: int = 0) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def zigzag_leb128_encode_array(values: Iterable[int]) -> bytes:
    vals = values if isinstance(values, np.ndarray) else list(values)
    arr = None
    if not (isinstance(vals, np.ndarray)
            and not np.can_cast(vals.dtype, np.int64, "safe")):
        try:
            arr = np.asarray(vals, np.int64)
        except (OverflowError, ValueError):  # >64-bit: Python path only
            arr = None
    if arr is not None and arr.size:
        from .. import native

        return native.zigzag_leb128_encode(arr.ravel())
    out = bytearray()
    for v in vals:
        leb128_encode(zigzag_encode(int(v)), out)
    return bytes(out)


def zigzag_leb128_decode_array(buf: bytes, n: int) -> List[int]:
    if n:
        from .. import native

        try:
            return native.zigzag_leb128_decode(buf, n).tolist()
        except ValueError:  # >64-bit values: only the Python path has them
            pass
    out = []
    pos = 0
    for _ in range(n):
        v, pos = leb128_decode(buf, pos)
        out.append(zigzag_decode(v))
    return out


# ---------------------------------------------------------------- varbyte

def vbyte_encode(values: Iterable[int]) -> bytes:
    """Variable-byte codec for non-negative ints (ref: VariableByteCodec.java)."""
    out = bytearray()
    for v in values:
        leb128_encode(int(v), out)
    return bytes(out)


def vbyte_decode(buf: bytes, n: int) -> List[int]:
    out = []
    pos = 0
    for _ in range(n):
        v, pos = leb128_decode(buf, pos)
        out.append(v)
    return out


# ------------------------------------------------------- model blob helpers

def compress_model_blob(payload: bytes, level: int = 6) -> bytes:
    """deflate a serialized model blob (DeflateCodec analog)."""
    return zlib.compress(payload, level)


def decompress_model_blob(blob: bytes) -> bytes:
    return zlib.decompress(blob)


def encode_sparse_model(feats: np.ndarray, weights: np.ndarray,
                        half_float: bool = True) -> bytes:
    """Compress (feature, weight) model rows: delta+zigzag-LEB128 indices +
    fp16 weights + deflate — the FFMPredictionModel.writeExternal recipe
    (ref: FFMPredictionModel.java:149-200)."""
    feats = np.asarray(feats, np.int64)
    order = np.argsort(feats)
    feats = feats[order]
    weights = np.asarray(weights, np.float32)[order]
    deltas = np.diff(feats, prepend=0)
    idx_bytes = zigzag_leb128_encode_array(deltas)
    if half_float:
        w_bytes = float_to_half(weights).tobytes()
    else:
        w_bytes = weights.tobytes()
    header = struct.pack("<qB", len(feats), 1 if half_float else 0)
    return compress_model_blob(header + struct.pack("<q", len(idx_bytes))
                               + idx_bytes + w_bytes)


def decode_sparse_model(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    payload = decompress_model_blob(blob)
    n, hf = struct.unpack_from("<qB", payload, 0)
    off = 9
    (idx_len,) = struct.unpack_from("<q", payload, off)
    off += 8
    deltas = zigzag_leb128_decode_array(payload[off: off + idx_len], n)
    off += idx_len
    feats = np.cumsum(np.asarray(deltas, np.int64))
    if hf:
        weights = half_to_float(np.frombuffer(payload, np.float16, count=n,
                                              offset=off))
    else:
        weights = np.frombuffer(payload, np.float32, count=n, offset=off).copy()
    return feats, np.asarray(weights, np.float32)


# ------------------------------------------------------------------ basE91

# Joachim Henke's basE91 alphabet, the reference's utils/codec/Base91.java
_B91_ALPHABET = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
    "!#$%&()*+,./:;<=>?@[]^_`{|}~\""
)


def base91(data: bytes) -> str:
    """basE91 encode (ref: tools/text/Base91UDF.java) — the text form of an
    FFM model blob in its model rows."""
    b = 0
    n = 0
    out: List[str] = []
    for byte in data:
        b |= byte << n
        n += 8
        if n > 13:
            v = b & 8191
            if v > 88:
                b >>= 13
                n -= 13
            else:
                v = b & 16383
                b >>= 14
                n -= 14
            out.append(_B91_ALPHABET[v % 91])
            out.append(_B91_ALPHABET[v // 91])
    if n:
        out.append(_B91_ALPHABET[b % 91])
        if n > 7 or b > 90:
            out.append(_B91_ALPHABET[b // 91])
    return "".join(out)
