"""`feature_hashing` — hash feature names in "name[:value]" strings into the
2^24 space, keeping values (ref: ftvec/hashing/FeatureHashingUDF.java:45-190).
The bias feature "0" passes through unhashed (ref: :150-158 keeps int names)."""

from __future__ import annotations

from typing import List, Sequence

from ..utils.hashing import DEFAULT_NUM_FEATURES, murmurhash3_bytes_batch


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def feature_hashing(features: Sequence[str],
                    num_features: int = DEFAULT_NUM_FEATURES) -> List[str]:
    out: List[str] = []
    names, slots = [], []
    for k, fv in enumerate(features):
        pos = fv.find(":")
        name = fv if pos < 0 else fv[:pos]
        rest = "" if pos < 0 else fv[pos:]
        if _is_int(name):
            # int features index the space directly (kept as-is like the ref)
            out.append(fv)
        else:
            out.append(None)  # backfilled below
            names.append(name)
            slots.append((k, rest))
    if names:
        hashed = murmurhash3_bytes_batch(names, num_features)
        for (k, rest), h in zip(slots, hashed):
            out[k] = f"{h}{rest}"
    return out
