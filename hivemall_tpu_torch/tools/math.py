"""Math UDFs (ref: hivemall/tools/math/SigmoidGenericUDF.java:40) — a
numpy copy of `hivemall_tpu/tools/math.py` (the port imports nothing of
the JAX package)."""

from __future__ import annotations

from typing import Union

import numpy as np


def sigmoid(x: Union[float, np.ndarray]):
    """1 / (1 + e^-x) — the linear-model inference squash used by the SQL
    prediction path (ref: SURVEY.md §3.5)."""
    x = np.asarray(x, dtype=np.float64)
    out = 1.0 / (1.0 + np.exp(-x))
    return float(out) if out.ndim == 0 else out
