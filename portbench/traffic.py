"""The one row generator: a configuration's row law and a seed make a fit's
rows, as the hashed ``(indices, values)`` arrays a Hive mapper hands the
trainer, with their labels.

A row law (a configuration file's ``row_law``) has four parts:

- ``length``: ``{"law": "fixed", "value": K}``, or ``{"law": "poisson",
  "mean": m, "min": lo, "max": hi, "seed": s}``: Poisson lengths clipped to
  [lo, hi]. The multiset of lengths comes from the fixed ``seed`` alone and
  the run's seed only deals it out in another order, so every seed trains
  the same number of lanes.
- ``ids``: ``{"law": "log_uniform", "placement_seed": s}``: the repo's CTR
  id law (`hivemall_tpu_torch/runtime/benchmark.py::make_workload_ids`,
  copied here): log-uniform frequency over [1, dims), spread over the table
  by a fixed permutation so that hot ids land where murmur hashing would
  put them, not in the first cache lines.
- ``value``: every lane's feature value (categorical features: 1.0).
- ``label``: ``{"law": "planted_logistic", "sigma": s, "bias": b}``: a
  hidden weight per feature, N(0, s^2) from the run's seed; a row's label
  is 1 with probability sigmoid(b + sum of its features' hidden weights *
  values), else 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def generator(seed: int) -> np.random.Generator:
    """A numpy Generator for any whole number (negative and past 64 bits
    included)."""
    return np.random.default_rng(np.random.SeedSequence(seed % (1 << 128)))


@dataclass
class Rows:
    """A fit's rows in both forms: the trainer's per-row arrays, and the
    padded [n, width] block (pad lanes: id ``dims``, value 0) that the
    reference and the count functions read."""

    ids: List[np.ndarray]  # int64 per row
    values: List[np.ndarray]  # float32 per row
    labels: np.ndarray  # float32 0/1 [n]
    padded_ids: np.ndarray  # int64 [n, width]
    padded_values: np.ndarray  # float32 [n, width]
    dims: int

    def __len__(self) -> int:
        return len(self.ids)

    def head(self, n: int) -> "Rows":
        return Rows(self.ids[:n], self.values[:n], self.labels[:n],
                    self.padded_ids[:n], self.padded_values[:n], self.dims)


def lengths(law: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if law["law"] == "fixed":
        return np.full(n, int(law["value"]), np.int64)
    if law["law"] == "poisson":
        fixed = generator(int(law["seed"]))
        lens = np.clip(fixed.poisson(float(law["mean"]), n), int(law["min"]),
                       int(law["max"]))
        return rng.permutation(lens).astype(np.int64)
    raise ValueError(f"unknown length law {law['law']!r}")


def log_uniform_ids(law: dict, n: int, dims: int,
                    rng: np.random.Generator) -> np.ndarray:
    perm = generator(int(law["placement_seed"])).permutation(dims)
    u = rng.random(n)
    return perm[np.exp(u * np.log(float(dims))).astype(np.int64) % dims]


def make_rows(config: dict, seed: int) -> Rows:
    """The ``rows`` rows of one fit of `config` from `seed`."""
    law = config["row_law"]
    dims = int(config["dims"])
    n = int(config["rows"])
    rng = generator(seed)
    lens = lengths(law["length"], n, rng)
    width = int(lens.max())
    if law["ids"]["law"] != "log_uniform":
        raise ValueError(f"unknown id law {law['ids']['law']!r}")
    flat_ids = log_uniform_ids(law["ids"], int(lens.sum()), dims, rng)
    live = np.arange(width)[None, :] < lens[:, None]
    padded_ids = np.full((n, width), dims, np.int64)
    padded_ids[live] = flat_ids
    padded_values = np.where(live, np.float32(law["value"]),
                             np.float32(0.0)).astype(np.float32)
    label = law["label"]
    if label["law"] != "planted_logistic":
        raise ValueError(f"unknown label law {label['law']!r}")
    hidden = np.append(rng.standard_normal(dims, dtype=np.float32)
                       * np.float32(label["sigma"]), np.float32(0.0))
    logit = float(label["bias"]) + (hidden[padded_ids]
                                     * padded_values).sum(axis=1,
                                                          dtype=np.float64)
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    if (lens == width).all():
        ids, values = list(padded_ids), list(padded_values)
    else:
        cuts = np.cumsum(lens)[:-1]
        ids = np.split(flat_ids, cuts)
        values = np.split(padded_values[live], cuts)
    return Rows(ids, values, labels, padded_ids, padded_values, dims)
