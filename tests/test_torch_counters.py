"""The port's two repairs against the reference, on the CPU:

- progress counters: one `train_*` moves the port's registry
  (hivemall_tpu_torch/runtime/metrics.py) by the same
  `hivemall.<rule>.examples` and `hivemall.<rule>.iterations` as the JAX
  package's, in every execution mode the port runs;
- `-mxu_scatter` is accepted exactly where the JAX package ignores it (exact
  scan mode, `-pallas` included, and `train_fm`'s scan) and trains to the
  same state as without it; where the JAX package would run its mxu backend
  (`-mini_batch` > 1) the port still refuses it by name.
"""

import numpy as np
import pytest
import torch

from hivemall_tpu.models import classifier as JC
from hivemall_tpu.runtime.metrics import REGISTRY as JREG
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import fm as TFM
from hivemall_tpu_torch.runtime.metrics import REGISTRY as TREG


def rows(n=150, d=64, k=6, seed=0):
    rng = np.random.RandomState(seed)
    idx = [rng.randint(0, d, size=k).astype(np.int64) for _ in range(n)]
    val = [rng.randn(k).astype(np.float32) for _ in range(n)]
    w = rng.randn(d)
    y = np.sign([v @ w[i] for i, v in zip(idx, val)])
    return (idx, val), y


def counts(registry, rule):
    return tuple(registry.counter("hivemall", f"{rule}.{c}").value
                 for c in ("examples", "iterations"))


@pytest.mark.parametrize("opts", [
    "-dims 64", "-dims 64 -pallas", "-dims 64 -mini_batch 16",
    "-dims 64 -batch 16", "-dims 64 -batch 16 -block_size 48",
    "-dims 64 -iters 3 -disable_cv", "-dims 64 -batch 8 -iters 4 -shuffle"])
def test_progress_counters_move_like_the_reference(opts):
    feats, y = rows()
    before_t, before_j = counts(TREG, "arow"), counts(JREG, "arow")
    TC.train_arow(feats, y, opts, device="cpu")
    JC.train_arow(feats, y, opts)
    moved_t = tuple(a - b for a, b in zip(counts(TREG, "arow"), before_t))
    moved_j = tuple(a - b for a, b in zip(counts(JREG, "arow"), before_j))
    assert moved_t == moved_j
    assert moved_t[0] == len(y) * moved_t[1] and moved_t[1] >= 1


@pytest.mark.parametrize("opts", ["-dims 64", "-dims 64 -pallas"])
def test_mxu_scatter_is_ignored_in_scan_mode(opts):
    feats, y = rows()
    a = TC.train_arow(feats, y, f"{opts} -mxu_scatter", device="cpu")
    b = TC.train_arow(feats, y, opts, device="cpu")
    j = JC.train_arow(feats, y, f"{opts} -mxu_scatter")
    for k in ("weights", "covars", "touched"):
        torch.testing.assert_close(getattr(a.state, k), getattr(b.state, k),
                                   rtol=0, atol=0)
    np.testing.assert_allclose(a.state.weights.numpy(),
                               np.asarray(j.state.weights), rtol=1e-5,
                               atol=1e-6)


def test_train_fm_mxu_scatter_is_ignored_in_scan_mode():
    feats, y = rows(n=60)
    opts = "-c -dims 64 -factor 3"
    a = TFM.train_fm(feats, y, f"{opts} -mxu_scatter", device="cpu")
    b = TFM.train_fm(feats, y, opts, device="cpu")
    for k in ("w0", "w", "v", "touched"):
        torch.testing.assert_close(getattr(a.state, k), getattr(b.state, k),
                                   rtol=0, atol=0)


def test_mxu_scatter_with_mini_batch_is_still_refused():
    feats, y = rows(n=20)
    with pytest.raises(ValueError, match="later slice"):
        TC.train_arow(feats, y, "-dims 64 -mini_batch 4096 -mxu_scatter",
                      device="cpu")
    with pytest.raises(ValueError, match="later slice"):
        TFM.train_fm(feats, y, "-c -dims 64 -mini_batch 4096 -mxu_scatter",
                     device="cpu")
