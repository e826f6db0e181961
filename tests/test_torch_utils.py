"""The port's host-side copies (hashing, feature parsing, block packing,
options, eta schedules, convergence) and its state carriers, against the
JAX package's originals on the same inputs."""

import numpy as np
import pytest
import torch

from hivemall_tpu.core import batch as JB
from hivemall_tpu.ops import eta as JETA
from hivemall_tpu.ops.convergence import ConversionState as JConv
from hivemall_tpu.utils import feature as JF
from hivemall_tpu.utils import hashing as JH
from hivemall_tpu.utils.options import Options as JOptions
from hivemall_tpu_torch.core import batch as TB
from hivemall_tpu_torch.core.state import (init_linear_state,
                                           linear_state_from_numpy,
                                           linear_state_to_numpy, model_rows)
from hivemall_tpu_torch.ops import eta as TETA
from hivemall_tpu_torch.ops.convergence import ConversionState as TConv
from hivemall_tpu_torch.utils import feature as TF
from hivemall_tpu_torch.utils import hashing as TH
from hivemall_tpu_torch.utils.options import Options as TOptions

WORDS = ["", "a", "ab", "abc", "abcd", "hello world", "日本語", "x" * 37,
         "feature_123", "0"]


def test_murmur3_matches_jax():
    for w in WORDS:
        assert TH.murmurhash3_x86_32(w) == JH.murmurhash3_x86_32(w)
        assert TH.mhash(w, 1 << 20) == JH.mhash(w, 1 << 20)
    np.testing.assert_array_equal(TH.murmurhash3_bytes_batch(WORDS, 1 << 22),
                                  JH.murmurhash3_bytes_batch(WORDS, 1 << 22))


def test_parse_features_batch_matches_jax():
    rows = [["a:1.5", "b", "7:2"], [("c", 0.5), (3, 1.0)], ["日本:3"], []]
    ti, tv = TF.parse_features_batch(rows, 1 << 16)
    ji, jv = JF.parse_features_batch(rows, 1 << 16)
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width", [None, 4, 16])
def test_pack_rows_matches_jax(width):
    rng = np.random.RandomState(0)
    idx = [rng.randint(0, 100, size=m) for m in (3, 7, 1, 6)]
    val = [rng.randn(len(r)).astype(np.float32) for r in idx]
    y = [1.0, -1.0, 1.0, 1.0]
    for batch_size in (None, 6):
        got = TB.pack_rows(idx, val, y, 100, width=width, batch_size=batch_size)
        want = JB.pack_rows(idx, val, y, 100, width=width,
                            batch_size=batch_size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_iter_blocks_and_shuffle_match_jax():
    rng = np.random.RandomState(1)
    idx = [rng.randint(0, 50, size=5) for _ in range(23)]
    val = [rng.randn(5).astype(np.float32) for _ in range(23)]
    y = rng.randn(23).astype(np.float32)
    for g, w in zip(TB.iter_blocks(idx, val, y, 50, 8),
                    JB.iter_blocks(idx, val, y, 50, 8)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    ti, tv, ty = TB.shuffle_rows(idx, val, y, 7)
    ji, jv, jy = JB.shuffle_rows(idx, val, y, 7)
    np.testing.assert_array_equal(np.stack(ti), np.stack(ji))
    np.testing.assert_array_equal(ty, jy)


def test_pad_rows_to_multiple_matches_jax():
    idx = np.arange(15, dtype=np.int32).reshape(5, 3)
    val = np.ones((5, 3), np.float32)
    y = np.ones(5, np.float32)
    got = TB.pad_rows_to_multiple(torch.from_numpy(idx), torch.from_numpy(val),
                                  torch.from_numpy(y), 4, 99)
    want = JB.pad_rows_to_multiple(idx, val, y, 4, 99)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("opts", ["", "-eta 0.3", "-eta0 0.2 -t 50",
                                  "-eta0 0.2 -power_t 0.5", "-boldDriver"])
def test_eta_schedules_match_jax(opts):
    def parse(o):
        return (o.add("t", None, True, type=int)
                .add("power_t", None, True, default=0.1, type=float)
                .add("eta0", None, True, default=0.1, type=float)
                .add("eta", None, True, type=float)
                .add("boldDriver", None, False).parse(opts))

    t = np.arange(1, 200, dtype=np.float32)
    got = TETA.get_eta(parse(TOptions())).eta(torch.from_numpy(t)).numpy()
    want = np.asarray(JETA.get_eta(parse(JOptions())).eta(t))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_convergence_matches_jax():
    losses = [10.0, 8.0, 7.99, 7.98, 7.97, 9.0, 8.99, 8.985]
    t, j = TConv(True, 0.005), JConv(True, 0.005)
    for loss in losses:
        t.incr_loss(loss)
        j.incr_loss(loss)
        assert t.is_converged() == j.is_converged()


def test_state_numpy_round_trip_and_model_rows():
    rng = np.random.RandomState(2)
    d = {"weights": rng.randn(32).astype(np.float32),
         "covars": rng.rand(32).astype(np.float32),
         "slots": {"sum_sqgrad": rng.rand(32).astype(np.float32)},
         "touched": (rng.rand(32) < 0.5).astype(np.int8),
         "step": np.int32(77), "globals": {"n": np.float32(3.0)}}
    st = linear_state_from_numpy(d, device="cpu")
    back = linear_state_to_numpy(st)
    for k in ("weights", "covars", "touched"):
        np.testing.assert_array_equal(back[k], d[k])
    np.testing.assert_array_equal(back["slots"]["sum_sqgrad"],
                                  d["slots"]["sum_sqgrad"])
    assert back["step"] == 77 and float(back["globals"]["n"]) == 3.0
    feats, w, c = model_rows(st)
    np.testing.assert_array_equal(feats, np.nonzero(d["touched"])[0])
    np.testing.assert_array_equal(w, d["weights"][feats])
    # warm start seeds touched from the nonzero initial weights
    st0 = init_linear_state(4, initial_weights=np.array([0, 1, 0, 2.0]),
                            device="cpu")
    assert st0.touched.tolist() == [0, 1, 0, 1]
