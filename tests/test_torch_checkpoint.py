"""The port's model interchange (hivemall_tpu_torch/io/checkpoint.py,
utils/codec.py, adapters/model_rows.py, -loadmodel) against the JAX
package's, on the CPU: the same numpy inputs through both, and every file
one package writes read by the other.

Bit patterns, quantized tables and codec bytes must be EXACTLY equal; float
state after a warm start within rtol 1e-5 / atol 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivemall_tpu.io import checkpoint as JK
from hivemall_tpu.models import classifier as JC
from hivemall_tpu.utils import codec as JCODEC
from hivemall_tpu_torch.adapters.model_rows import iter_model_rows
from hivemall_tpu_torch.io import checkpoint as TK
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.utils import codec as TCODEC

from torch_cases import ATOL, RTOL, bf16_values, carried_models


def tricky_f32(seed, n=4096):
    """Random f32 plus the rounding cases: exact ties to even (both
    parities), values one ulp off a tie, subnormals (of f32 and of bf16),
    signed zeros, infinities and the largest finite values."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.exp(rng.uniform(-40, 40, n))).astype(np.float32)
    bits = rng.randint(0, 1 << 16, size=256).astype(np.uint32) << 16
    ties = (bits | 0x8000).view(np.float32)  # halfway: ties to even
    near = np.concatenate([(bits | 0x7FFF).view(np.float32),
                           (bits | 0x8001).view(np.float32)])
    sub = np.array([1e-40, -1e-40, 1e-45, 1.1754942e-38, 9.2e-41, -3e-39],
                   np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 3.4028235e38,
                        -3.4028235e38, 3.3895314e38], np.float32)
    out = np.concatenate([x, ties, near, sub, special])
    return out[np.isfinite(out) | np.isinf(out)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_pack_raw_bits_equal_jax(seed):
    x = tricky_f32(seed)
    got = TK.bf16_pack_raw(x)
    want = JK.bf16_pack_raw(x)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    # a bf16 tensor packs to its own bits, and a JAX host bf16 array too
    np.testing.assert_array_equal(
        TK.bf16_pack_raw(torch.from_numpy(x).to(torch.bfloat16)), want)
    np.testing.assert_array_equal(
        TK.bf16_pack_raw(np.asarray(jnp.asarray(x, jnp.bfloat16))), want)


def test_bf16_unpack_raw_is_a_bit_view():
    bits = JK.bf16_pack_raw(tricky_f32(5))
    t = TK.bf16_unpack_raw(bits)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  bits)
    np.testing.assert_array_equal(
        t.float().numpy(), np.asarray(JK.bf16_unpack_raw(bits), np.float32))


@pytest.mark.parametrize("block_rows", [16, 64, 128])
@pytest.mark.parametrize("rows", [256, 1000, 4096])
def test_quantize_int8_equals_jax(rows, block_rows):
    rng = np.random.RandomState(rows + block_rows)
    x = (rng.randn(rows) * 0.3).astype(np.float32)
    x[:block_rows] = 0.0  # an all-zero block: scale 1.0, q 0
    q, s = TK.quantize_int8(x, block_rows)
    qj, sj = JK.quantize_int8(x, block_rows)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_array_equal(TK.dequantize_int8(q, s, block_rows),
                                  JK.dequantize_int8(qj, sj, block_rows))


def test_quantize_int8_axis_and_tensor_input():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 300).astype(np.float32)
    for axis in (0, 1):
        q, s = TK.quantize_int8(torch.from_numpy(x), 32, axis=axis)
        qj, sj = JK.quantize_int8(x, 32, axis=axis)
        np.testing.assert_array_equal(q, qj)
        np.testing.assert_array_equal(s, sj)


def test_quantize_int8_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        TK.quantize_int8(np.ones(8, np.float32), 48)


def test_codec_bytes_equal_jax():
    rng = np.random.RandomState(4)
    feats = np.unique(rng.randint(0, 1 << 40, size=3000)).astype(np.int64)
    w = rng.randn(feats.size).astype(np.float32)
    for hf in (True, False):
        blob = TCODEC.encode_sparse_model(feats, w, half_float=hf)
        assert blob == JCODEC.encode_sparse_model(feats, w, half_float=hf)
        f2, w2 = JCODEC.decode_sparse_model(blob)
        f3, w3 = TCODEC.decode_sparse_model(blob)
        np.testing.assert_array_equal(f2, f3)
        np.testing.assert_array_equal(w2, w3)
    vals = np.concatenate([rng.randint(-(1 << 62), 1 << 62, size=500),
                           [0, 1, -1, 63, 64, -64, -65, 2 ** 63 - 1,
                            -2 ** 63]]).astype(np.int64)
    enc = TCODEC.zigzag_leb128_encode_array(vals)
    assert enc == JCODEC.zigzag_leb128_encode_array(vals)
    assert TCODEC.zigzag_leb128_decode_array(enc, vals.size) == vals.tolist()
    # beyond 64 bits the per-value path takes over in both directions
    big = [2 ** 70, -(2 ** 66), 5]
    enc = TCODEC.zigzag_leb128_encode_array(big)
    assert enc == JCODEC.zigzag_leb128_encode_array(big)
    assert TCODEC.zigzag_leb128_decode_array(enc, 3) == big


FEATS = np.array([3, 17, 42, 100, 511], np.int64)
WEIGHTS = np.array([0.5, -1.25, 2.0, 0.0078125, -3.5], np.float32)
COVARS = np.array([1.0, 0.5, 0.25, 2.0, 0.75], np.float32)


def _write_tsv(path, covars=True):
    with open(path, "w") as f:
        f.write("# hive model table export\n\n")
        for i, (a, w) in enumerate(zip(FEATS, WEIGHTS)):
            f.write(f"{a}\t{w}" + (f"\t{COVARS[i]}" if covars else "") + "\n")


@pytest.mark.parametrize("form,writer", [
    ("npz", "port"), ("npz", "jax"), ("npz_nocov", "port"),
    ("npz_nocov", "jax"), ("codec", "port"), ("codec", "jax"),
    ("tsv", "hand"), ("csv", "hand")])
def test_model_rows_cross_read(tmp_path, form, writer):
    """A model-rows file written by one package reads identically in the
    other (text tables are written by hand: neither package writes them)."""
    ext = {"npz": ".npz", "npz_nocov": ".npz", "tsv": ".tsv", "csv": ".csv",
           "codec": ".bin"}[form]
    path = str(tmp_path / f"model{ext}")
    covars = None if form in ("npz_nocov", "codec") else COVARS
    if form in ("tsv", "csv"):
        if form == "csv":
            with open(path, "w") as f:
                for a, w, c in zip(FEATS, WEIGHTS, COVARS):
                    f.write(f"{a},{w},{c}\n")
        else:
            _write_tsv(path)
    else:
        save = TK.save_model_rows if writer == "port" else JK.save_model_rows
        save(path, FEATS, WEIGHTS, covars, compressed=form == "codec")
    got = TK.load_model_rows(path)
    want = JK.load_model_rows(path)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if form != "codec":  # the codec stores fp16 weights: a rounding
        np.testing.assert_array_equal(got[1], WEIGHTS)
    for dims in (64, 512):
        for g, w in zip(TK.dense_from_rows(dims, *got),
                        JK.dense_from_rows(dims, *want)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rule", ["arow", "pa1", "adagrad_rda", "arow_regr"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_linear_state_cross_load(tmp_path, rule, bf16):
    """save_linear_state in one package, load_linear_state in the other:
    every field equal, a bf16 table staying bf16."""
    jm, tm = carried_models(rule, dims=512, seed=7, bf16=bf16)
    p_port, p_jax = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    TK.save_linear_state(p_port, tm.state)
    JK.save_linear_state(p_jax, jm.state)
    with np.load(p_port) as a, np.load(p_jax) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want_dt = torch.bfloat16 if bf16 else torch.float32
    for path in (p_port, p_jax):
        st = TK.load_linear_state(path, device="cpu")
        assert st.weights.dtype == want_dt
        js = JK.load_linear_state(path)
        assert js.weights.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
        np.testing.assert_array_equal(
            st.weights.float().numpy(), np.asarray(js.weights, np.float32))
        if js.covars is not None:
            assert st.covars.dtype == want_dt
            np.testing.assert_array_equal(
                st.covars.float().numpy(), np.asarray(js.covars, np.float32))
        for k, v in js.slots.items():
            np.testing.assert_array_equal(st.slots[k].numpy(), np.asarray(v))
        for k, v in js.globals.items():
            np.testing.assert_array_equal(st.globals[k].numpy(),
                                          np.asarray(v))
        np.testing.assert_array_equal(st.touched.numpy(),
                                      np.asarray(js.touched))
        assert st.step == int(js.step)


def test_load_linear_state_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    _, tm = carried_models("pa1", dims=64)
    path = str(tmp_path / "s.npz")
    TK.save_linear_state(path, tm.state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TK.load_linear_state(path)


def test_dtype_names_are_the_jax_strings():
    assert TK.dtype_name(torch.float32) == "float32"
    assert TK.dtype_name(torch.bfloat16) == "bfloat16"
    assert TK.dtype_name(torch.int8) == "int8"
    assert TK.dtype_from_name("bfloat16") is torch.bfloat16
    assert TK.dtype_from_name("float32") is torch.float32
    assert TK.dtype_from_name(None) is None
    assert TK.np_saveable(torch.ones(3, dtype=torch.bfloat16)).dtype \
        == np.float32


@pytest.mark.parametrize("rule", ["arow", "pa1"])
def test_iter_model_rows_matches_jax(rule):
    jm, tm = carried_models(rule, dims=256, seed=11)
    from hivemall_tpu.adapters.model_rows import iter_model_rows as jax_iter

    tc, trows = iter_model_rows(tm)
    jc, jrows = jax_iter(jm)
    assert tc == jc
    assert list(trows) == list(jrows)


def test_iter_model_rows_refuses_other_families():
    from hivemall_tpu_torch.models.trees import forest as TF

    # the port's own forest emits the JAX package's forest rows
    X = np.random.RandomState(0).rand(60, 3)
    forest = TF.train_randomforest_classifier(
        X, (X[:, 0] > 0.5).astype(int), "-trees 2 -seed 1", device="cpu")
    cols, rows = iter_model_rows(forest)
    assert cols == ["model_id", "model_type", "pred_model",
                    "var_importance", "oob_errors", "oob_tests"]
    assert [r[0] for r in rows] == [0, 1]

    class Forest:  # the JAX package's TrainedForest fields, not the class
        trees = []
        classification = True

    with pytest.raises(ValueError, match="no row emission"):
        iter_model_rows(Forest())


def _train_rows(n=300, d=128, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 9, size=n)
    idx = [rng.randint(0, d, size=m).astype(np.int64) for m in lens]
    val = [rng.randn(m).astype(np.float32) for m in lens]
    w = rng.randn(d)
    y = np.sign([v @ w[i] for i, v in zip(idx, val)])
    return (idx, val), y


@pytest.mark.parametrize("form", ["tsv", "npz", "codec"])
@pytest.mark.parametrize("trainer", ["arow", "pa1"])
def test_loadmodel_warm_start_matches_jax(tmp_path, form, trainer):
    """-loadmodel in the port warm-starts as in the JAX package
    (hivemall_tpu/models/base.py:295-299): the same file, the same rows,
    the same trained state."""
    ext = {"tsv": ".tsv", "npz": ".npz", "codec": ".bin"}[form]
    path = str(tmp_path / f"warm{ext}")
    rng = np.random.RandomState(9)
    feats = np.unique(rng.randint(0, 300, size=60)).astype(np.int64)
    w = bf16_values(rng.randn(feats.size) * 0.2)
    c = rng.uniform(0.3, 1.0, feats.size).astype(np.float32)
    if form == "tsv":
        with open(path, "w") as f:
            for a, wi, ci in zip(feats, w, c):
                f.write(f"{a}\t{float(wi)!r}\t{float(ci)!r}\n")
    else:
        JK.save_model_rows(path, feats, w, c, compressed=form == "codec")
    rows, y = _train_rows()
    opts = f"-dims 128 -loadmodel {path}"
    mt = getattr(TC, f"train_{trainer}")(rows, y, opts, device="cpu")
    mj = getattr(JC, f"train_{trainer}")(rows, y, opts)
    np.testing.assert_allclose(mt.state.weights.numpy(),
                               np.asarray(mj.state.weights), rtol=RTOL,
                               atol=ATOL)
    if mj.state.covars is not None:
        np.testing.assert_allclose(mt.state.covars.numpy(),
                                   np.asarray(mj.state.covars), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(mt.state.touched.numpy(),
                                  np.asarray(mj.state.touched))
    # the warm start really happened: features past the trained rows'
    # range carry the file's weights (ids mod dims)
    cold = getattr(TC, f"train_{trainer}")(rows, y, "-dims 128",
                                           device="cpu")
    assert not np.allclose(cold.state.weights.numpy(),
                           mt.state.weights.numpy())


def test_loadmodel_file_is_read_not_refused(tmp_path):
    rows, y = _train_rows(n=20)
    with pytest.raises(FileNotFoundError):
        TC.train_arow(rows, y,
                      f"-dims 64 -loadmodel {os.path.join(tmp_path, 'no.tsv')}",
                      device="cpu")
