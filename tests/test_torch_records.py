"""Record shards in the port (hivemall_tpu_torch/io/records.py and the
native HMTR1 codec) against the JAX package's (hivemall_tpu/io/records.py),
on the CPU: shards interchange byte for byte in both directions, the
native codec equals the plain Python one, RecordDataset yields JAX's
blocks in JAX's order for the same seed (shuffled or not), the CPU
prefetch equals no prefetch, and training from records equals JAX's
tests/test_records.py::test_train_from_records path at rtol 1e-5 /
atol 1e-6 (the engine's parity tolerance). The model is
tests/test_records.py."""

import numpy as np
import pytest
import torch

from hivemall_tpu.io import records as JR
from hivemall_tpu_torch import native
from hivemall_tpu_torch.io import records as TR

RTOL, ATOL = 1e-5, 1e-6


def _rows(n=100, d=64, seed=0, max_nnz=9, repeats=False):
    """Rows of 1..max_nnz-1 ids in [0, d) (unsorted; with `repeats`, ids
    repeat inside a row, so the stable sort's tie order shows)."""
    rng = np.random.RandomState(seed)
    idx = [rng.choice(d, size=rng.randint(1, max_nnz),
                      replace=repeats).astype(np.int64) for _ in range(n)]
    val = [rng.rand(len(r)).astype(np.float32) for r in idx]
    lab = rng.randn(n).astype(np.float32)
    return idx, val, lab


def _same_rows(a, b):
    ia, va, la = a
    ib, vb, lb = b
    assert len(ia) == len(ib)
    for x, y in zip(ia, ib):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(va, vb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert la.tobytes() == lb.tobytes()


@pytest.mark.parametrize("shards,repeats", [(1, False), (4, False),
                                            (3, True)])
def test_shards_interchange_byte_for_byte(tmp_path, shards, repeats):
    idx, val, lab = _rows(n=101, d=1 << 20, repeats=repeats)
    tp = TR.write_records(str(tmp_path / "t"), idx, val, lab,
                          num_shards=shards)
    jp = JR.write_records(str(tmp_path / "j"), idx, val, lab,
                          num_shards=shards)
    assert [p.rsplit("/", 1)[1][1:] for p in tp] == \
        [p.rsplit("/", 1)[1][1:] for p in jp]
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
        _same_rows(TR.read_shard(b), JR.read_shard(b))  # JAX's, read here
        _same_rows(JR.read_shard(a), TR.read_shard(a))  # ours, read there


def test_roundtrip_sorts_rows_by_id(tmp_path):
    idx, val, lab = _rows(repeats=True)
    (path,) = TR.write_records(str(tmp_path / "d"), idx, val, lab)
    idx2, val2, lab2 = TR.read_shard(path)
    for a, v, b, w in zip(idx, val, idx2, val2):
        order = np.argsort(a, kind="stable")
        np.testing.assert_array_equal(a[order], b)
        np.testing.assert_array_equal(v[order], w)
    np.testing.assert_array_equal(lab, lab2)


def test_native_codec_equals_the_plain_one(tmp_path):
    idx, val, lab = _rows(n=300, d=1 << 30, max_nnz=200, repeats=True)
    idx[0], val[0] = np.zeros(0, np.int64), np.zeros(0, np.float32)
    before = dict(native.CALLS)
    body = native.encode_records(idx, val, lab)
    assert body == TR.encode_rows_python(idx, val, lab)
    offsets, indices, values, labels = native.decode_records(body, len(idx))
    py_idx, py_val, py_lab = TR.decode_body_python(body, len(idx))
    assert offsets[-1] == indices.size == values.size
    _same_rows(([indices[a:b] for a, b in zip(offsets, offsets[1:])],
                [values[a:b] for a, b in zip(offsets, offsets[1:])], labels),
               (py_idx, py_val, py_lab))
    assert native.CALLS["encode_records"] == before["encode_records"] + 1
    assert native.CALLS["decode_records"] == before["decode_records"] + 1


def test_codec_refusals_match_jax(tmp_path):
    from hivemall_tpu import native as jnative

    wide = [np.arange(256, dtype=np.int64)]
    for mod in (native, jnative):
        with pytest.raises(ValueError, match="nnz > 255"):
            mod.encode_records(wide, [np.ones(256, np.float32)],
                               np.ones(1, np.float32))
        with pytest.raises(ValueError, match="negative feature id"):
            mod.encode_records([np.array([3, -1])], [np.ones(2, np.float32)],
                               np.ones(1, np.float32))
        with pytest.raises(ValueError, match="length mismatch"):
            mod.encode_records([np.array([3])], [], np.ones(1, np.float32))
    body = native.encode_records(*_rows(n=5)[:2], np.zeros(5, np.float32))
    for cut in (body[:-1], body[:3], b""):
        with pytest.raises(ValueError, match="corrupt record shard"):
            native.decode_records(cut, 5)
        with pytest.raises(ValueError, match="corrupt record shard"):
            jnative.decode_records(cut, 5)
    path = tmp_path / "bad.hmtr"
    path.write_bytes(b"HMTR0" + bytes(8))
    for mod in (TR, JR):
        with pytest.raises(ValueError, match="bad magic"):
            mod.read_shard(str(path))


def _epochs(ds, n):
    return [[tuple(np.asarray(a) for a in blk) for blk in ds.blocks()]
            for _ in range(n)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("width", [None, 16])
def test_dataset_blocks_equal_jax(tmp_path, shuffle, width):
    idx, val, lab = _rows(n=203, d=64, seed=3)
    paths = TR.write_records(str(tmp_path / "d"), idx, val, lab,
                             num_shards=3)
    kw = dict(dims=64, batch_size=16, width=width, shuffle=shuffle, seed=7)
    got = _epochs(TR.RecordDataset(paths, device_prefetch=False,
                                   device="cpu", **kw), 3)
    want = _epochs(JR.RecordDataset(paths, device_prefetch=False, **kw), 3)
    assert [len(e) for e in got] == [len(e) for e in want]
    for eg, ew in zip(got, want):
        for bg, bw in zip(eg, ew):
            for a, b in zip(bg, bw):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
    if shuffle:  # epochs differ, and every epoch holds every row once
        labs = [np.concatenate([b[2] for b in e]) for e in got]
        assert not np.array_equal(labs[0], labs[1])
        for x in labs[1:]:
            np.testing.assert_array_equal(np.sort(x), np.sort(labs[0]))


def test_cpu_prefetch_equals_no_prefetch(tmp_path):
    idx, val, lab = _rows(n=150, d=64, seed=4)
    paths = TR.write_records(str(tmp_path / "d"), idx, val, lab,
                             num_shards=2)
    on = TR.RecordDataset(paths, 64, 32, seed=5, device="cpu")
    off = TR.RecordDataset(paths, 64, 32, seed=5, device="cpu",
                           device_prefetch=False)
    for _ in range(2):
        a, b = list(on.blocks()), list(off.blocks())
        assert len(a) == len(b) == 6  # 75 rows a shard: 32, 32, 11
        for x, y in zip(a, b):
            assert all(torch.is_tensor(t) and t.device.type == "cpu"
                       for t in x)
            assert all(isinstance(t, np.ndarray) for t in y)
            for t, u in zip(x, y):
                assert t.numpy().tobytes() == u.tobytes()
                assert str(t.dtype).replace("torch.", "") == str(u.dtype)


def test_dataset_device_default_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    paths = TR.write_records(str(tmp_path / "d"), *_rows(n=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.RecordDataset(paths, 64, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.RecordDataset(paths, 64, 4, device_prefetch=False)


def _train_rows():
    rng = np.random.RandomState(1)
    d, n = 16, 400
    w = rng.randn(d)
    idx = [np.arange(d, dtype=np.int64) for _ in range(n)]
    val = [rng.randn(d).astype(np.float32) for _ in range(n)]
    lab = np.array([np.sign(v @ w) for v in val], np.float32)
    return d, idx, val, lab


def test_train_from_records(tmp_path):
    """tests/test_records.py::test_train_from_records through the port,
    beside the JAX package on the same shards: 3 shuffled epochs of
    minibatch AROW, every block equal, the models equal."""
    d, idx, val, lab = _train_rows()
    paths = TR.write_records(str(tmp_path / "t"), idx, val, lab,
                             num_shards=2)

    from hivemall_tpu.core.engine import make_train_step as jmake
    from hivemall_tpu.core.state import init_linear_state as jinit
    from hivemall_tpu.models.classifier import AROW as JAROW
    from hivemall_tpu_torch.core.engine import make_train_step
    from hivemall_tpu_torch.core.state import init_linear_state
    from hivemall_tpu_torch.models.classifier import AROW

    ds = TR.RecordDataset(paths, dims=d, batch_size=64, seed=3, device="cpu")
    step = make_train_step(AROW, {"r": 0.1}, mode="minibatch", device="cpu")
    state = init_linear_state(d, use_covariance=True, device="cpu")
    jds = JR.RecordDataset(paths, dims=d, batch_size=64, seed=3)
    jstep = jmake(JAROW, {"r": 0.1}, mode="minibatch")
    jstate = jinit(d, use_covariance=True)
    for _ in range(3):
        for blk, jblk in zip(ds.blocks(), jds.blocks()):
            assert blk.indices.numpy().tobytes() == \
                np.asarray(jblk.indices).tobytes()
            state, _ = step(state, blk.indices, blk.values, blk.labels)
            jstate, _ = jstep(jstate, jblk.indices, jblk.values,
                              jblk.labels)
    np.testing.assert_allclose(state.weights.numpy(),
                               np.asarray(jstate.weights), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(state.covars.numpy(),
                               np.asarray(jstate.covars), rtol=RTOL,
                               atol=ATOL)
    assert state.step == int(jstate.step) == 3 * 400
    wgt = state.weights.numpy()
    acc = np.mean([np.sign(v @ wgt[i]) == y for i, v, y in
                   zip(idx, val, lab)])
    assert acc > 0.9


def test_pallas_step_and_epoch_take_the_blocks_as_they_come(tmp_path):
    """The exact scan (`make_pallas_scan_step`, its plain version on the
    CPU) over a dataset's blocks, one call a block and through
    `make_epoch` on the blocks' lists (the last block shorter), equal to
    `train_arow -pallas` on the same rows in the same order."""
    from hivemall_tpu_torch.core.engine import make_epoch
    from hivemall_tpu_torch.core.state import init_linear_state
    from hivemall_tpu_torch.kernels.linear_scan import make_pallas_scan_step
    from hivemall_tpu_torch.models.classifier import AROW, train_arow

    d, idx, val, lab = _train_rows()
    # unsorted rows (records sort each one by id), each id keeping its value
    perms = [np.random.RandomState(i).permutation(d) for i in range(len(idx))]
    idx = [r[p] for r, p in zip(idx, perms)]
    val = [v[p] for v, p in zip(val, perms)]
    n = 200
    paths = TR.write_records(str(tmp_path / "p"), idx[:n], val[:n], lab[:n])
    ds = TR.RecordDataset(paths, dims=d, batch_size=64, shuffle=False,
                          device="cpu")
    step = make_pallas_scan_step(AROW, {"r": 0.1}, device="cpu")
    st = init_linear_state(d, use_covariance=True, device="cpu")
    for blk in ds.blocks():
        st, _ = step(st, blk.indices, blk.values, blk.labels)
    blocks = list(ds.blocks())
    assert [b.batch_size for b in blocks] == [64, 64, 64, 8]
    st2, losses = make_epoch(step)(
        init_linear_state(d, use_covariance=True, device="cpu"),
        [b.indices for b in blocks], [b.values for b in blocks],
        [b.labels for b in blocks])
    assert losses.shape == (4,)
    ref = train_arow((idx[:n], val[:n]), lab[:n],
                     f"-dims {d} -pallas -block_size 64", device="cpu")
    for got in (st, st2):
        np.testing.assert_allclose(got.weights.numpy(),
                                   ref.state.weights.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.covars.numpy(),
                                   ref.state.covars.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(got.touched.numpy(),
                                      ref.state.touched.numpy())
