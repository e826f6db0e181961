"""The port's native host library (hivemall_tpu_torch/native/) against the
JAX package's (hivemall_tpu/native/), both built from
native/hivemall_native.cpp, on the same numpy and string inputs.

- The build: g++ at first use into hivemall_tpu_torch/native/_build/;
  processes reaching the first build together leave one whole library; a
  failing or missing compiler raises RuntimeError with its output, and no
  caller falls back to numpy in its place.
- The ABI handshake against ops/scatter.py's PLAN_ABI_VERSION.
- murmur3 / murmur3_bulk, parse_features_batch and the zigzag-LEB128 codec
  equal the JAX package's exactly (one source, one compiler), including
  the inputs the C parser declines (non-canonical tokens, tuple rows,
  non-ASCII numeric names) and values past 64 bits in the codec.
None of the JAX functions used here is red on this tree."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hivemall_tpu import native as JN
from hivemall_tpu.utils import codec as JCodec
from hivemall_tpu.utils import feature as JF
from hivemall_tpu.utils import hashing as JH
from hivemall_tpu_torch import native as TN
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.native import build as TB
from hivemall_tpu_torch.ops import scatter as TS
from hivemall_tpu_torch.utils import codec as TCodec
from hivemall_tpu_torch.utils import feature as TF
from hivemall_tpu_torch.utils import hashing as TH

ROOT = Path(__file__).resolve().parent.parent
D = 1 << 20


# --- the build ---------------------------------------------------------------

def test_loaded_library_is_the_ports_own_build():
    path = Path(TN.library_path()).resolve()
    assert path.parent == ROOT / "hivemall_tpu_torch" / "native" / "_build"
    assert path.name.startswith("libhivemall_native_")
    assert "hivemall_tpu/" not in str(path)
    assert path != Path(JN._LIB_PATH).resolve()
    assert TN.load_error() is None


_BUILD_CHILD = """
import sys
from pathlib import Path
from hivemall_tpu_torch.native import build
import hivemall_tpu_torch.native as native
build.BUILD_DIR = Path(sys.argv[1])
print(native.library_path(), native._load().hm_plan_abi_version())
"""


def test_concurrent_first_builds_leave_one_whole_library(tmp_path):
    """Four processes reach an empty build directory together: each
    compiles to its own temporary name and renames it into place, so all
    load a whole library under the one final name and nothing else stays."""
    out = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(out)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=600) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr
    lines = {stdout.strip() for stdout, _ in results}
    assert len(lines) == 1, lines
    path, version = lines.pop().split()
    assert int(version) == TS.PLAN_ABI_VERSION
    assert sorted(out.iterdir()) == [Path(path)]


def test_failing_compiler_raises_with_its_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int hm_plan_abi_version( { return 1; }\n")
    monkeypatch.setattr(TB, "SOURCE", bad)
    monkeypatch.setattr(TB, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        TB.build()
    assert list((tmp_path / "build").iterdir()) == []


def test_missing_compiler_raises_and_nothing_falls_back(tmp_path,
                                                         monkeypatch):
    """No compiler: the build raises, the loader reports it, and the
    native backends and the string parser raise instead of taking numpy."""
    monkeypatch.setattr(TB, "CXX", "hivemall-no-such-compiler")
    monkeypatch.setattr(TB, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_load_error", None)
    with pytest.raises(RuntimeError, match="not found"):
        TB.build()
    assert TN.load_error() is None  # reports a failed load, builds nothing
    with pytest.raises(RuntimeError, match="hivemall-no-such-compiler"):
        TN.library_path()
    assert "hivemall-no-such-compiler" in TN.load_error()
    idx = [np.array([1, 2])] * 4
    val = [np.ones(2, np.float32)] * 4
    for opts in ("-native_scan", "-batch 2 -native_apply"):
        with pytest.raises(RuntimeError, match="not found"):
            TC.train_arow((idx, val), [1, 0, 1, 0], f"-dims 16 {opts}",
                          device="cpu")
    with pytest.raises(RuntimeError, match="not found"):
        TF.parse_features_batch([["a:1"]], 16)


def test_serving_warmup_builds_the_library(monkeypatch):
    """ServingEngine.warmup (and so ModelRegistry.deploy) builds or loads
    the library, so the first string request pays no compile."""
    from hivemall_tpu_torch.serving.engine import ServingEngine

    model = TC.train_arow(([np.array([1, 2])], [np.ones(2, np.float32)]),
                          [1.0], "-dims 16", device="cpu")
    builds = []
    real_build = TB.build
    monkeypatch.setattr(TB, "build", lambda: builds.append(1) or real_build())
    monkeypatch.setattr(TN, "_lib", None)
    eng = ServingEngine(model, name="t_native_warm", device="cpu",
                        max_batch=8)
    assert TN._lib is None and not builds
    eng.warmup()
    assert builds == [1] and TN._lib is not None
    before = TN.CALLS["parse_features_bulk"]
    eng.predict([["1:1", "2:0.5"]])
    assert TN.CALLS["parse_features_bulk"] == before + 1 and builds == [1]


# --- the ABI handshake -------------------------------------------------------

def test_abi_handshake(monkeypatch):
    assert TN._load().hm_plan_abi_version() == TS.PLAN_ABI_VERSION
    monkeypatch.setattr(TS, "PLAN_ABI_VERSION", TS.PLAN_ABI_VERSION + 1)
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_load_error", None)
    with pytest.raises(RuntimeError, match="plan ABI version mismatch"):
        TN._load()
    assert "mismatch" in TN.load_error()


# --- hashing -----------------------------------------------------------------

WORDS = ["", "a", "ab", "abc", "abcd", "hello world", "f123", "user_42",
         "日本語", "ü" * 33, "x" * 257]


def test_murmur3_matches_jax():
    for w in WORDS:
        b = w.encode()
        assert TN.murmur3(b) == JN.murmur3(b) == TH.murmurhash3_x86_32(b)
        assert TN.murmur3(b, seed=7) == JN.murmur3(b, seed=7)


@pytest.mark.parametrize("n_features", [1 << 24, 1 << 22, 1000003])
def test_murmur3_bulk_matches_jax(n_features):
    rng = np.random.RandomState(0)
    words = WORDS + [f"f{i}" for i in rng.randint(0, 1 << 30, 500)]
    bs = [w.encode() for w in words]
    want = JN.murmur3_bulk(bs, n_features)
    np.testing.assert_array_equal(TN.murmur3_bulk(bs, n_features), want)
    before = TN.CALLS["murmur3_bulk"]
    got = TH.murmurhash3_bytes_batch(words, n_features)
    assert TN.CALLS["murmur3_bulk"] == before + 1
    np.testing.assert_array_equal(got, want)
    # another seed goes through the library too, equal to the JAX
    # package's numpy path at that seed
    np.testing.assert_array_equal(
        TH.murmurhash3_bytes_batch(words, n_features, seed=11),
        JH.murmurhash3_bytes_batch(words, n_features, seed=11))
    assert TN.CALLS["murmur3_bulk"] == before + 2
    assert TH.murmurhash3_bytes_batch([], n_features).shape == (0,)


# --- feature parsing ---------------------------------------------------------

def _int_rows(rng, n=64, k=32):
    return [[f"{i}:1" for i in rng.randint(0, 1 << 30, k)] for _ in range(n)]


def _hashed_rows(rng, n=64, k=32):
    return [[f"f{i}:{v:g}" for i, v in zip(rng.randint(0, 1 << 30, k),
                                           rng.randn(k))]
            for _ in range(n)]


CANONICAL = {
    "int": lambda rng: _int_rows(rng),
    "hashed": lambda rng: _hashed_rows(rng),
    "mixed": lambda rng: [["1:0.5", "7", "-5:1", "+3:2", "user_abc:2",
                           "x:1e-3", "3:-2.5E+2", "café:1", "日本"], []],
}
DECLINED = {
    "spaced value": [["1: 2", "3:1"]],
    "spaced name": [[" 5:1", "2"]],
    "underscore name": [["1_0:1"]],
    "long name": [["12345678901234567890:1"]],
    "nan value": [["1:nan", "2:inf"]],
    "tuple row": [["4:1"], [(3, 0.5), ("name", 2.0)]],
    "arabic-indic digit": [["\u0663:1", "a:2"]],
    "nbsp digit": [["\u00a05:1"]],
}


@pytest.mark.parametrize("case", sorted(CANONICAL))
def test_parse_native_matches_jax_and_numpy(case):
    rows = CANONICAL[case](np.random.RandomState(len(case)))
    before = TN.CALLS["parse_features_bulk"]
    ti, tv = TF.parse_features_batch(rows, D)
    assert TN.CALLS["parse_features_bulk"] == before + 1
    assert TN.parse_features_bulk(rows, D) is not None  # the C path took it
    ji, jv = JF.parse_features_batch(rows, D)
    ni, nv = TF.parse_features_numpy(rows, D)
    assert len(ti) == len(ji) == len(ni) == len(rows)
    for a, b, c in zip(ti, ji, ni):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == b.dtype == np.int64
    for a, b, c in zip(tv, jv, nv):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == b.dtype == np.float32


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_parse_declined_rows_take_the_python_path_like_jax(case):
    rows = DECLINED[case]
    assert TN.parse_features_bulk(rows, D) is None
    assert JN.parse_features_bulk(rows, D) is None
    ti, tv = TF.parse_features_batch(rows, D)
    ji, jv = JF.parse_features_batch(rows, D)
    for a, b in zip(ti + tv, ji + jv):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("bad", ["", ":1", "1:", "1:abc"])
def test_parse_malformed_raises_like_jax(bad):
    for parse in (TF.parse_features_batch, JF.parse_features_batch):
        with pytest.raises(ValueError):
            parse([["2:1", bad]], D)


# --- the codec ---------------------------------------------------------------

def test_codec_int64_matches_jax():
    rng = np.random.RandomState(3)
    vals = np.concatenate([
        rng.randint(-1 << 40, 1 << 40, 2000),
        [0, 1, -1, 63, 64, -64, -65, 127, 128, np.iinfo(np.int64).max,
         np.iinfo(np.int64).min]]).astype(np.int64)
    before = TN.CALLS["zigzag_leb128_encode"]
    blob = TCodec.zigzag_leb128_encode_array(vals)
    assert TN.CALLS["zigzag_leb128_encode"] == before + 1
    assert blob == JCodec.zigzag_leb128_encode_array(vals)
    assert blob == TN.zigzag_leb128_encode(vals) == \
        JN.zigzag_leb128_encode(vals)
    out = TCodec.zigzag_leb128_decode_array(blob, len(vals))
    assert out == JCodec.zigzag_leb128_decode_array(blob, len(vals))
    assert out == vals.tolist()


def test_codec_past_64_bits_matches_jax():
    """Values outside int64 take the per-value Python path in both
    packages, and their blobs decode through it (the C decoder refuses a
    value past 64 bits with ValueError, which routes there)."""
    vals = [5, -(1 << 70), 1 << 64, (1 << 63) - 1, -(1 << 63)]
    blob = TCodec.zigzag_leb128_encode_array(vals)
    assert blob == JCodec.zigzag_leb128_encode_array(vals)
    with pytest.raises(ValueError):
        TN.zigzag_leb128_decode(blob, len(vals))
    assert TCodec.zigzag_leb128_decode_array(blob, len(vals)) == vals
    assert JCodec.zigzag_leb128_decode_array(blob, len(vals)) == vals


def test_sparse_model_blobs_byte_equal_to_jax():
    rng = np.random.RandomState(5)
    feats = rng.choice(1 << 22, 3000, replace=False).astype(np.int64)
    w = rng.randn(3000).astype(np.float32)
    for half in (True, False):
        blob = TCodec.encode_sparse_model(feats, w, half_float=half)
        assert blob == JCodec.encode_sparse_model(feats, w, half_float=half)
        f1, w1 = TCodec.decode_sparse_model(blob)
        f2, w2 = JCodec.decode_sparse_model(blob)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(w1, w2)
