"""The port's sharded and replicated serving (hivemall_tpu_torch/serving/
placement.py, serving/sharded.py, the engine / registry hooks) against the
JAX package's sharded engine and the port's single-device engine.

The JAX engine runs on the 8 host devices tests/conftest.py forces; the
port's runs one process over ``devices=[cpu] * n``. One artifact, frozen by
the JAX package from a JAX-trained model, feeds all three engines.

Tolerances are the reference's own (tests/test_serving_sharded.py:1-13):
linear and multiclass requests are rows of <= 2 non-zeros with dyadic
values, so each row's reduction performs at most one rounding addition of
two arbitrary f32 products — identical under any grouping — and the
sharded scores are bit-equal to the JAX sharded engine's and to the
port's single-device engine's. Wide rows, FM and MF regroup >= 3
additions across stripes: rtol 1e-5 / atol 1e-6. The placement blocks
(grid shape, stripe grids, per-device bytes) and the resident table bytes
equal the JAX engine's."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from hivemall_tpu.models.classifier import train_arow as jtrain_arow
from hivemall_tpu.serving import ModelSharded as JModelSharded
from hivemall_tpu.serving import Replicated as JReplicated
from hivemall_tpu.serving import ServingEngine as JEngine
from hivemall_tpu.serving import freeze as jfreeze
from hivemall_tpu.serving import load as jload
from hivemall_tpu_torch.models.base import _stage_rows
from hivemall_tpu_torch.serving import (ModelExceedsDeviceBudget,
                                        ModelRegistry, ModelSharded,
                                        Replicated, ServingEngine,
                                        SingleDevice, load, make_servable,
                                        serve)
from hivemall_tpu_torch.serving import engine as tengine
from hivemall_tpu_torch.serving import sharded as tsharded
from hivemall_tpu_torch.serving.placement import resolve_placement

from torch_cases import ATOL, RTOL

CPU = torch.device("cpu")
DIMS = 256
ROWS = [[f"{i % 13}:1.0", f"{(i * 7) % 13}:0.5"] for i in range(64)]
LABELS = [1 if i % 2 else -1 for i in range(64)]
MESHES = [(1, 2), (2, 2), (1, 4)]
QUANTS = [None, "bf16", "int8"]
GEOM = dict(max_batch=16, max_width=8)


def mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


def quant_id(q):
    return q or "f32"


def cpus(shape):
    return [CPU] * (shape[0] * shape[1])


@pytest.fixture(scope="module")
def jax_models():
    """The reference tests' models, trained by the JAX package, with their
    request rows."""
    from hivemall_tpu.models.fm import train_fm
    from hivemall_tpu.models.mf import train_mf_sgd
    from hivemall_tpu.models.multiclass import train_multiclass_pa

    mc_rows = [[f"{i % 11}:1.0", f"{(i * 5) % 11}:0.5"] for i in range(60)]
    fm_rows = [[f"{i % 17}:1.0", f"{(i * 3) % 17}:0.5"] for i in range(80)]
    users = [i % 5 for i in range(40)]
    items = [(i * 3) % 7 for i in range(40)]
    return {
        "linear": (jtrain_arow(ROWS, LABELS, f"-dims {DIMS}"), ROWS),
        "multiclass": (train_multiclass_pa(
            mc_rows, [("a", "b", "c")[i % 3] for i in range(60)],
            "-dims 128"), mc_rows),
        "fm": (train_fm(fm_rows, [1.0 if i % 2 else -1.0 for i in range(80)],
                        "-dims 64 -factor 4"), fm_rows),
        "mf": (train_mf_sgd(users, items,
                            [float((i % 5) + 1) for i in range(40)]),
               list(zip(users[:12], items[:12]))),
    }


@pytest.fixture(scope="module")
def artifacts(jax_models, tmp_path_factory):
    """{(family, quant): artifact dir} frozen by the JAX package."""
    root = tmp_path_factory.mktemp("sharded_arts")
    out = {}
    for fam, (model, _) in jax_models.items():
        for q in QUANTS:
            path = str(root / f"{fam}_{quant_id(q)}")
            jfreeze(model, path, name=f"sh_{fam}", version="1", quantize=q)
            out[fam, q] = path
    return out


def engines(path, name, shape, **kw):
    """(JAX sharded, port sharded, port single-device) engines over one
    artifact."""
    kw = {**GEOM, **kw}
    b, n = shape
    j = JEngine(jload(path), name=f"j_{name}",
                placement=JModelSharded(n, batch_shards=b), **kw)
    t = ServingEngine(load(path), name=f"t_{name}",
                      placement=ModelSharded(n, batch_shards=b,
                                             devices=cpus(shape)), **kw)
    s = ServingEngine(load(path), name=f"s_{name}", device="cpu", **kw)
    return j, t, s


def same_placement(t, j):
    assert t.placement == j.placement
    assert t.table_bytes == j.table_bytes
    assert t.per_device_table_bytes == j.per_device_table_bytes
    assert t.weights_dtype == j.weights_dtype


# --- every family at every precision, on three grid shapes ------------------


@pytest.mark.parametrize("quant", QUANTS, ids=quant_id)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_linear_sharded_bit_equal(artifacts, shape, quant):
    j, t, s = engines(artifacts["linear", quant], f"lin_{quant_id(quant)}",
                      shape)
    same_placement(t, j)
    out = t.predict(ROWS)
    np.testing.assert_array_equal(out, np.asarray(j.predict(ROWS)))
    np.testing.assert_array_equal(out, s.predict(ROWS))


@pytest.mark.parametrize("quant", QUANTS, ids=quant_id)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_multiclass_sharded_bit_equal(artifacts, jax_models, shape, quant):
    rows = jax_models["multiclass"][1]
    j, t, s = engines(artifacts["multiclass", quant],
                      f"mc_{quant_id(quant)}", shape)
    same_placement(t, j)
    assert t.predict(rows) == j.predict(rows) == s.predict(rows)  # labels
    raw = t.servable.run_padded(rows[:8], 8, 8).numpy()
    np.testing.assert_array_equal(
        raw, np.asarray(j.servable.run_padded(rows[:8], 8, 8)))
    np.testing.assert_array_equal(
        raw, s.servable.run_padded(rows[:8], 8, 8).numpy())


@pytest.mark.parametrize("quant", QUANTS, ids=quant_id)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_fm_sharded_matches(artifacts, jax_models, shape, quant):
    rows = jax_models["fm"][1]
    j, t, s = engines(artifacts["fm", quant], f"fm_{quant_id(quant)}",
                      shape)
    same_placement(t, j)
    out = t.predict(rows)
    np.testing.assert_allclose(out, np.asarray(j.predict(rows)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out, s.predict(rows), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quant", QUANTS, ids=quant_id)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
def test_mf_sharded_matches(artifacts, jax_models, shape, quant):
    pairs = jax_models["mf"][1]
    j, t, s = engines(artifacts["mf", quant], f"mf_{quant_id(quant)}",
                      shape)
    same_placement(t, j)
    out = t.predict(pairs)
    np.testing.assert_allclose(out, np.asarray(j.predict(pairs)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, s.predict(pairs), rtol=RTOL, atol=ATOL)
    # an out-of-range user lands in no stripe and scores mu plus the
    # item's bias (the sharded trade); single-device raises
    art = load(artifacts["mf", quant])
    bias = float(art.arrays["Bi"][0]) if art.meta["use_bias"] else 0.0
    np.testing.assert_allclose(t.predict([(10 ** 6, 0)]),
                               [float(art.arrays["mu"]) + bias], rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(IndexError):
        s.predict([(10 ** 6, 0)])


def test_linear_wide_rows_allclose(artifacts):
    """Rows of 7 features regroup >= 3 additions across stripes."""
    wide = [[f"{(i * 3 + k) % DIMS}:0.75" for k in range(7)]
            for i in range(40)]
    j, t, s = engines(artifacts["linear", None], "wide", (1, 4))
    out = t.predict(wide)
    np.testing.assert_allclose(out, np.asarray(j.predict(wide)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out, s.predict(wide), rtol=RTOL, atol=ATOL)


def test_live_port_models_serve_sharded():
    """A model trained by the port serves sharded from the live object
    (host_score_tables of a model, not an artifact) == its own predict."""
    from hivemall_tpu_torch.models.classifier import train_arow
    from hivemall_tpu_torch.models.fm import train_fm

    lin = train_arow(ROWS, LABELS, f"-dims {DIMS}", device="cpu")
    eng = ServingEngine(lin, name="live_lin", placement=ModelSharded(
        2, devices=cpus((1, 2))), **GEOM)
    np.testing.assert_array_equal(eng.predict(ROWS), lin.predict(ROWS))
    rows = [[f"{i % 17}:1.0", f"{(i * 3) % 17}:0.5"] for i in range(40)]
    fm = train_fm(rows, [1.0 if i % 2 else -1.0 for i in range(40)],
                  "-dims 64 -factor 4", device="cpu")
    eng = ServingEngine(fm, name="live_fm", placement=ModelSharded(
        4, devices=cpus((1, 4))), **GEOM)
    np.testing.assert_allclose(eng.predict(rows), fm.predict(rows),
                               rtol=RTOL, atol=ATOL)


# --- striping arithmetic -----------------------------------------------------


def test_int8_scale_blocks_never_straddle_stripes(jax_models, tmp_path):
    """A block_rows that does not divide ceil(dims / n) aligns the stripe
    up, so every scale block lives on one stripe."""
    path = str(tmp_path / "int8_block")
    jfreeze(jax_models["linear"][0], path, name="shq_block", version="1",
            quantize="int8", quant_block_rows=32)
    j, t, s = engines(path, "block32", (1, 4))
    grid = t.placement["stripe_grids"]["features"]
    assert grid["stripe"] % 32 == 0
    assert grid["dims_padded"] == grid["stripe"] * 4
    same_placement(t, j)
    np.testing.assert_array_equal(t.predict(ROWS), s.predict(ROWS))


def test_non_divisible_dims_bit_equal(tmp_path):
    """dims = 300 over 4 stripes (stripe 75); the padded slots are
    gathered only by pad lanes, so scores stay bit-equal."""
    path = str(tmp_path / "d300")
    jfreeze(jtrain_arow(ROWS, LABELS, "-dims 300"), path, name="d300",
            version="1")
    j, t, s = engines(path, "d300", (1, 4))
    assert t.placement["stripe_grids"]["features"] == \
        {"dims": 300, "stripe": 75, "dims_padded": 300}
    same_placement(t, j)
    np.testing.assert_array_equal(t.predict(ROWS), s.predict(ROWS))
    np.testing.assert_array_equal(t.predict(ROWS),
                                  np.asarray(j.predict(ROWS)))


def test_preparsed_requests_through_sharded_engine(artifacts):
    _, t, _ = engines(artifacts["linear", None], "pre", (2, 2))
    ref = t.predict(ROWS)
    pre = _stage_rows(ROWS, DIMS)
    np.testing.assert_array_equal(t.predict(pre), ref)
    lens = np.array([len(r) for r in pre[0]], np.int64)
    flat = (np.concatenate(pre[0]), np.concatenate(pre[1]), lens)
    np.testing.assert_array_equal(t.predict(flat), ref)


def test_a_repeated_device_holds_each_stripe_once(artifacts):
    """A (2, 2) grid over one device places stripe j once, and the
    resident tables are the logical (padded) ones."""
    _, t, s = engines(artifacts["linear", None], "dedupe", (2, 2))
    sv = t.servable
    assert sv._stripes[0][0][0] is sv._stripes[1][0][0]
    assert sv._stripes[0][0][0] is not sv._stripes[0][1][0]
    assert t.table_bytes == s.table_bytes == DIMS * 4


# --- warmup ------------------------------------------------------------------


def test_sharded_warmup_covers_every_bucket(artifacts):
    _, t, _ = engines(artifacts["linear", None], "warm", (2, 2),
                      max_batch=32, max_width=16)
    assert t.warmup() == 0  # the CPU has no caching allocator
    assert len(t.warmed_buckets) == \
        len(t.batch_buckets()) * len(t.width_buckets())
    assert ("linear", 8, None, (2, 2)) in tengine._WARMUP_DUMMIES
    for n in (1, 7, 9, 30, 32):
        batch = [[f"{k % 13}:1.0" for k in range(5)] for _ in range(n)]
        assert len(t.predict(batch)) == n


# --- placement surface / validation -------------------------------------------


def test_replicated_placement_parity(artifacts):
    path = artifacts["linear", None]
    j = JEngine(jload(path), name="j_repl", placement=JReplicated(
        batch_shards=8), **GEOM)
    t = ServingEngine(load(path), name="t_repl",
                      placement=Replicated(devices=[CPU] * 8), **GEOM)
    assert t.placement["kind"] == "replicated"
    assert t.placement["model_shards"] == 1
    assert t.placement["batch_shards"] == 8  # the largest power of two
    same_placement(t, j)
    np.testing.assert_array_equal(t.predict(ROWS),
                                  np.asarray(j.predict(ROWS)))


def test_batch_shards_must_divide_buckets(artifacts):
    with pytest.raises(ValueError, match="batch_shards"):
        ServingEngine(load(artifacts["linear", None]), name="bad_bs",
                      max_batch=16, max_width=8, min_batch_bucket=2,
                      placement=ModelSharded(2, batch_shards=4,
                                             devices=[CPU] * 8))
    with pytest.raises(ValueError, match="power of two"):
        ModelSharded(2, batch_shards=3, devices=[CPU] * 6)


def test_placement_string_resolution(artifacts):
    assert isinstance(resolve_placement("model_sharded"), ModelSharded)
    assert isinstance(resolve_placement("sharded"), ModelSharded)
    assert isinstance(resolve_placement("replicated"), Replicated)
    assert type(resolve_placement("single_device")) is SingleDevice
    assert resolve_placement(None).kind == "single_device"
    # a kind string means every CUDA device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(load(artifacts["linear", None]), name="str_sh",
                          placement="model_sharded", **GEOM)
    with pytest.raises(ValueError, match="unknown placement"):
        make_servable(load(artifacts["linear", None]),
                      placement="interleaved")
    with pytest.raises(TypeError):
        resolve_placement(3)


def test_unshardable_families_refuse(tmp_path):
    from hivemall_tpu_torch.models.ffm import train_ffm
    from hivemall_tpu_torch.models.trees import \
        train_randomforest_classifier

    rows = [[f"{i % 3}:{i % 11}:1.0", f"{(i + 1) % 3}:{(i * 5) % 11}:0.5"]
            for i in range(30)]
    ffm = train_ffm(rows, [1 if i % 2 else -1 for i in range(30)],
                    "-feature_hashing 8 -v_bits 10 -factor 2", device="cpu")
    with pytest.raises(ValueError, match="no sharded serving path"):
        make_servable(ffm, placement=ModelSharded(2, devices=[CPU] * 2))
    rng = np.random.RandomState(0)
    X = rng.rand(60, 3)
    forest = train_randomforest_classifier(X, (X[:, 0] > 0.5).astype(int),
                                           "-trees 2", device="cpu")
    with pytest.raises(ValueError, match="no sharded serving path"):
        make_servable(forest, placement=ModelSharded(2, devices=[CPU] * 2))


def test_device_byte_budget_enforced_before_placement(artifacts,
                                                      monkeypatch):
    """A budget below the table bytes refuses single-device; the sharded
    per-device slice fits and serves; a budget below even the slice
    refuses sharded too — before any table is placed."""
    art = load(artifacts["linear", None])
    total = ServingEngine(art, name="bud_probe", device="cpu",
                          **GEOM).table_bytes
    budget = total // 2
    with pytest.raises(ModelExceedsDeviceBudget):
        make_servable(art, placement=SingleDevice(device_byte_budget=budget),
                      device="cpu")
    eng = ServingEngine(art, name="bud_ok", placement=ModelSharded(
        4, devices=[CPU] * 4, device_byte_budget=budget), **GEOM)
    assert eng.per_device_table_bytes <= budget
    assert len(eng.predict(ROWS)) == len(ROWS)

    def placed(*a, **k):
        raise AssertionError("a table was placed before the budget check")

    monkeypatch.setattr(tsharded, "_stripe_put", placed)
    with pytest.raises(ModelExceedsDeviceBudget):
        make_servable(art, placement=ModelSharded(
            4, devices=[CPU] * 4, device_byte_budget=total // 64))


def test_registry_and_http_surface_placement(artifacts):
    """ModelRegistry.deploy(placement=...) passes the placement through;
    GET /models carries the placement block beside the single-device one;
    POST /predict answers from the sharded engine."""
    registry = ModelRegistry(max_batch=16, engine_kwargs={"max_width": 8},
                             device="cpu")
    server = serve(registry)
    port = server.server_address[1]
    path = artifacts["linear", None]
    try:
        registry.deploy("sharded_ctr", path, placement=ModelSharded(
            2, devices=[CPU] * 2))
        registry.deploy("plain_ctr", path)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/models",
                                    timeout=10) as r:
            by_name = {d["name"]: d for d in json.loads(r.read())["models"]}
        pl = by_name["sharded_ctr"]["placement"]
        assert pl["kind"] == "model_sharded"
        assert pl["mesh_shape"] == [1, 2]
        assert pl["stripe_grids"]["features"]["stripe"] == DIMS // 2
        assert pl["per_device_table_bytes"] == DIMS // 2 * 4
        assert by_name["plain_ctr"]["placement"]["kind"] == "single_device"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=json.dumps({"model": "sharded_ctr",
                             "instances": ROWS[:4]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            got = json.loads(r.read())["predictions"]
        want = ServingEngine(load(path), name="http_ref", device="cpu",
                             **GEOM).predict(ROWS[:4])
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    finally:
        server.shutdown()
        server.server_close()
        registry.shutdown()
