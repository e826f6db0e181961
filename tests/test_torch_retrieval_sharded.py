"""The port's sharded top-K catalog (hivemall_tpu_torch/serving/
retrieval.py ``_ShardedCatalog`` and the sharded MF / FM query stagers)
on the CPU, over ``devices=[cpu] * n``.

The JAX package's own sharded top-K is red on this tree: its
``_build_sh_block_step`` fails shard_map's replication check at
hivemall_tpu/serving/retrieval.py:661 ("out_specs which require
replication which can't be statically inferred"; the four
tests/test_serving_retrieval.py ``test_{mf,fm}_sharded_matches_single``
cases). So, as the reference's own gate says, the sharded catalog is held
to score parity with SINGLE-device retrieval — the port's, and the JAX
package's single-device RetrievalEngine on the same artifact: top-K ids
equal except where exact ties across stripes resolve differently (the
merge interleaves stripes per step; the catalogs here have no exact ties,
so ids are compared exactly), scores at rtol 1e-5 / atol 1e-6. Every case
runs exact and LSH-probed, MF and FM, at f32, bf16 and int8, on grids
(1, 2), (2, 2) and (1, 4)."""

import numpy as np
import pytest
import torch

from hivemall_tpu.serving import RetrievalEngine as JRetrieval
from hivemall_tpu.serving import freeze as jax_freeze
from hivemall_tpu.serving import load as jax_load
from hivemall_tpu_torch.serving import (ModelRegistry, ModelSharded,
                                        RetrievalEngine, load)

from torch_cases import ATOL, RTOL, carried_fm_models, carried_mf_models

CPU = torch.device("cpu")
MESHES = [(1, 2), (2, 2), (1, 4)]
QUANTS = [None, "bf16", "int8"]
N_USERS, N_ITEMS, FM_DIMS = 30, 90, 100
MF_QUERIES = [0, 5, 11, 2, 29, 7, 13]
FM_QUERIES = [[f"{(i * 7 + k) % FM_DIMS}:{0.5 + 0.25 * k}"
               for k in range(3)] for i in range(6)]
# block 16 over 90 / 100 items: every stripe has a partial last block
GEOM = dict(k=6, block_items=16, max_batch=4, candidate_cap=64,
            max_width=8)


def mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


def quant_id(q):
    return q or "f32"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{(family, quant): artifact dir}: carried warm states frozen by the
    JAX package with a 3-plane SRP index (int8 at block_rows 8)."""
    root = tmp_path_factory.mktemp("topk_sharded")
    jm, _ = carried_mf_models(N_USERS, N_ITEMS, k=4, seed=0)
    jf, _ = carried_fm_models(dims=FM_DIMS, factors=5, seed=4)
    out = {}
    for fam, model in (("mf", jm), ("fm", jf)):
        for q in QUANTS:
            path = str(root / f"{fam}_{quant_id(q)}")
            jax_freeze(model, path, name=f"topk_{fam}", version="1",
                       quantize=q, retrieval_index={"planes": 3, "seed": 0},
                       **({"quant_block_rows": 8} if q == "int8" else {}))
            out[fam, q] = path
    return out


def sharded(path, shape, name):
    b, n = shape
    return RetrievalEngine(load(path), name=name, placement=ModelSharded(
        n, batch_shards=b, devices=[CPU] * (b * n)), **GEOM)


def assert_same(got, want):
    for a, b in zip(got, want):
        assert a["items"] == b["items"]
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("probe", [False, True], ids=["exact", "probed"])
@pytest.mark.parametrize("quant", QUANTS, ids=quant_id)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_id)
@pytest.mark.parametrize("family", ["mf", "fm"])
def test_sharded_topk_matches_single(artifacts, family, shape, quant,
                                     probe):
    path = artifacts[family, quant]
    queries = MF_QUERIES if family == "mf" else FM_QUERIES
    tag = f"{family}_{quant_id(quant)}_{mesh_id(shape)}_{int(probe)}"
    eng = sharded(path, shape, f"sh_{tag}")
    assert eng.warmup() == 0
    single = RetrievalEngine(load(path), name=f"one_{tag}", device="cpu",
                             **GEOM)
    ref = JRetrieval(jax_load(path), name=f"j_{tag}", **GEOM)
    got = eng.topk(queries, probe=probe)
    assert_same(got, single.topk(queries, probe=probe))
    assert_same(got, ref.topk(queries, probe=probe))
    d = eng.describe()
    assert d["placement"]["kind"] == "model_sharded"
    assert d["placement"]["mesh_shape"] == list(shape)


def test_stripes_align_to_blocks_and_scale_blocks(artifacts):
    """The catalog stripe is a multiple of block_items (so of the int8
    block) and every step scores one block of every stripe."""
    eng = sharded(artifacts["mf", "int8"], (1, 4), "sh_align")
    cat = eng._catalog
    assert cat.stripe % GEOM["block_items"] == 0
    assert cat.n_pad == 4 * cat.stripe >= N_ITEMS
    assert cat.n_steps * GEOM["block_items"] == cat.stripe
    assert all(v.shape[0] == cat.stripe for v in cat.vec)
    assert all(s.shape[0] == cat.stripe // 8 for s in cat.vscale)
    with pytest.raises(NotImplementedError):
        eng.score_catalog(MF_QUERIES)


def test_out_of_range_user_stages_to_mu(artifacts):
    """A user outside the table lands in no stripe: qvec 0, base mu (the
    reference's sharded trade); single-device raises."""
    eng = sharded(artifacts["mf", None], (1, 2), "sh_oob")
    qvec, base = eng._stager.stage([N_USERS + 5], 1)
    assert not qvec.any()
    np.testing.assert_allclose(base, [float(load(
        artifacts["mf", None]).arrays["mu"])], rtol=0, atol=0)
    single = RetrievalEngine(load(artifacts["mf", None]), name="one_oob",
                             device="cpu", **GEOM)
    with pytest.raises(ValueError, match="out of range"):
        single.topk([N_USERS + 5])


def test_registry_topk_through_sharded_placement(artifacts):
    """deploy(placement=..., retrieval={}) stands the sharded catalog up
    beside the sharded pointwise engine."""
    registry = ModelRegistry(max_batch=8, device="cpu")
    path = artifacts["mf", None]
    try:
        entry = registry.deploy("rec", path, retrieval=dict(GEOM),
                                placement=ModelSharded(2,
                                                       devices=[CPU] * 2))
        assert entry.retrieval_engine.sharded
        _, fut = registry.submit_topk("rec", [(q, None, None)
                                              for q in MF_QUERIES])
        single = RetrievalEngine(load(path), name="one_reg", device="cpu",
                                 **GEOM)
        assert_same(fut.result(timeout=30), single.topk(MF_QUERIES))
    finally:
        registry.shutdown()
