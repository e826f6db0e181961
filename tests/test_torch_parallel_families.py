"""The port's FM, FFM and multiclass mix and sharded trainers
(hivemall_tpu_torch/parallel/{fm_mix,ffm_mix,mc_mix,sharded_train}.py, and
the models' feature_shard hooks) against the JAX package's on its
simulated CPU mesh.

The port side runs in n gloo ranks on the CPU (tests/torch_cases.py
run_ranks), the JAX side on make_mesh(n) with the same numpy blocks. Mix
trainers agree within rtol 1e-5 / atol 1e-6 (JAX's own tolerance for the
nonlinear families, tests/test_mix_semantics.py:205); sharded trainers
within the sharded reference tolerance rtol 2e-5 / atol 1e-6
(tests/test_sharded_2d.py); `touched` and `step` exact everywhere.
"""

import numpy as np
import pytest

from hivemall_tpu.parallel import MixConfig as JMixConfig
from hivemall_tpu.parallel import make_mesh as jmake_mesh
from hivemall_tpu.parallel.ffm_mix import FFMMixTrainer as JFFMMix
from hivemall_tpu.parallel.fm_mix import FMMixTrainer as JFMMix
from hivemall_tpu.parallel.mc_mix import MulticlassMixTrainer as JMCMix
from hivemall_tpu.parallel.sharded_train import FFMShardedTrainer as JFFMSh
from hivemall_tpu.parallel.sharded_train import FMShardedTrainer as JFMSh
from hivemall_tpu.parallel.sharded_train import MCShardedTrainer as JMCSh
from hivemall_tpu_torch.models.ffm import ffm_state_to_numpy
from hivemall_tpu_torch.models.fm import fm_state_to_numpy
from hivemall_tpu_torch.models.multiclass import mc_state_to_numpy
from hivemall_tpu_torch.parallel import (FFMShardedTrainer, FMShardedTrainer,
                                         MCShardedTrainer, MixConfig,
                                         make_mesh)
from hivemall_tpu_torch.parallel.ffm_mix import FFMMixTrainer
from hivemall_tpu_torch.parallel.fm_mix import FMMixTrainer
from hivemall_tpu_torch.parallel.mc_mix import MulticlassMixTrainer
from hivemall_tpu_torch.parallel.mesh import Mesh, all_gather_host
from torch_cases import (ATOL, RTOL, ffm_hypers, fm_hypers, jax_ffm_numpy,
                         jax_ffm_state, jax_fm_numpy, jax_mc_numpy, mc_rules,
                         one_rank_mesh, run_ranks, scenario, warm_ffm_numpy)

SH = dict(rtol=2e-5, atol=1e-6)
MIX = dict(rtol=RTOL, atol=ATOL)
D = 1003  # the sharded cases' dims: the ceil-pad grid at n = 2 and 4


def _blocks(dims, n_blocks, seed, lead=(), batch=16, width=8, labels=None,
            fields=0):
    rng = np.random.RandomState(seed)
    shape = lead + (n_blocks, batch, width)
    idx = rng.randint(0, dims, size=shape).astype(np.int64)
    val = rng.rand(*shape).astype(np.float32)
    if labels:
        lab = rng.randint(0, labels, size=shape[:-1]).astype(np.int64)
    else:
        lab = np.sign(rng.randn(*shape[:-1])).astype(np.float32)
    out = (idx, val, lab)
    if fields:
        out += (rng.randint(0, fields, size=shape).astype(np.int64),)
    return out


def _fm_hypers():
    return fm_hypers(factors=5, classification=True,
                     eta=("invscaling", 0.1, 0.1), seed=2)


def _ffm_hypers(**kw):
    return ffm_hypers(factors=3, num_fields=8, seed=6, **kw)


def _mc_hyper(rule):
    return {"mc_arow": {"r": 0.1}, "mc_pa1": {"c": 1.0}}[rule]


# ---- the port's side (spawned ranks) ---------------------------------------

def sc_fm_mix(rank, n):
    _, th = _fm_hypers()
    tr = FMMixTrainer(th, 128, make_mesh(device="cpu"),
                      config=MixConfig(mix_every=2))
    idx, val, lab = _blocks(128, 4, seed=1, lead=(n,))
    st, loss = tr.step(tr.init(), idx[rank], val[rank], lab[rank])
    w_all = all_gather_host(st.w, tr.mesh, tr.axis)
    return {"final": fm_state_to_numpy(tr.final_state(st)),
            "loss": float(loss),
            "replicas_equal": bool((w_all == w_all[0]).all())}


def _fm_sharded(mode):
    def run(rank, n):
        _, th = _fm_hypers()
        tr = FMShardedTrainer(th, D, make_mesh(device="cpu"), mode=mode)
        idx, val, lab = _blocks(D, 3, seed=11)
        st = tr.init()
        for b in range(3):
            st, loss = tr.step(st, idx[b], val[b], lab[b])
        return {"final": fm_state_to_numpy(tr.final_state(st)),
                "loss": float(loss),
                "scores": tr.make_predict()(st, idx[0], val[0]).numpy()}
    return run


sc_fm_sharded_minibatch = _fm_sharded("minibatch")
sc_fm_sharded_scan = _fm_sharded("scan")


def sc_ffm_mix(rank, n):
    _, th = _ffm_hypers()
    tr = FFMMixTrainer(th, make_mesh(device="cpu"),
                       config=MixConfig(mix_every=2))
    idx, val, lab, fld = _blocks(th.num_features, 2, seed=3, lead=(n,),
                                 width=6, fields=8)
    st, loss = tr.step(tr.init(), idx[rank], val[rank], fld[rank], lab[rank])
    return {"final": ffm_state_to_numpy(tr.final_state(st)),
            "loss": float(loss)}


def _ffm_sharded(row_chunk):
    def run(rank, n):
        _, th = _ffm_hypers(num_features=1001, v_dims=2003)
        tr = FFMShardedTrainer(th, make_mesh(device="cpu"),
                               row_chunk=row_chunk)
        idx, val, lab, fld = _blocks(1001, 3, seed=17, width=6, fields=8,
                                     batch=32)
        st = tr.init(from_state=warm_ffm_numpy(th, seed=4))
        for b in range(3):
            st, loss = tr.step(st, idx[b], val[b], fld[b], lab[b])
        return {"final": ffm_state_to_numpy(tr.final_state(st)),
                "loss": float(loss),
                "scores": tr.make_predict()(st, idx[0], val[0],
                                            fld[0]).numpy()}
    return run


sc_ffm_sharded = _ffm_sharded(None)
sc_ffm_sharded_chunked = _ffm_sharded(16)


def _mc_mix(rule):
    def run(rank, n):
        tr = MulticlassMixTrainer(mc_rules(rule)[1], _mc_hyper(rule), 3, 128,
                                  make_mesh(device="cpu"),
                                  config=MixConfig(mix_every=2))
        idx, val, lab = _blocks(128, 4, seed=5, lead=(n,), labels=3)
        st, loss = tr.step(tr.init(), idx[rank], val[rank], lab[rank])
        return {"final": mc_state_to_numpy(tr.final_state(st)),
                "loss": float(loss), "argmin": tr.reduction == "argmin_kld"}
    return run


sc_mc_mix_arow = _mc_mix("mc_arow")
sc_mc_mix_pa1 = _mc_mix("mc_pa1")


def _mc_sharded(mode):
    def run(rank, n):
        tr = MCShardedTrainer(mc_rules("mc_arow")[1], {"r": 0.1}, 3, D,
                              make_mesh(device="cpu"), mode=mode)
        idx, val, lab = _blocks(D, 3, seed=13, batch=32, labels=3)
        st = tr.init()
        for b in range(3):
            st, loss = tr.step(st, idx[b], val[b], lab[b])
        return {"final": mc_state_to_numpy(tr.final_state(st)),
                "loss": float(loss),
                "scores": tr.make_predict()(st, idx[0], val[0]).numpy()}
    return run


sc_mc_sharded_minibatch = _mc_sharded("minibatch")
sc_mc_sharded_scan = _mc_sharded("scan")

SCENARIOS = ["sc_fm_mix", "sc_fm_sharded_minibatch", "sc_fm_sharded_scan",
             "sc_ffm_mix", "sc_ffm_sharded", "sc_ffm_sharded_chunked",
             "sc_mc_mix_arow", "sc_mc_mix_pa1", "sc_mc_sharded_minibatch",
             "sc_mc_sharded_scan"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    return {n: run_ranks("test_torch_parallel_families", SCENARIOS, n, tmp)
            for n in (2, 4)}


def _match(got, want, fields, tol, ints=("touched",)):
    for k in fields:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    for k in ints:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["step"]) == int(want["step"])


FM_FIELDS = ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v")


# ---- FM --------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_fm_mix_matches_jax(worlds, n):
    """FMMixTrainer: touch-weighted w and V, the mean of w0, lambdas
    averaged and touched unioned at the collapse, step summed."""
    got = scenario(worlds[n], "sc_fm_mix")
    jh, _ = _fm_hypers()
    tr = JFMMix(jh, 128, jmake_mesh(n), config=JMixConfig(mix_every=2))
    st, loss = tr.step(tr.init(), *_blocks(128, 4, seed=1, lead=(n,)))
    assert bool(got["replicas_equal"])
    _match(got["final"], jax_fm_numpy(tr.final_state(st)), FM_FIELDS, MIX)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["minibatch", "scan"])
def test_fm_sharded_matches_jax(worlds, mode, n):
    """FMShardedTrainer (the FM feature_shard hook): the unpadded model,
    the loss and scores served from the trained stripes."""
    got = scenario(worlds[n], f"sc_fm_sharded_{mode}")
    jh, _ = _fm_hypers()
    tr = JFMSh(jh, D, jmake_mesh(n), mode=mode)
    idx, val, lab = _blocks(D, 3, seed=11)
    st = tr.init()
    for b in range(3):
        st, loss = tr.step(st, idx[b], val[b], lab[b])
    _match(got["final"], jax_fm_numpy(tr.final_state(st)), FM_FIELDS, SH)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-4)
    np.testing.assert_allclose(
        got["scores"], np.asarray(tr.make_predict()(st, idx[0], val[0])),
        rtol=2e-5, atol=1e-5)


# ---- FFM -------------------------------------------------------------------

FFM_FLOATS = ("w0", "w", "z", "n", "v", "v_gg")


@pytest.mark.parametrize("n", [2, 4])
def test_ffm_mix_matches_jax(worlds, n):
    """FFMMixTrainer: touch-weighted w / z / n, the mean of V and w0, v_gg
    summed at the collapse."""
    got = scenario(worlds[n], "sc_ffm_mix")
    jh, _ = _ffm_hypers()
    tr = JFFMMix(jh, jmake_mesh(n), config=JMixConfig(mix_every=2))
    idx, val, lab, fld = _blocks(jh.num_features, 2, seed=3, lead=(n,),
                                 width=6, fields=8)
    st, loss = tr.step(tr.init(), idx, val, fld, lab)
    _match(got["final"], jax_ffm_numpy(tr.final_state(st)), FFM_FLOATS, MIX)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("chunked", [False, True])
def test_ffm_sharded_matches_jax(worlds, chunked, n):
    """FFMShardedTrainer from one warm state: owner-gathered pair blocks
    summed in one all_reduce a block (a chunk with row_chunk), the
    unpadded model, the loss and served scores."""
    got = scenario(worlds[n], "sc_ffm_sharded_chunked" if chunked
                   else "sc_ffm_sharded")
    jh, th = _ffm_hypers(num_features=1001, v_dims=2003)
    tr = JFFMSh(jh, jmake_mesh(n), row_chunk=16 if chunked else None)
    idx, val, lab, fld = _blocks(1001, 3, seed=17, width=6, fields=8,
                                 batch=32)
    st = tr.init(from_state=jax_ffm_state(warm_ffm_numpy(th, seed=4)))
    for b in range(3):
        st, loss = tr.step(st, idx[b], val[b], fld[b], lab[b])
    _match(got["final"], jax_ffm_numpy(tr.final_state(st)), FFM_FLOATS, SH)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-4)
    np.testing.assert_allclose(
        got["scores"],
        np.asarray(tr.make_predict()(st, idx[0], val[0], fld[0])),
        rtol=2e-5, atol=1e-5)


# ---- multiclass ------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("rule", ["mc_arow", "mc_pa1"])
def test_mc_mix_matches_jax(worlds, rule, n):
    """MulticlassMixTrainer: argminKLD for a covariance rule, the
    touch-weighted average otherwise, over the stacked [L, D] tables."""
    got = scenario(worlds[n], f"sc_{rule.replace('mc_', 'mc_mix_')}")
    tr = JMCMix(mc_rules(rule)[0], _mc_hyper(rule), 3, 128, jmake_mesh(n),
                config=JMixConfig(mix_every=2))
    st, loss = tr.step(tr.init(), *_blocks(128, 4, seed=5, lead=(n,),
                                           labels=3))
    assert bool(got["argmin"]) == (rule == "mc_arow")
    want = jax_mc_numpy(tr.final_state(st))
    _match(got["final"], want,
           ("weights",) + (("covars",) if rule == "mc_arow" else ()), MIX)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["minibatch", "scan"])
def test_mc_sharded_matches_jax(worlds, mode, n):
    got = scenario(worlds[n], f"sc_mc_sharded_{mode}")
    tr = JMCSh(mc_rules("mc_arow")[0], {"r": 0.1}, num_labels=3, dims=D,
               mesh=jmake_mesh(n), mode=mode)
    idx, val, lab = _blocks(D, 3, seed=13, batch=32, labels=3)
    st = tr.init()
    for b in range(3):
        st, loss = tr.step(st, idx[b], val[b], lab[b])
    _match(got["final"], jax_mc_numpy(tr.final_state(st)),
           ("weights", "covars"), SH)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-4)
    np.testing.assert_allclose(
        got["scores"], np.asarray(tr.make_predict()(st, idx[0], val[0])),
        rtol=2e-5, atol=1e-5)


def test_mc_collapse_merges_slots_per_slot_merge():
    """The multiclass collapse merges optimizer slots per MCRule.slot_merge
    (sum / touch-weighted mean), not replica 0's: the JAX package's
    test_mc_final_state_merges_slots, on the port's host collapse."""
    import torch

    from hivemall_tpu.models.multiclass import MC_AROW as J_AROW
    from hivemall_tpu.models.multiclass import MCRule as JMCRule
    from hivemall_tpu_torch.models.multiclass import MC_AROW, MCRule

    kinds = (("gg", "sum"), ("ema", "mean"))
    rule = MCRule("arow_slotted", MC_AROW.compute, MC_AROW.cov_kind,
                  slot_merge=kinds)
    mesh = Mesh(("workers",), {"workers": 8}, {"workers": 0}, {},
                torch.device("cpu"))
    tr = MulticlassMixTrainer(rule, {"r": 0.1}, 3, 128, mesh)
    rng = np.random.RandomState(11)
    touched = (rng.rand(8, 3, 128) < 0.5).astype(np.int8)
    gg = rng.rand(8, 3, 128).astype(np.float32)
    ema = rng.rand(8, 3, 128).astype(np.float32)
    host = {"weights": rng.rand(8, 3, 128).astype(np.float32),
            "covars": rng.rand(8, 3, 128).astype(np.float32),
            "touched": touched, "step": np.full(8, 7),
            "slots": {"gg": gg, "ema": ema}}
    got = tr.collapse_host(host)
    jtr = JMCMix(JMCRule("arow_slotted", J_AROW.compute, J_AROW.cov_kind,
                         slot_merge=kinds), {"r": 0.1}, num_labels=3,
                 dims=128, mesh=jmake_mesh(8))
    want = jtr.final_state(jtr.init().replace(
        weights=host["weights"], covars=host["covars"], touched=touched,
        step=host["step"].astype(np.int32), slots={"gg": gg, "ema": ema}))
    for k in ("gg", "ema"):
        np.testing.assert_allclose(got["slots"][k], want.slots[k], rtol=1e-6)
    np.testing.assert_array_equal(got["touched"], want.touched)
    assert got["step"] == int(want.step)


def test_lifted_refusals_run_at_world_one():
    """FM's, FFM's and multiclass' feature_shard, refused before this
    slice, now run: at world size 1 one stripe is the whole model, equal
    to the unsharded step."""
    import torch

    from hivemall_tpu_torch.models import ffm as TFF
    from hivemall_tpu_torch.models import fm as TF
    from hivemall_tpu_torch.models import multiclass as TMC

    _, fh = _fm_hypers()
    _, ffh = _ffm_hypers()
    idx, val, lab, fld = _blocks(ffh.num_features, 1, seed=0, fields=8)
    with one_rank_mesh() as mesh:
        for shard in (None, (mesh, "workers", 1 << 10)):
            st = TF.init_fm_state(1 << 10, fh, device="cpu")
            st, fl = TF.make_fm_step(fh, feature_shard=shard, device="cpu")(
                st, idx[0], val[0], lab[0], np.zeros(16, np.float32))
            ffst = TFF.init_ffm_state(ffh, device="cpu")
            ff_shard = None if shard is None else shard + (ffh.v_dims,)
            ffst, ffl = TFF.make_ffm_step(
                ffh, "minibatch", device="cpu", feature_shard=ff_shard)(
                    ffst, idx[0], val[0], fld[0], lab[0])
            mst = TMC.init_mc_state(3, 1 << 10, True, device="cpu")
            mst, ml = TMC.make_mc_train_step(
                mc_rules("mc_arow")[1], {"r": 0.1}, "minibatch",
                feature_shard=shard, device="cpu")(
                    mst, idx[0], val[0], np.abs(lab[0]).astype(int) % 3)
            if shard is None:
                ref = (fm_state_to_numpy(st), ffm_state_to_numpy(ffst),
                       mc_state_to_numpy(mst), [fl, ffl, ml])
                continue
            _match(fm_state_to_numpy(st), ref[0], FM_FIELDS, SH)
            _match(ffm_state_to_numpy(ffst), ref[1], FFM_FLOATS, SH)
            _match(mc_state_to_numpy(mst), ref[2], ("weights", "covars"), SH)
            torch.testing.assert_close(torch.stack([fl, ffl, ml]),
                                       torch.stack(ref[3]), rtol=1e-5,
                                       atol=1e-6)
