"""The port's feature-sharded trainers (hivemall_tpu_torch/parallel/
sharded_train.py ShardedTrainer and Sharded2DTrainer) against the JAX
package's on its simulated CPU mesh.

The port side runs in n gloo ranks on the CPU (tests/torch_cases.py
run_ranks), the JAX side on make_mesh(n) / make_mesh_2d(R, S) with the same
numpy blocks. Float leaves agree within the sharded reference tolerance,
rtol 2e-5 / atol 1e-6 (tests/test_sharded_train.py; the row partials are
summed in gloo's order instead of XLA's); `touched` and `step` are exact.
dims 1003 exercises the ceil-pad stripe grid (stripe 502 at n = 2, 251 at
n = 4 and on the 2 x 2 mesh's stripes).
"""

import jax
import numpy as np
import pytest
import torch.distributed as dist

from hivemall_tpu.parallel import MixConfig as JMixConfig
from hivemall_tpu.parallel import make_mesh as jmake_mesh
from hivemall_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from hivemall_tpu.parallel.sharded_train import Sharded2DTrainer as JS2D
from hivemall_tpu.parallel.sharded_train import ShardedTrainer as JSharded
from hivemall_tpu_torch.core.engine import make_train_fn
from hivemall_tpu_torch.core.state import (init_linear_state,
                                           linear_state_to_numpy)
from hivemall_tpu_torch.parallel import (MixConfig, Sharded2DTrainer,
                                         ShardedTrainer, make_mesh,
                                         make_mesh_2d)
from torch_cases import (JAX_RULES, PORT_RULES, assert_linear_host_match,
                         jax_linear_numpy, one_rank_mesh, padded_to_stripes,
                         run_ranks, scenario, stripes_to_padded)

TOL = dict(rtol=2e-5, atol=1e-6)
HYPER = {"arow": {"r": 0.1}, "pa": {}, "perceptron": {},
         "adagrad_rda": {"eta": 0.1, "lambda": 1e-6, "scale": 100.0},
         "adagrad_regr": {"eta": 1.0, "eps": 1.0, "scale": 100.0}}
DIMS = {"arow": 1003, "pa": 1 << 10, "adagrad_rda": 1 << 10,
        "adagrad_regr": 1 << 10}
D2 = 1003


def _blocks(dims, n_blocks, seed, batch=16, width=8, regression=False,
            lead=()):
    rng = np.random.RandomState(seed)
    shape = lead + (n_blocks, batch, width)
    idx = rng.randint(0, dims, size=shape).astype(np.int64)
    val = rng.rand(*shape).astype(np.float32)
    lab = (rng.rand(*shape[:-1]) if regression
           else np.sign(rng.randn(*shape[:-1]))).astype(np.float32)
    return idx, val, lab


def _case_blocks(rule):
    return _blocks(DIMS[rule], 3, seed=len(rule),
                   regression=rule == "adagrad_regr")


LINEAR = [(r, m) for r in DIMS for m in ("minibatch", "scan")]


def _sharded_case(rule, mode):
    def run(rank, n):
        tr = ShardedTrainer(PORT_RULES[rule], HYPER[rule], DIMS[rule],
                            make_mesh(device="cpu"), mode=mode)
        idx, val, lab = _case_blocks(rule)
        st = tr.init()
        assert st.weights.shape[0] == tr.stripe
        for i in range(idx.shape[0]):
            st, loss = tr.step(st, idx[i], val[i], lab[i])
        scores = tr.make_predict()(st, idx[0, :8], val[0, :8]).numpy()
        stripes = [None] * n
        dist.all_gather_object(stripes, linear_state_to_numpy(st))
        return {"final": linear_state_to_numpy(tr.final_state(st)),
                "loss": float(loss), "scores": scores,
                "stripes": {f"r{i}": s for i, s in enumerate(stripes)}}
    return run


for _r, _m in LINEAR:
    globals()[f"sc_{_r}_{_m}"] = _sharded_case(_r, _m)


def sc_warm_start(rank, n):
    init_w = np.zeros(1003, np.float32)
    init_w[::97] = 1.5
    tr = ShardedTrainer(PORT_RULES["perceptron"], {}, 1003,
                        make_mesh(device="cpu"))
    return {"final": linear_state_to_numpy(
        tr.final_state(tr.init(initial_weights=init_w)))}


def sc_resume(rank, n):
    """Train, collapse, re-stripe the collapsed model onto a new trainer
    (the elastic resume), train on."""
    mesh = make_mesh(device="cpu")
    rule = PORT_RULES["adagrad_regr"]
    idx, val, lab = _blocks(1003, 3, seed=8, regression=True)
    tr = ShardedTrainer(rule, HYPER["adagrad_regr"], 1003, mesh)
    st = tr.init()
    for i in range(2):
        st, _ = tr.step(st, idx[i], val[i], lab[i])
    first = tr.final_state(st)
    tr2 = ShardedTrainer(rule, HYPER["adagrad_regr"], 1003, mesh)
    st, _ = tr2.step(tr2.init(from_state=first), idx[2], val[2], lab[2])
    return {"final": linear_state_to_numpy(tr2.final_state(st))}


def _two_d(rule, r, s, every, k, tag):
    def run(rank, n):
        mesh = make_mesh_2d(r, s, device="cpu")
        try:
            tr = Sharded2DTrainer(PORT_RULES[rule], HYPER[rule], D2, mesh,
                                  config=MixConfig(mix_every=every))
            idx, val, lab = _blocks(D2, k, seed=3, lead=(r,))
            mine = tr.shard_blocks(*(a.reshape((r * k,) + a.shape[2:])
                                     for a in (idx, val, lab)))
            st, loss = tr.step(tr.init(), *mine)
            q = tr.make_predict()(st, idx[0, 0, :4], val[0, 0, :4]).numpy()
            return {"final": linear_state_to_numpy(tr.final_state(st)),
                    "loss": float(loss), "scores": q,
                    "stripe": tr.stripe}
        finally:
            mesh.destroy()
    return run


TWO_D = {"2x2_arow": ("arow", 2, 2, 2, 4),
         "2x2_perceptron": ("perceptron", 2, 2, 2, 4),
         "1x2_arow": ("arow", 1, 2, 2, 4), "2x1_arow": ("arow", 2, 1, 2, 4)}
for _tag, (_rule, _r, _s, _e, _k) in TWO_D.items():
    globals()[f"sc_2d_{_tag}"] = _two_d(_rule, _r, _s, _e, _k, _tag)


def sc_2d_resume(rank, n):
    """2 x 2: collapse, resume every replica from the collapsed model on a
    new trainer, train on; the seed's sum slots and step count once."""
    mesh = make_mesh_2d(2, 2, device="cpu")
    try:
        rule = PORT_RULES["adagrad_regr"]
        idx, val, lab = _blocks(D2, 2, seed=12, regression=True, lead=(2,))
        r = mesh.index("workers")
        tr = Sharded2DTrainer(rule, HYPER["adagrad_regr"], D2, mesh)
        st, _ = tr.step(tr.init(), idx[r, :1], val[r, :1], lab[r, :1])
        first = tr.final_state(st)
        tr2 = Sharded2DTrainer(rule, HYPER["adagrad_regr"], D2, mesh)
        st, _ = tr2.step(tr2.init(from_state=first), idx[r, 1:],
                         val[r, 1:], lab[r, 1:])
        return {"final": linear_state_to_numpy(tr2.final_state(st))}
    finally:
        mesh.destroy()


WORLD = {2: [f"sc_{r}_{m}" for r, m in LINEAR]
         + ["sc_warm_start", "sc_resume", "sc_2d_1x2_arow", "sc_2d_2x1_arow"],
         4: [f"sc_{r}_{m}" for r, m in LINEAR]
         + ["sc_resume", "sc_2d_2x2_arow", "sc_2d_2x2_perceptron",
            "sc_2d_resume"]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    return {n: run_ranks("test_torch_sharded_train", names, n, tmp)
            for n, names in WORLD.items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("rule,mode", LINEAR)
def test_sharded_parity_with_jax(worlds, rule, mode, n):
    """ShardedTrainer over n ranks == JAX's ShardedTrainer on n devices:
    the unpadded final model (weights, covariances, slots, touched, step),
    the last block's loss, and scores served from the trained stripes."""
    got = scenario(worlds[n], f"sc_{rule}_{mode}")
    idx, val, lab = _case_blocks(rule)
    tr = JSharded(JAX_RULES[rule], HYPER[rule], DIMS[rule], jmake_mesh(n),
                  mode=mode)
    st = tr.init()
    for i in range(idx.shape[0]):
        st, loss = tr.step(st, idx[i], val[i], lab[i])
    want = jax_linear_numpy(tr.final_state(st))
    assert got["final"]["weights"].shape == (DIMS[rule],)
    assert_linear_host_match(got["final"], want, **TOL)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-4)
    served = (want["weights"][idx[0, :8]] * val[0, :8]).sum(axis=-1)
    np.testing.assert_allclose(got["scores"], served, **TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("rule", ["arow", "adagrad_rda"])
def test_stripes_match_jax_padded_state(worlds, rule, n):
    """Every rank's stripe (padding slots included) == its slice of JAX's
    padded, striped state, carried both ways: the port's stripes joined
    into JAX's padded tables, and JAX's tables cut into stripes."""
    got = scenario(worlds[n], f"sc_{rule}_minibatch")["stripes"]
    stripes = [got[f"r{r}"] for r in range(n)]
    idx, val, lab = _case_blocks(rule)
    tr = JSharded(JAX_RULES[rule], HYPER[rule], DIMS[rule], jmake_mesh(n))
    st = tr.init()
    for i in range(idx.shape[0]):
        st, _ = tr.step(st, idx[i], val[i], lab[i])
    padded = jax_linear_numpy(jax.device_get(st))
    assert padded["weights"].shape == (tr.dims_padded,)
    fields = ["weights", "touched"] + (["covars"] if rule == "arow" else [])
    for f in fields:
        np.testing.assert_allclose(
            stripes_to_padded([s[f] for s in stripes]), padded[f], **TOL)
        for r, part in enumerate(padded_to_stripes(padded[f], n)):
            np.testing.assert_allclose(stripes[r][f], part, **TOL)
    for k in padded["slots"]:
        np.testing.assert_allclose(
            stripes_to_padded([s["slots"][k] for s in stripes]),
            padded["slots"][k], **TOL)


def test_warm_start_lands_in_the_stripes(worlds):
    init_w = np.zeros(1003, np.float32)
    init_w[::97] = 1.5
    final = scenario(worlds[2], "sc_warm_start")["final"]
    np.testing.assert_array_equal(final["weights"], init_w)
    np.testing.assert_array_equal(final["touched"], init_w != 0)


@pytest.mark.parametrize("n", [2, 4])
def test_resume_from_collapsed_state_matches_jax(worlds, n):
    """init(from_state=...) re-stripes a collapsed model with its AdaGrad
    accumulator and step onto the mesh, as JAX's restripe does."""
    got = scenario(worlds[n], "sc_resume")["final"]
    rule = JAX_RULES["adagrad_regr"]
    idx, val, lab = _blocks(1003, 3, seed=8, regression=True)
    tr = JSharded(rule, HYPER["adagrad_regr"], 1003, jmake_mesh(n))
    st = tr.init()
    for i in range(2):
        st, _ = tr.step(st, idx[i], val[i], lab[i])
    tr2 = JSharded(rule, HYPER["adagrad_regr"], 1003, jmake_mesh(n))
    st, _ = tr2.step(tr2.init(from_state=tr.final_state(st)), idx[2],
                     val[2], lab[2])
    assert_linear_host_match(got, jax_linear_numpy(tr2.final_state(st)),
                             **TOL)


@pytest.mark.parametrize("tag", list(TWO_D))
def test_2d_parity_with_jax(worlds, tag):
    """Sharded2DTrainer (replicas x stripes) == JAX's on the same 2-D mesh
    shape: collapsed, unpadded model, loss summed over the replicas, and
    replica scores served from its stripes."""
    rule, r, s, every, k = TWO_D[tag]
    got = scenario(worlds[r * s], f"sc_2d_{tag}")
    idx, val, lab = _blocks(D2, k, seed=3, lead=(r,))
    tr = JS2D(JAX_RULES[rule], HYPER[rule], D2, jmake_mesh_2d(r, s),
              config=JMixConfig(mix_every=every))
    st, loss = tr.step(tr.init(), idx, val, lab)
    want = jax_linear_numpy(tr.final_state(st))
    assert int(got["stripe"]) == tr.stripe
    assert_linear_host_match(got["final"], want, **TOL)
    assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-4)
    served = (want["weights"][idx[0, 0, :4]] * val[0, 0, :4]).sum(axis=-1)
    np.testing.assert_allclose(got["scores"], served, **TOL)


def test_2d_resume_matches_jax(worlds):
    got = scenario(worlds[4], "sc_2d_resume")["final"]
    rule = JAX_RULES["adagrad_regr"]
    idx, val, lab = _blocks(D2, 2, seed=12, regression=True, lead=(2,))
    tr = JS2D(rule, HYPER["adagrad_regr"], D2, jmake_mesh_2d(2, 2))
    st, _ = tr.step(tr.init(), idx[:, :1], val[:, :1], lab[:, :1])
    tr2 = JS2D(rule, HYPER["adagrad_regr"], D2, jmake_mesh_2d(2, 2))
    st, _ = tr2.step(tr2.init(from_state=tr.final_state(st)), idx[:, 1:],
                     val[:, 1:], lab[:, 1:])
    assert_linear_host_match(got, jax_linear_numpy(tr2.final_state(st)),
                             **TOL)


@pytest.mark.parametrize("mode", ["minibatch", "scan"])
def test_world_of_one_matches_the_single_device_engine(mode):
    """One stripe is the whole model: the sharded step at world size 1 is
    the single-rank engine's, to a tolerance."""
    idx, val, lab = _case_blocks("arow")
    with one_rank_mesh() as mesh:
        tr = ShardedTrainer(PORT_RULES["arow"], {"r": 0.1}, 1003, mesh,
                            mode=mode)
        st = tr.init()
        for i in range(3):
            st, loss = tr.step(st, idx[i], val[i], lab[i])
        got = linear_state_to_numpy(tr.final_state(st))
    fn = make_train_fn(PORT_RULES["arow"], {"r": 0.1}, mode=mode,
                       device="cpu")
    ref = init_linear_state(1003, use_covariance=True, device="cpu")
    for i in range(3):
        ref, ref_loss = fn(ref, idx[i], val[i], lab[i])
    assert_linear_host_match(got, linear_state_to_numpy(ref), **TOL)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)


def test_sharded_step_counts_one_collective_a_row():
    """Scan mode sums each row's partials in its own all_reduce ([3]
    floats for a covariance rule), as JAX's psum inside lax.scan; a
    minibatch block sums all of them in one ([3, B])."""
    idx, val, lab = _case_blocks("arow")
    with one_rank_mesh() as mesh:
        for mode, calls, nbytes in (("scan", 16, 16 * 3 * 4),
                                    ("minibatch", 1, 3 * 16 * 4)):
            tr = ShardedTrainer(PORT_RULES["arow"], {"r": 0.1}, 1003, mesh,
                                mode=mode)
            st = tr.init()
            mesh.stats.reset()
            tr.step(st, idx[0], val[0], lab[0])
            assert (mesh.stats.calls, mesh.stats.bytes) == (calls, nbytes)


def test_striping_helpers_match_jax():
    """stripe_grid, restripe_array and translate_to_stripe against the JAX
    package's (its translate reads the device index from the mesh; here
    the rank is an argument), and stripe_of as the JAX placement's slice."""
    import torch

    from hivemall_tpu.core import striping as JS
    from hivemall_tpu_torch.core import striping as TS

    for dims, n, align in ((1003, 4, 1), (1 << 10, 2, 1), (1000, 3, 64),
                           (7, 8, 1)):
        assert TS.stripe_grid(dims, n, align) == JS.stripe_grid(dims, n,
                                                                 align)
    with pytest.raises(ValueError):
        TS.stripe_grid(10, 0)
    rng = np.random.RandomState(0)
    table = rng.rand(3, 1004).astype(np.float32)
    for fill in (0.0, 1.0):
        np.testing.assert_array_equal(
            TS.restripe_array(table, 1, 1003, 1005, fill),
            JS.restripe_array(table, 1, 1003, 1005, fill))
    stripe, padded = TS.stripe_grid(1003, 4)
    full = TS.restripe_array(table, 1, 1003, padded, 1.0)
    for r in range(4):
        np.testing.assert_array_equal(
            TS.stripe_of(table, 1, 1003, stripe, r, 1.0),
            full[:, r * stripe:(r + 1) * stripe])
    idx = torch.from_numpy(rng.randint(0, 1004, (6, 5)))
    val = torch.from_numpy(rng.rand(6, 5).astype(np.float32))
    for r in range(4):
        lidx, vmask = TS.translate_to_stripe(idx, val, r, stripe)
        owned = (idx >= r * stripe) & (idx < (r + 1) * stripe)
        assert torch.equal(lidx, torch.where(owned, idx - r * stripe,
                                             stripe))
        assert torch.equal(vmask, val * owned)


def test_sharded_scoring_at_world_one():
    """shard_weights + make_sharded_predict serve a host table; pmean of a
    one-rank axis is the value itself."""
    import torch

    from hivemall_tpu_torch.parallel.mesh import pmean
    from hivemall_tpu_torch.parallel.sharded import (make_sharded_predict,
                                                     shard_weights)

    rng = np.random.RandomState(1)
    w = rng.randn(256).astype(np.float32)
    idx = rng.randint(0, 257, (10, 6))  # 256: a pad lane
    val = rng.rand(10, 6).astype(np.float32)
    with one_rank_mesh() as mesh:
        got = make_sharded_predict(mesh, 256)(shard_weights(w, mesh), idx,
                                              val)
        x = torch.arange(4.0)
        assert torch.equal(pmean(x.clone(), mesh, "workers"), x)
    want = np.where(idx < 256, np.append(w, 0.0)[idx], 0.0) * val
    np.testing.assert_allclose(got.numpy(), want.sum(axis=1), rtol=1e-6,
                               atol=1e-6)
