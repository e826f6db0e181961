"""The port's data-parallel MixTrainer (hivemall_tpu_torch/parallel/mix.py)
against the JAX package's on its simulated CPU mesh.

The port side runs in n gloo ranks on the CPU (tests/torch_cases.py
run_ranks: one spawn a world, every scenario in it); the JAX side runs the
same numpy blocks through JAX's MixTrainer on make_mesh(n). Float leaves
agree within rtol 1e-5 / atol 1e-6 (RTOL / ATOL: gloo's ring and XLA's CPU
psum add in different orders); `touched`, the delta counter and `step` are
exact. Port-against-port checks (mix_every grouping) hold JAX's own
test_mix_semantics tolerance, rtol 1e-5 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

from hivemall_tpu.parallel import MixConfig as JMixConfig
from hivemall_tpu.parallel import MixTrainer as JMixTrainer
from hivemall_tpu.parallel import make_mesh as jmake_mesh
from hivemall_tpu_torch.core.engine import DELTA_SLOT, make_train_fn
from hivemall_tpu_torch.core.state import (init_linear_state,
                                           linear_state_to_numpy)
from hivemall_tpu_torch.parallel import MixConfig, MixTrainer, make_mesh
from hivemall_tpu_torch.parallel.mesh import all_gather_host
from torch_cases import (ATOL, JAX_RULES, PORT_RULES, RTOL,
                         assert_linear_host_match, jax_linear_numpy,
                         jax_replica, one_rank_mesh, replicas_to_jax,
                         run_ranks, scenario)

DIMS = 128
HYPER = {"arow": {"r": 0.1}, "perceptron": {},
         "adagrad_regr": {"eta": 1.0, "eps": 1.0, "scale": 100.0},
         "adadelta_regr": {"rho": 0.95, "eps": 1e-6, "scale": 100.0},
         "pa1a_regr": {"c": 1.0, "epsilon": 0.1}}


def _blocks(n, k, seed=0, dims=DIMS, batch=16, width=8, regression=False):
    """[n, k, B, K] global blocks (replica r trains blocks[r])."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, dims, size=(n, k, batch, width)).astype(np.int64)
    val = rng.rand(n, k, batch, width).astype(np.float32)
    lab = (rng.rand(n, k, batch) if regression
           else np.sign(rng.randn(n, k, batch))).astype(np.float32)
    return idx, val, lab


# scenario name -> (rule, mix_every, k, data seed, regression, reduction)
CASES = {
    "average_perceptron": ("perceptron", 1, 2, 0, False, "average"),
    "argmin_arow": ("arow", 2, 4, 5, False, "auto"),
    "grouped_arow": ("arow", 3, 6, 6, False, "auto"),
    "adagrad_sum": ("adagrad_regr", 1, 2, 0, True, "auto"),
    "adadelta_mean": ("adadelta_regr", 1, 2, 2, True, "auto"),
    "welford": ("pa1a_regr", 1, 2, 3, True, "auto"),
}


def _port_run(name, rank, n):
    rule, every, k, seed, regr, red = CASES[name]
    mesh = make_mesh(device="cpu")
    tr = MixTrainer(PORT_RULES[rule], HYPER[rule], DIMS, mesh,
                    MixConfig(mix_every=every, reduction=red))
    idx, val, lab = _blocks(n, k, seed, regression=regr)
    st, loss = tr.step(tr.init(), idx[rank], val[rank], lab[rank])
    return tr, st, loss


def _port_final(name):
    def run(rank, n):
        tr, st, loss = _port_run(name, rank, n)
        w_all = all_gather_host(st.weights, tr.mesh, tr.axis)
        replicas = [None] * n
        torch.distributed.all_gather_object(replicas,
                                            linear_state_to_numpy(st))
        return {"final": linear_state_to_numpy(tr.final_state(st)),
                "loss": float(loss), "reduction": tr.reduction == "argmin_kld",
                "replicas_equal": bool((w_all == w_all[0]).all()),
                "replicas": {f"r{i}": r for i, r in enumerate(replicas)}}
    return run


for _name in CASES:
    globals()[f"sc_{_name}"] = _port_final(_name)


def sc_grouped_manual(rank, n):
    """The grouped case trained as m calls of mix_every blocks."""
    rule, every, k, seed, regr, red = CASES["grouped_arow"]
    tr = MixTrainer(PORT_RULES[rule], HYPER[rule], DIMS,
                    make_mesh(device="cpu"), MixConfig(mix_every=every))
    idx, val, lab = _blocks(n, k, seed, regression=regr)
    st = tr.init()
    for g in range(0, k, every):
        sl = slice(g, g + every)
        st, _ = tr.step(st, idx[rank, sl], val[rank, sl], lab[rank, sl])
    return {"final": linear_state_to_numpy(tr.final_state(st))}


def sc_divide(rank, n):
    tr = MixTrainer(PORT_RULES["perceptron"], {}, DIMS,
                    make_mesh(device="cpu"), MixConfig(mix_every=4))
    idx, val, lab = _blocks(n, 6)
    with pytest.raises(ValueError, match="mix_every"):
        tr.step(tr.init(), idx[rank], val[rank], lab[rank])
    return {"raised": 1}


def sc_untouched(rank, n):
    """Rows only touch features 0..3: the rest keep their local value."""
    rng = np.random.RandomState(rank)
    idx = np.tile(np.arange(4), (2, 8, 1))
    val = rng.randn(2, 8, 4).astype(np.float32)
    lab = np.sign(val[..., 0]).astype(np.float32)
    tr = MixTrainer(PORT_RULES["perceptron"], {}, 32, make_mesh(device="cpu"),
                    MixConfig(reduction="average"))
    st, _ = tr.step(tr.init(), idx, val, lab)
    return {"final": linear_state_to_numpy(tr.final_state(st))}


def sc_manual_average(rank, n):
    """One mixed step against the delta-weighted average of the replicas
    trained alone (the single-rank engine), PartialAverage's formula."""
    idx, val, lab = _blocks(n, 1, seed=1)
    fn = make_train_fn(PORT_RULES["perceptron"], {}, track_deltas=True,
                       device="cpu")
    alone = init_linear_state(DIMS, slot_names=(DELTA_SLOT,), device="cpu")
    alone, _ = fn(alone, idx[rank, 0], val[rank, 0], lab[rank, 0])
    mesh = make_mesh(device="cpu")
    w = all_gather_host(alone.weights, mesh, "workers")
    d = all_gather_host(alone.slots[DELTA_SLOT], mesh, "workers")
    tot = d.sum(axis=0)
    want = np.where(tot > 0, (w * d).sum(axis=0) / np.maximum(tot, 1), w[0])
    tr = MixTrainer(PORT_RULES["perceptron"], {}, DIMS, mesh,
                    MixConfig(reduction="average"))
    st, _ = tr.step(tr.init(), idx[rank], val[rank], lab[rank])
    return {"mixed": st.weights.numpy(), "want": want}


def _restart(rule):
    def run(rank, n):
        """Train, collapse, resume every replica from the collapsed model,
        train on, collapse again (the elastic warm restart)."""
        mesh = make_mesh(device="cpu")
        idx, val, lab = _blocks(n, 4, seed=9, regression=True)
        tr = MixTrainer(PORT_RULES[rule], HYPER[rule], DIMS, mesh)
        st, _ = tr.step(tr.init(), idx[rank, :2], val[rank, :2],
                        lab[rank, :2])
        first = tr.final_state(st)
        tr2 = MixTrainer(PORT_RULES[rule], HYPER[rule], DIMS, mesh)
        st, _ = tr2.step(tr2.init(from_state=first), idx[rank, 2:],
                         val[rank, 2:], lab[rank, 2:])
        return {"first": linear_state_to_numpy(first),
                "final": linear_state_to_numpy(tr2.final_state(st))}
    return run


sc_restart_adagrad = _restart("adagrad_regr")
sc_restart_welford = _restart("pa1a_regr")

SCENARIOS = [f"sc_{c}" for c in CASES] + [
    "sc_grouped_manual", "sc_divide", "sc_untouched", "sc_manual_average",
    "sc_restart_adagrad", "sc_restart_welford"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mix")
    return {n: run_ranks("test_torch_mix", SCENARIOS, n, tmp)
            for n in (2, 4)}


def _jax_trainer(name, n):
    rule, every, k, seed, regr, red = CASES[name]
    return JMixTrainer(JAX_RULES[rule], HYPER[rule], DIMS, jmake_mesh(n),
                       JMixConfig(mix_every=every, reduction=red))


def _jax_final(name, n):
    rule, every, k, seed, regr, red = CASES[name]
    tr = _jax_trainer(name, n)
    st, loss = tr.step(tr.init(), *_blocks(n, k, seed, regression=regr))
    return jax_linear_numpy(tr.final_state(st)), float(loss), tr


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_mix_final_state_matches_jax(worlds, name, n):
    """MixTrainer over n gloo ranks == JAX's MixTrainer on n CPU devices:
    the collapsed model (trailing-mix weights / covariances, touched
    union, merged slots and Welford globals, summed step) and the loss
    summed over the replicas."""
    got = scenario(worlds[n], f"sc_{name}")
    want, want_loss, jtr = _jax_final(name, n)
    assert bool(got["reduction"]) == (jtr.reduction == "argmin_kld")
    assert bool(got["replicas_equal"])
    assert_linear_host_match(got["final"], want)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["argmin_arow", "adagrad_sum"])
def test_replicas_match_jax_replicated_state(worlds, name, n):
    """Every rank's replica after the trailing mix (slots, touched, step
    and globals still per replica) == the JAX state's replica of that
    index, carried both ways: the port's per-rank states stacked into
    JAX's [n_dev, ...] layout, and JAX's layout cut per rank."""
    got = scenario(worlds[n], f"sc_{name}")["replicas"]
    per_rank = [got[f"r{r}"] for r in range(n)]
    rule, every, k, seed, regr, red = CASES[name]
    tr = _jax_trainer(name, n)
    st, _ = tr.step(tr.init(), *_blocks(n, k, seed, regression=regr))
    host = jax_linear_numpy(st)
    assert_linear_host_match(replicas_to_jax(per_rank), host)
    for r in range(n):
        assert_linear_host_match(per_rank[r], jax_replica(host, r))


@pytest.mark.parametrize("n", [2, 4])
def test_argmin_kld_shrinks_covariance(worlds, n):
    """argminKLD replaces a feature's covariance by 1/sum(1/cov) over the
    replicas: below every replica's own where all of them updated it."""
    got = scenario(worlds[n], "sc_argmin_arow")["final"]
    cov, touched = got["covars"], got["touched"] > 0
    assert np.all(cov[touched] < 1.0)
    assert np.all(cov[~touched] == 1.0)


@pytest.mark.parametrize("n", [2, 4])
def test_untouched_features_keep_local_value(worlds, n):
    got = scenario(worlds[n], "sc_untouched")
    final = got["final"]
    np.testing.assert_allclose(final["weights"][4:], 0.0)
    assert final["touched"][4:].sum() == 0
    assert final["touched"][:4].all()


@pytest.mark.parametrize("n", [2, 4])
def test_mix_every_k_equals_manual_mixes(worlds, n):
    """One step over k * m blocks with mix_every = k == m steps of k blocks
    (each ends in a mix), in the port; and the grouped run == JAX's."""
    grouped = scenario(worlds[n], "sc_grouped_arow")["final"]
    manual = scenario(worlds[n], "sc_grouped_manual")["final"]
    assert_linear_host_match(grouped, manual, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_mix_every_must_divide_blocks(worlds, n):
    assert int(scenario(worlds[n], "sc_divide")["raised"]) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_mix_matches_manual_average(worlds, n):
    got = scenario(worlds[n], "sc_manual_average")
    np.testing.assert_allclose(got["mixed"], got["want"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_final_state_sums_adagrad_accumulator(worlds, n):
    """AdaGrad's accumulator merges by SUM over the replicas that touched
    a feature (Rule.slot_merge), the delta counter resets, step sums."""
    got = scenario(worlds[n], "sc_adagrad_sum")["final"]
    jtr = _jax_trainer("adagrad_sum", n)
    st, _ = jtr.step(jtr.init(), *_blocks(n, 2, 0, regression=True))
    host = jax_linear_numpy(st)
    tmask = host["touched"].astype(np.float32)
    np.testing.assert_allclose(got["slots"]["sum_sqgrad"],
                               (host["slots"]["sum_sqgrad"] * tmask)
                               .sum(axis=0), rtol=RTOL, atol=ATOL)
    assert np.all(got["slots"][DELTA_SLOT] == 0.0)
    assert int(got["step"]) == int(host["step"].sum())


@pytest.mark.parametrize("n", [2, 4])
def test_final_state_means_adadelta_ema(worlds, n):
    got = scenario(worlds[n], "sc_adadelta_mean")["final"]
    jtr = _jax_trainer("adadelta_mean", n)
    st, _ = jtr.step(jtr.init(), *_blocks(n, 2, 2, regression=True))
    host = jax_linear_numpy(st)
    tmask = host["touched"].astype(np.float32)
    for name in ("sum_sqgrad", "sum_sq_dx"):
        want = (host["slots"][name] * tmask).sum(axis=0) \
            / np.maximum(tmask.sum(axis=0), 1.0)
        np.testing.assert_allclose(got["slots"][name], want, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_final_state_merges_welford_globals(worlds, n):
    """The merged (n, mean, m2) is the single-stream Welford over every
    replica's labels (Chan's parallel merge)."""
    got = scenario(worlds[n], "sc_welford")["final"]["globals"]
    labels = _blocks(n, 2, 3, regression=True)[2].reshape(-1) \
        .astype(np.float64)
    assert float(got["n"]) == pytest.approx(labels.size)
    assert float(got["mean"]) == pytest.approx(labels.mean(), rel=1e-5)
    assert float(got["m2"]) == pytest.approx(
        ((labels - labels.mean()) ** 2).sum(), rel=1e-4)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("rule", ["adagrad_regr", "pa1a_regr"])
def test_warm_restart_matches_jax(worlds, rule, n):
    """init(from_state=final_state) on every replica, more blocks, and a
    second collapse: the seed's additive statistics (sum slots, Welford
    globals, step) count once, as in JAX's MixTrainer."""
    name = "sc_restart_adagrad" if rule == "adagrad_regr" \
        else "sc_restart_welford"
    got = scenario(worlds[n], name)
    idx, val, lab = _blocks(n, 4, seed=9, regression=True)
    tr = JMixTrainer(JAX_RULES[rule], HYPER[rule], DIMS, jmake_mesh(n))
    st, _ = tr.step(tr.init(), idx[:, :2], val[:, :2], lab[:, :2])
    first = tr.final_state(st)
    tr2 = JMixTrainer(JAX_RULES[rule], HYPER[rule], DIMS, jmake_mesh(n))
    st, _ = tr2.step(tr2.init(from_state=first), idx[:, 2:], val[:, 2:],
                     lab[:, 2:])
    assert_linear_host_match(got["first"], jax_linear_numpy(first))
    assert_linear_host_match(got["final"],
                             jax_linear_numpy(tr2.final_state(st)))


def test_world_of_one_matches_the_single_device_engine():
    """A world of one (init_distributed with no RANK / WORLD_SIZE) mixes
    with itself: the same model as the single-rank engine, to a tolerance
    (w * d / d is not always w in float)."""
    idx, val, lab = _blocks(1, 4, seed=4)
    with one_rank_mesh() as mesh:
        tr = MixTrainer(PORT_RULES["arow"], {"r": 0.1}, DIMS, mesh,
                        MixConfig(mix_every=2, reduction="average"))
        st, loss = tr.step(tr.init(), idx[0], val[0], lab[0])
        got = linear_state_to_numpy(tr.final_state(st))
    fn = make_train_fn(PORT_RULES["arow"], {"r": 0.1}, device="cpu")
    ref = init_linear_state(DIMS, use_covariance=True, device="cpu")
    total = 0.0
    for i in range(4):
        ref, l_i = fn(ref, idx[0, i], val[0, i], lab[0, i])
        total += float(l_i)
    assert_linear_host_match(got, linear_state_to_numpy(ref), slots=False)
    assert float(loss) == pytest.approx(total, rel=1e-5)


def test_every_rule_declares_jax_slot_merge():
    """Every port rule's slot_merge (linear Rule and MCRule) equals its JAX
    twin's: the collapse of replicas sums or averages each slot as JAX
    does."""
    from hivemall_tpu.models import multiclass as JMC
    from hivemall_tpu_torch.models import multiclass as TMC

    assert sorted(PORT_RULES) == sorted(JAX_RULES)
    for name, rule in PORT_RULES.items():
        assert rule.slot_merge == JAX_RULES[name].slot_merge, name
    jmc = {r.name: r for r in vars(JMC).values() if isinstance(r, JMC.MCRule)}
    tmc = {r.name: r for r in vars(TMC).values() if isinstance(r, TMC.MCRule)}
    assert sorted(jmc) == sorted(tmc)
    for name, rule in tmc.items():
        assert rule.slot_merge == jmc[name].slot_merge, name
    assert dict(PORT_RULES["adagrad_regr"].slot_merge) == {
        "sum_sqgrad": "sum"}
    assert dict(PORT_RULES["adadelta_regr"].slot_merge) == {
        "sum_sqgrad": "mean", "sum_sq_dx": "mean"}


def test_mix_averages_in_one_collective():
    """A mix is ONE all_reduce: [2, D] for the average, [3, D] for
    argminKLD (the stacked operands), counted on the mesh."""
    idx, val, lab = _blocks(1, 2)
    with one_rank_mesh() as mesh:
        for rule, red, rows in (("perceptron", "average", 2),
                                ("arow", "argmin_kld", 3)):
            tr = MixTrainer(PORT_RULES[rule], HYPER[rule], DIMS, mesh,
                            MixConfig(mix_every=2, reduction=red))
            st = tr.init()
            mesh.stats.reset()
            tr.step(st, idx[0], val[0], lab[0])
            # one mix, then the loss sum
            assert mesh.stats.calls == 2
            assert mesh.stats.bytes == rows * DIMS * 4 + 4
    assert torch.distributed.is_initialized() is False
