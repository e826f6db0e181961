"""Rank-side code of tests/test_torch_recovery.py: trainer factories, data
streams and world scenarios for the port's elastic recovery. run_elastic's
ranks and tests/torch_cases.run_ranks's ranks start by ``spawn`` and import
what they run by name, so it lives here, in a module that imports no JAX
(a rank starts faster without it).

The streams are the JAX tests' own (tests/test_faults.py ``_blk``,
tests/test_elastic_recovery.py ``_row_blocks`` and the FM / FFM / 2-D /
mix blocks): step i's block is a pure function of i, so every topology
consumes the same stream. Checkpoints of the round-trip scenarios live
under ``$HM_RECOVERY_DIR`` (set by the test before it spawns a world)."""

import functools
import os
import signal
import time

import numpy as np
import torch.distributed as dist

from hivemall_tpu_torch.core.state import linear_state_to_numpy
from hivemall_tpu_torch.models.classifier import AROW
from hivemall_tpu_torch.runtime.recovery import (checkpoint, elastic_resume,
                                                 make_elastic_mesh)

DIMS = 131  # tests/test_faults.py: not divisible by any mesh size
W_TRUE = np.random.RandomState(0).randn(DIMS)


def blk(i, B=16, K=8):
    """tests/test_faults.py's block i."""
    r = np.random.RandomState(1000 + i)
    idx = r.randint(0, DIMS, size=(B, K)).astype(np.int32)
    val = r.rand(B, K).astype(np.float32)
    lab = np.sign(np.sum(W_TRUE[idx] * val, axis=-1)).astype(np.float32)
    return idx, val, lab


def data(trainer, i):
    return blk(i)


def sigterm_data(trainer, i):
    """The stream, with a SIGTERM to the supervisor from rank 0 before
    step 5 (the sleep lets the supervisor's handler raise the flag, so
    every rank stops after step 5)."""
    if i == 5 and dist.get_rank() == 0:
        os.kill(os.getppid(), signal.SIGTERM)
        time.sleep(2.0)
    return blk(i)


def make_sharded(path, devices):
    return elastic_resume(AROW, {"r": 0.1}, DIMS, path,
                          mesh=make_elastic_mesh(devices), family="sharded")


def factory(path):
    """run_elastic's make_trainer: ShardedTrainer(AROW r=0.1) over exactly
    the given devices, resumed from ``path``."""
    return functools.partial(make_sharded, path)


def accuracy(weights, n=2000):
    idx = np.random.RandomState(99).randint(0, DIMS, size=(n, 8))
    val = np.random.RandomState(98).rand(n, 8).astype(np.float32)
    y = np.sign(np.sum(W_TRUE[idx] * val, axis=-1))
    s = np.sum(np.asarray(weights)[idx] * val, axis=-1)
    return float(np.mean(np.sign(s) == y))


# --- the round trips of tests/test_elastic_recovery.py -------------------------

LIN_DIMS, FM_DIMS, D2_DIMS, MIX_DIMS = 259, 133, 101, 128


def row_blocks(dims, w_true, start, n, B=16, K=8):
    out = []
    for i in range(start, start + n):
        r = np.random.RandomState(5000 + i)
        idx = r.randint(0, dims, size=(B, K)).astype(np.int32)
        val = r.rand(B, K).astype(np.float32)
        lab = np.sign(np.sum(w_true[idx] * val, axis=-1)).astype(np.float32)
        out.append((idx, val, lab))
    return out


def lin_w():
    return np.random.RandomState(3).randn(LIN_DIMS)


def fm_blocks(start, n):
    w = np.random.RandomState(4).randn(FM_DIMS)
    return [(i_, v_, (l_ > 0).astype(np.float32))
            for i_, v_, l_ in row_blocks(FM_DIMS, w, start, n)]


def ffm_hyper():
    from hivemall_tpu_torch.models.ffm import FFMHyper

    return FFMHyper(num_features=67, v_dims=131, factors=4, num_fields=8,
                    seed=5)


def ffm_blocks(start, n, B=8, K=4):
    h = ffm_hyper()
    w = np.random.RandomState(6).randn(h.num_features)
    out = []
    for i in range(start, start + n):
        r = np.random.RandomState(7000 + i)
        idx = r.randint(0, h.num_features, size=(B, K)).astype(np.int32)
        val = r.rand(B, K).astype(np.float32)
        fld = r.randint(0, h.num_fields, size=(B, K)).astype(np.int32)
        lab = np.sign(np.sum(w[idx] * val, axis=-1)).astype(np.float32)
        out.append((idx, val, fld, lab))
    return out


def blocks_2d(R, k, seed):
    w = np.random.RandomState(8).randn(D2_DIMS)
    r = np.random.RandomState(seed)
    idx = r.randint(0, D2_DIMS, size=(R, k, 16, 8)).astype(np.int32)
    val = r.rand(R, k, 16, 8).astype(np.float32)
    lab = np.sum(w[idx] * val, axis=-1).astype(np.float32)
    return idx, val, lab


def reg_blocks(n_dev, k, seed):
    r = np.random.RandomState(seed)
    idx = r.randint(0, MIX_DIMS, size=(n_dev, k, 16, 8)).astype(np.int32)
    val = r.rand(n_dev, k, 16, 8).astype(np.float32)
    lab = r.rand(n_dev, k, 16).astype(np.float32)
    return idx, val, lab


MIX_CASES = (("adagrad_regr", {"eta": 1.0, "eps": 1.0, "scale": 100.0}),
             ("pa1a_regr", {"c": 1.0, "epsilon": 0.1}))
D2_HYPER = {"eta": 1.0, "eps": 1.0, "scale": 100.0}


def _ck(name):
    return os.path.join(os.environ["HM_RECOVERY_DIR"], name)


def _rule(name):
    from hivemall_tpu_torch.models import regression

    return {r.name: r for r in vars(regression).values()
            if isinstance(r, type(AROW))}[name]


def _fm_fields(st):
    from hivemall_tpu_torch.models.fm import fm_state_to_numpy

    return fm_state_to_numpy(st)


def _ffm_fields(st):
    from hivemall_tpu_torch.models.ffm import ffm_state_to_numpy

    return ffm_state_to_numpy(st)


def _mesh(n):
    return make_elastic_mesh(["cpu"] * n)


def _mix_blocks(trainer, blocks):
    """This replica's [k, B, ...] share of [R, k, B, ...] blocks."""
    return trainer.shard_blocks(*(a.reshape((-1,) + a.shape[2:])
                                  for a in blocks))


def sc_write(rank, n):
    """World 4: every family's uninterrupted run and its checkpointed run;
    the checkpoint resumed on the same world (N -> N)."""
    from hivemall_tpu_torch.models.fm import FMHyper
    from hivemall_tpu_torch.parallel import MixConfig, make_mesh_2d

    out = {}
    mesh = _mesh(n)
    blocks = row_blocks(LIN_DIMS, lin_w(), 0, 10)
    ck = _ck("lin.npz")
    t, s = elastic_resume(AROW, {"r": 0.1}, LIN_DIMS, ck, mesh=mesh,
                          family="sharded")
    for b in blocks:
        s, _ = t.step(s, *b)
    out["lin_full"] = linear_state_to_numpy(t.final_state(s))
    t, s = elastic_resume(AROW, {"r": 0.1}, LIN_DIMS, ck, mesh=mesh,
                          family="sharded")
    for b in blocks[:6]:
        s, _ = t.step(s, *b)
    out["lin_manifest_step"] = checkpoint(t, s, ck, block_step=6)["step"]
    out["lin_ck"] = linear_state_to_numpy(t.final_state(s))
    t, s = elastic_resume(AROW, {"r": 0.1}, LIN_DIMS, ck, mesh=mesh,
                          family="sharded")
    out["lin_back"] = linear_state_to_numpy(t.final_state(s))
    for b in blocks[6:]:
        s, _ = t.step(s, *b)
    out["lin_nn"] = linear_state_to_numpy(t.final_state(s))

    hyper = FMHyper(factors=4, classification=True)
    ck = _ck("fm.npz")
    t, s = elastic_resume(None, hyper, FM_DIMS, ck, mesh=mesh,
                          family="fm_sharded")
    for b in fm_blocks(0, 8):
        s, _ = t.step(s, *b)
    out["fm_full"] = _fm_fields(t.final_state(s))
    t, s = elastic_resume(None, hyper, FM_DIMS, ck, mesh=mesh,
                          family="fm_sharded")
    for b in fm_blocks(0, 5):
        s, _ = t.step(s, *b)
    checkpoint(t, s, ck, block_step=5)
    out["fm_ck"] = _fm_fields(t.final_state(s))

    h = ffm_hyper()
    ck = _ck("ffm.npz")
    t, s = elastic_resume(None, h, h.num_features, ck, mesh=mesh,
                          family="ffm_sharded")
    for b in ffm_blocks(0, 6):
        s, _ = t.step(s, *b)
    out["ffm_full"] = _ffm_fields(t.final_state(s))
    t, s = elastic_resume(None, h, h.num_features, ck, mesh=mesh,
                          family="ffm_sharded")
    for b in ffm_blocks(0, 4):
        s, _ = t.step(s, *b)
    checkpoint(t, s, ck, block_step=4)
    out["ffm_ck"] = _ffm_fields(t.final_state(s))

    mesh2 = make_mesh_2d(2, n // 2, device="cpu")
    try:
        ck = _ck("2d.npz")
        t, s = elastic_resume(_rule("adagrad_regr"), D2_HYPER, D2_DIMS, ck,
                              mesh=mesh2, config=MixConfig(mix_every=2),
                              family="sharded_2d")
        s, _ = t.step(s, *_mix_blocks(t, blocks_2d(2, 4, 1)))
        checkpoint(t, s, ck, block_step=1)
        out["d2_base"] = linear_state_to_numpy(t.final_state(s))
    finally:
        mesh2.destroy()

    for name, mix_hyper in MIX_CASES:
        ck = _ck(f"mix_{name}.npz")
        t, s = elastic_resume(_rule(name), mix_hyper, MIX_DIMS, ck,
                              mesh=mesh, config=MixConfig(mix_every=2))
        s, _ = t.step(s, *t.shard_blocks(*(
            a.reshape((-1,) + a.shape[2:]) for a in reg_blocks(n, 2, 1))))
        checkpoint(t, s, ck)
        out[f"mix_{name}_base"] = linear_state_to_numpy(t.final_state(s))

    # a JAX-written checkpoint resumes at this world too
    t, s = elastic_resume(AROW, {"r": 0.1}, LIN_DIMS, _ck("jax_lin.npz"),
                          mesh=mesh, family="sharded")
    out["jax_lin_back"] = linear_state_to_numpy(t.final_state(s))
    return out


def sc_resume(rank, n):
    """World 2: every checkpoint of sc_write resumed at the smaller world,
    collapsed at once, then continued on the same stream."""
    from hivemall_tpu_torch.models.fm import FMHyper
    from hivemall_tpu_torch.parallel import MixConfig, make_mesh_2d

    out = {}
    mesh = _mesh(n)
    t, s = elastic_resume(AROW, {"r": 0.1}, LIN_DIMS, _ck("lin.npz"),
                          mesh=mesh, family="sharded")
    out["lin_back"] = linear_state_to_numpy(t.final_state(s))
    for b in row_blocks(LIN_DIMS, lin_w(), 6, 4):
        s, _ = t.step(s, *b)
    out["lin_cont"] = linear_state_to_numpy(t.final_state(s))

    hyper = FMHyper(factors=4, classification=True)
    t, s = elastic_resume(None, hyper, FM_DIMS, _ck("fm.npz"), mesh=mesh,
                          family="fm_sharded")
    out["fm_back"] = _fm_fields(t.final_state(s))
    for b in fm_blocks(5, 3):
        s, _ = t.step(s, *b)
    out["fm_cont"] = _fm_fields(t.final_state(s))

    h = ffm_hyper()
    t, s = elastic_resume(None, h, h.num_features, _ck("ffm.npz"),
                          mesh=mesh, family="ffm_sharded")
    out["ffm_back"] = _ffm_fields(t.final_state(s))
    for b in ffm_blocks(4, 2):
        s, _ = t.step(s, *b)
    out["ffm_cont"] = _ffm_fields(t.final_state(s))

    mesh2 = make_mesh_2d(2, n // 2, device="cpu")
    try:
        t, s = elastic_resume(_rule("adagrad_regr"), D2_HYPER, D2_DIMS,
                              _ck("2d.npz"), mesh=mesh2,
                              config=MixConfig(mix_every=2),
                              family="sharded_2d")
        out["d2_again"] = linear_state_to_numpy(t.final_state(s))
        s, _ = t.step(s, *_mix_blocks(t, blocks_2d(2, 2, 2)))
        out["d2_fin"] = linear_state_to_numpy(t.final_state(s))
    finally:
        mesh2.destroy()

    for name, mix_hyper in MIX_CASES:
        t, s = elastic_resume(_rule(name), mix_hyper, MIX_DIMS,
                              _ck(f"mix_{name}.npz"), mesh=mesh,
                              config=MixConfig(mix_every=2))
        out[f"mix_{name}_again"] = linear_state_to_numpy(t.final_state(s))
        s, _ = t.step(s, *t.shard_blocks(*(
            a.reshape((-1,) + a.shape[2:]) for a in reg_blocks(n, 2, 2))))
        out[f"mix_{name}_fin"] = linear_state_to_numpy(t.final_state(s))

    # cross-family: FM refuses as linear; a MixTrainer checkpoint seeds a
    # feature-sharded trainer
    try:
        elastic_resume(AROW, {"r": 0.1}, FM_DIMS, _ck("fm.npz"), mesh=mesh,
                       family="sharded")
        out["fm_as_linear"] = "accepted"
    except ValueError as e:
        out["fm_as_linear"] = str(e)
    t, s = elastic_resume(_rule("adagrad_regr"), MIX_CASES[0][1], MIX_DIMS,
                          _ck("mix_adagrad_regr.npz"), mesh=mesh,
                          family="sharded")
    out["mix_as_sharded"] = linear_state_to_numpy(t.final_state(s))

    # JAX-written checkpoints resume here
    t, s = elastic_resume(AROW, {"r": 0.1}, LIN_DIMS, _ck("jax_lin.npz"),
                          mesh=mesh, family="sharded")
    out["jax_lin_back"] = linear_state_to_numpy(t.final_state(s))
    t, s = elastic_resume(None, hyper, FM_DIMS, _ck("jax_fm.npz"),
                          mesh=mesh, family="fm_sharded")
    out["jax_fm_back"] = _fm_fields(t.final_state(s))
    return out


# --- the multi-process failure of tests/test_elastic_recovery.py --------------

FAIL_DIMS = 128


def failing_job(rank, n, path):
    """A 2-rank MixTrainer job that checkpoints its mixed model and then
    dies with exit code 7 on every rank (the Hadoop-retry analog)."""
    from hivemall_tpu_torch.parallel import MixConfig, MixTrainer, make_mesh

    rng = np.random.RandomState(21)
    w_true = rng.randn(FAIL_DIMS)
    idx = rng.randint(0, FAIL_DIMS, size=(n, 8, 16, 8)).astype(np.int32)
    val = rng.rand(n, 8, 16, 8).astype(np.float32)
    lab = np.sign(np.sum(w_true[idx] * val, axis=-1)).astype(np.float32)
    t = MixTrainer(AROW, {"r": 0.1}, FAIL_DIMS, make_mesh(device="cpu"),
                   MixConfig(mix_every=2))
    s, _ = t.step(t.init(), idx[rank], val[rank], lab[rank])
    checkpoint(t, s, path)  # collective: ends in a barrier
    os._exit(7)
