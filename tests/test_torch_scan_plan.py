"""The exact scan's plan and its logress form, on the CPU.

- `linear_scan_plan_reference` (the plain version of the plan kernel in
  hivemall_tpu_torch/kernels/csrc/linear_scan.cu) against a brute-force
  numpy plan, exactly, on seeded blocks with pad lanes, in-row duplicates
  and cross-row repeats.
- The same against the blocks chip_smoke.py's phase stress aims at the
  plan kernel's hashed, tiled design (`plan_adversarial_blocks`): a row of
  one id, rows of dead lanes only, ids equal modulo 64 and 128, ids at
  the edges of [0, D) and the int32 range; one row, fewer rows than the
  depth, 13 rows; widths about one warp; every depth from 0 to 8.
- The forwarding invariant the pipelined scan kernel rests on: for every
  live lane of row b, the value its plan selects — the value row b-delta
  left (the kernel's forwarding ring) or the table as it stood when row
  b-depth started (when the kernel's prefetch was issued) — equals the
  table at the start of row b, exactly, for every table of the rule.
  Tables are snapshot row by row from `linear_scan_reference`.
- logress through the port's plain scan against the JAX package's Pallas
  kernel (`pallas_scan_raw(..., interpret=True)`) under each eta schedule,
  at the reference's tolerance rtol 1e-5 / atol 1e-6 (tests/torch_cases.py).
The kernels themselves are held against these plain versions on the card
by chip_smoke.py (phases families, stress and width)."""

import numpy as np
import pytest
import torch

from hivemall_tpu.kernels.linear_scan import pallas_scan_raw
from hivemall_tpu.models import regression as JR
from hivemall_tpu.ops import eta as JE
from hivemall_tpu_torch.core.state import (linear_state_from_numpy,
                                           linear_state_to_numpy)
from hivemall_tpu_torch.kernels.linear_scan import (
    ETA_SCHEDULES, FWD_SHIFT, KERNEL_FORMS, _hyper_values, linear_scan,
    linear_scan_plan, linear_scan_plan_reference, linear_scan_reference)
from hivemall_tpu_torch.models import classifier as TC
from hivemall_tpu_torch.models import regression as TR
from hivemall_tpu_torch.ops import eta as TE

from chip_smoke import (PLAN_EDGE_WIDTHS, PLAN_MAX_DEPTH,
                        plan_adversarial_blocks)
from pallas_cases import make_block_data
from torch_cases import (assert_states_match, jax_state_from_numpy,
                         jax_state_numpy, warm_numpy)


def brute_force_plan(idx, dims, depth):
    """The plan by its definition, lane by lane."""
    b, k = idx.shape
    lead = np.full((b, k), -1, np.int32)
    nxt = np.full((b, k), -1, np.int32)
    fwd = np.full((b, k), -1, np.int32)
    for r in range(b):
        for j in range(k):
            f = idx[r, j]
            if not 0 <= f < dims:
                continue
            lead[r, j] = min(i for i in range(k) if idx[r, i] == f)
            later = [i for i in range(j + 1, k) if idx[r, i] == f]
            nxt[r, j] = later[0] if later else -1
            for d in range(1, min(depth, r) + 1):
                hits = [i for i in range(k) if idx[r - d, i] == f]
                if hits:
                    fwd[r, j] = (d << FWD_SHIFT) | hits[0]
                    break
    return lead, nxt, fwd


def plan_block(seed, b=40, k=8, dims=24):
    """Pad lanes (every 3rd row), ids drawn from a small space (so rows
    repeat features across and inside rows), out-of-range and negative
    ids, and a row identical to the one before it."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, dims, size=(b, k)).astype(np.int32)
    idx[::3, -2:] = dims
    idx[5, 0] = -1
    idx[7, 1] = dims + 3
    idx[9] = idx[8]
    idx[::4, 1] = idx[::4, 0]
    return idx


@pytest.mark.parametrize("depth", [0, 1, 3, 8])
@pytest.mark.parametrize("seed", range(3))
def test_plan_reference_matches_brute_force(seed, depth):
    idx = plan_block(seed)
    got = linear_scan_plan_reference(torch.from_numpy(idx), 24, depth)
    for name, g, w in zip(("lead", "next", "fwd"), got,
                          brute_force_plan(idx, 24, depth)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("k", PLAN_EDGE_WIDTHS)
@pytest.mark.parametrize("depth", range(PLAN_MAX_DEPTH + 1))
def test_plan_reference_on_adversarial_blocks(depth, k):
    dims = 1 << 14
    for b in (1, 5, 13):
        rng = np.random.RandomState(1000 * b + k)
        for name, idx in plan_adversarial_blocks(rng, b, k, dims):
            got = linear_scan_plan_reference(torch.from_numpy(idx), dims,
                                             depth)
            for table, g, w in zip(("lead", "next", "fwd"), got,
                                   brute_force_plan(idx, dims, depth)):
                np.testing.assert_array_equal(
                    g.numpy(), w, err_msg=f"{name} B={b} {table}")


def test_plan_on_cpu_is_the_plain_version():
    idx = torch.from_numpy(plan_block(0))
    for g, w in zip(linear_scan_plan(idx, 24, 4),
                    linear_scan_plan_reference(idx, 24, 4)):
        assert torch.equal(g, w)


def _tables(st, rule):
    """The rule's tables of a state, in the kernel's order."""
    d = linear_state_to_numpy(st)
    out = [d["weights"].copy()]
    if rule.use_covariance:
        out.append(d["covars"].copy())
    out += [d["slots"][s].copy() for s in sorted(rule.slot_names)]
    return out


FWD_RULES = [
    (TC.AROW, {"r": 0.1}),
    (TC.PA1, {"c": 1.0}),  # rows that do not fire leave w as it was
    (TC.ADAGRAD_RDA, {"eta": 0.1, "lambda": 1e-6, "scale": 100.0}),
    (TR.ADADELTA_REGR, {"rho": 0.95, "eps": 1e-6, "scale": 100.0}),
]


@pytest.mark.parametrize("depth", [1, 3, 8])
@pytest.mark.parametrize("case", range(len(FWD_RULES)))
def test_forwarding_invariant(case, depth):
    rule, hyper = FWD_RULES[case]
    dims = 24
    idx = plan_block(10 + case, b=36, k=8, dims=dims)
    rng = np.random.RandomState(case)
    val = rng.randn(*idx.shape).astype(np.float32)
    y = np.sign(rng.randn(idx.shape[0])).astype(np.float32)
    if rule.is_regression:
        y = (0.3 * y).astype(np.float32)
    st = linear_state_from_numpy(warm_numpy(rule, dims, seed=case),
                                 device="cpu")
    # snaps[r]: the tables at the start of row r (snaps[B]: at the end)
    snaps = [_tables(st, rule)]
    for r in range(idx.shape[0]):
        st, _ = linear_scan_reference(
            rule, hyper, st, torch.from_numpy(idx[r:r + 1]),
            torch.from_numpy(val[r:r + 1]), torch.from_numpy(y[r:r + 1]))
        snaps.append(_tables(st, rule))
    lead, _, fwd = (t.numpy() for t in
                    linear_scan_plan_reference(torch.from_numpy(idx), dims,
                                               depth))
    forwarded = 0
    for r in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            if lead[r, j] < 0:
                continue
            f = idx[r, j]
            if fwd[r, j] >= 0:
                dist, src = fwd[r, j] >> FWD_SHIFT, fwd[r, j] & 0xFFFF
                assert 1 <= dist <= depth and idx[r - dist, src] == f
                assert lead[r - dist, src] == src
                chosen = snaps[r - dist + 1]  # what row r-dist left
                forwarded += 1
            else:
                chosen = snaps[max(r - depth, 0)]  # when the prefetch left
            for t, (c, want) in enumerate(zip(chosen, snaps[r])):
                assert c[f] == want[f], (r, j, t)
    assert forwarded > 0


LOGRESS_SCHEDULES = {
    "fixed": (TE.fixed(0.1), JE.fixed(0.1)),
    "simple": (TE.simple(0.1, 520), JE.simple(0.1, 520)),
    "invscaling": (TE.invscaling(0.1, 0.1), JE.invscaling(0.1, 0.1)),
    "adjusting": (TE.EtaEstimator("adjusting", eta0=0.3),
                  JE.EtaEstimator("adjusting", eta0=0.3)),
}


@pytest.mark.parametrize("kind", sorted(LOGRESS_SCHEDULES))
def test_logress_plain_matches_pallas_interpret(kind):
    """The warm state's step is 500, so `simple`'s total_steps (520) falls
    inside the block's t range."""
    t_est, j_est = LOGRESS_SCHEDULES[kind]
    rule = TR._make_logress_rule(t_est)
    idx, val, y = make_block_data(B=48, K=8, D=128, seed=3)
    idx[::2, 1] = idx[::2, 0]
    y = (y > 0).astype(np.float32)
    d0 = warm_numpy(rule, 128, seed=7)
    jst, jloss = pallas_scan_raw(JR._make_logress_rule(j_est), {},
                                 jax_state_from_numpy(d0), idx, val, y,
                                 interpret=True)
    st = linear_state_from_numpy(d0, device="cpu")
    got, loss = linear_scan(rule, TR.logress_hyper(t_est), st,
                            torch.from_numpy(idx), torch.from_numpy(val),
                            torch.from_numpy(y))
    assert_states_match(got, jax_state_numpy(jst), loss.numpy(), jloss)


def test_logress_hyper_is_the_kernel_form():
    """train_logistic_regr hands the kernel every field of its form, and
    each eta schedule has a code in the kernel."""
    keys = KERNEL_FORMS["logress"][1]
    assert set(ETA_SCHEDULES) == {"fixed", "simple", "invscaling",
                                  "adjusting"}
    for kind, (est, _) in LOGRESS_SCHEDULES.items():
        hyper = TR.logress_hyper(est)
        assert tuple(sorted(hyper)) == tuple(sorted(keys))
        h = _hyper_values(keys, hyper)
        assert h.dtype == np.float32 and h.shape == (len(keys),)
        assert h[keys.index("schedule")] == ETA_SCHEDULES[kind]
        assert h[keys.index("eta0")] == np.float32(est.eta0)
