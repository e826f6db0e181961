"""Field-aware Factorization Machines: train_ffm / ffm_predict — the port of
`hivemall_tpu/models/ffm.py`.

Mirrors the reference FFM subsystem (ref: fm/FieldAwareFactorizationMachineUDTF.java:57-200,
fm/FieldAwareFactorizationMachineModel.java:40-200, fm/FFMStringFeatureMapModel.java:32-200,
fm/FFMHyperParameters.java):

- prediction  p = [w0] + [sum_i w_i x_i] + sum_{i<j} <V_{i,f_j}, V_{j,f_i}> x_i x_j
  (global bias and linear term both optional: -w0 / -disable_wi)
- V updates: SGD with per-factor L2, AdaGrad per-entry learning rate
  eta0_V / sqrt(eps + gg) using the accumulator value BEFORE the current
  gradient (ref: etaV, FieldAwareFactorizationMachineModel.java:126-134)
- W updates: FTRL by default (z/n accumulators, L1 sparsity; ref:
  updateWiFTRL, FFMStringFeatureMapModel.java:133-157), plain SGD with
  -disable_ftrl
- the pairwise gradient d p/d V_{i,f_j,f} = x_i x_j V_{j,f_i,f} (the JAX
  package's; it coincides with the reference's on the usual all-ones FFM
  encoding)

The (feature, field) hash-map entries are ONE dense [Dv, k] table addressed
by a mixed pair hash; a block's pairwise terms are one [B, K, K, k] gather,
its V gradient one scatter-add of B * K * K rows. The JAX step is plain XLA
(a `lax.scan` of rows, or a `vmap` over the block and its scatters), so the
port's is plain torch on the device, its row math written once over a
leading batch axis: the minibatch step runs it on a block (or on
``-row_chunk`` chunks of it, each against the block-start tables), and the
exact scan on one-row slices in order.

The linear weight is SET, not added: each lane computes its feature's new
w from the block-start z and n. Where a feature repeats in a block, the
lanes disagree; XLA on the CPU keeps the LAST lane in row-major order, and
the port keeps that same lane on every device (the largest lane position
per feature, by an ``amax`` scatter), since an ``index_put_`` with repeated
indices keeps an unspecified one on the card.

The initial V is the JAX package's draw (utils/jax_prng.py, equal to
``jax.random.normal(PRNGKey(seed), (v_dims, k)) * sigma``), made on the
host and copied to the device. That is what makes the model blob
(`to_blob` / `from_blob`, rows stored only where they differ from the
draw) readable in both packages.

`step` is a host int. Steps update the state's tensors in place and
return it: treat the state passed in as consumed (the JAX steps donate
it).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.batch import pad_to_bucket
from ..core.engine import _to_device, live_lanes
from ..core.state import _numpy
from ..core.striping import translate_to_stripe
from ..device import DeviceLike, resolve_device
from ..ops.convergence import ConversionState
from ..ops.eta import EtaEstimator, get_eta
from ..ops.scatter import scatter_rows_flat
from ..core.collectives import psum
from ..utils.feature import FMFeature
from ..utils.options import Options
from .fm import _fm_options

_MIX1 = 0x9E3779B1
_MIX2 = 0x85EBCA6B
_MIX3 = 0x2C1B3C6D
_M32 = 0xFFFFFFFF


def _mul32(a, b: int):
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant
    ``b`` < 2^32, in int64 without overflow (the low and high 16-bit
    halves of ``a`` multiply apart)."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _M32


def pair_hash(feature_idx, field, dv: int):
    """Deterministic (feature, field) -> V-table row, bit-equal to the JAX
    package's uint32 wraparound mixing. Takes int64 tensors (or numpy
    int64 arrays) of any broadcastable shapes; returns int64 rows in
    [0, dv)."""
    h = (_mul32(feature_idx & _M32, _MIX1)
         + _mul32(field & _M32, _MIX2)) & _M32
    h = h ^ (h >> 15)
    h = _mul32(h, _MIX3)
    h = h ^ (h >> 12)
    return h % dv


@dataclass
class FFMState:
    w0: torch.Tensor  # []
    w: torch.Tensor  # [D]
    z: torch.Tensor  # [D] FTRL z
    n: torch.Tensor  # [D] FTRL n
    v: torch.Tensor  # [Dv, k]
    v_gg: torch.Tensor  # [Dv] AdaGrad accumulator for V
    touched: torch.Tensor  # [D] int8
    step: int  # processed-example counter

    @property
    def device(self) -> torch.device:
        return self.w.device

    def replace(self, **changes) -> "FFMState":
        return dataclasses.replace(self, **changes)


_TENSOR_FIELDS = ("w0", "w", "z", "n", "v", "v_gg", "touched")


@dataclass(frozen=True)
class FFMHyper:
    factors: int = 4
    classification: bool = True
    lambda_w: float = 0.01
    lambda_v: float = 0.01
    global_bias: bool = False
    linear_coeff: bool = True
    use_ftrl: bool = True
    use_adagrad: bool = True
    eta0_v: float = 1.0
    eps: float = 1.0
    alpha: float = 0.1  # FTRL
    beta: float = 1.0
    lambda1: float = 0.1
    lambda2: float = 0.01
    sigma: float = 0.1
    num_features: int = 1 << 21  # -feature_hashing 21 default
    num_fields: int = 1024
    v_dims: int = 1 << 22
    eta: EtaEstimator = EtaEstimator("invscaling", 0.2, power_t=0.1)
    min_target: float = -3.0e38
    max_target: float = 3.0e38
    seed: int = 31


def initial_v(hyper: FFMHyper) -> np.ndarray:
    """The JAX package's initial V, ``normal(PRNGKey(seed), (v_dims, k)) *
    sigma``, as host float32 (utils/jax_prng.py)."""
    from ..utils.jax_prng import normal

    return normal(hyper.seed, (hyper.v_dims, hyper.factors)) \
        * np.float32(hyper.sigma)


def init_ffm_state(hyper: FFMHyper, device: DeviceLike = None) -> FFMState:
    """A fresh model on ``device``: zero linear tables, V from `initial_v`
    (drawn on the host), zero AdaGrad accumulators."""
    dev = resolve_device(device)
    d = hyper.num_features

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return FFMState(w0=zeros(), w=zeros(d), z=zeros(d), n=zeros(d),
                    v=torch.from_numpy(initial_v(hyper)).to(dev),
                    v_gg=zeros(hyper.v_dims),
                    touched=zeros(d, dtype=torch.int8), step=0)


def ffm_state_from_numpy(d: dict, device: DeviceLike = None) -> FFMState:
    """Build a state from the JAX FFMState's fields as numpy arrays (``w0``,
    ``w``, ``z``, ``n``, ``v``, ``v_gg``, ``touched``, ``step``). Every
    tensor is a fresh copy."""
    dev = resolve_device(device)
    fields = {k: torch.tensor(np.asarray(d[k]), device=dev)
              for k in _TENSOR_FIELDS}
    for k in _TENSOR_FIELDS[:-1]:
        fields[k] = fields[k].float()
    fields["touched"] = fields["touched"].to(torch.int8)
    return FFMState(step=int(d.get("step", 0)), **fields)


def ffm_state_to_numpy(state: FFMState) -> dict:
    """The inverse of `ffm_state_from_numpy`: numpy copies of every field,
    ``step`` as np.int32 (the JAX state's type)."""
    out = {k: _numpy(getattr(state, k)) for k in _TENSOR_FIELDS}
    out["step"] = np.int32(state.step)
    return out


def _row_pair_keys(idx, fields, dv: int):
    """[..., K] features -> [..., K, K] pair table rows:
    keys[..., i, j] = h(idx_i, field_j)."""
    return pair_hash(idx[..., :, None], fields[..., None, :], dv)


def _linear_lanes(table, idx, live):
    """float32 lanes of a [D] table, 0 on dead lanes."""
    return torch.where(live, table[torch.where(live, idx, 0)].float(), 0.0)


def _row_predict(st: FFMState, idx, val, fields, hyper: FFMHyper, Vg=None,
                 keys=None):
    """p [B] of rows [B, K] against ``st`` (or the pre-gathered pair block
    ``Vg`` [B, K, K, k] at ``keys``); also returns keys, Vg and xx."""
    if keys is None:
        keys = _row_pair_keys(idx, fields, hyper.v_dims)
    if Vg is None:
        Vg = st.v[keys].float()
    # <V_{i,fj}, V_{j,fi}> on pairs i < j, pad lanes (value 0) adding 0
    inter = torch.sum(Vg * Vg.transpose(-2, -3), dim=-1)
    xx = val[..., :, None] * val[..., None, :]
    p = torch.sum(torch.triu(inter * xx, 1), dim=(-2, -1))
    if hyper.linear_coeff:
        live = (idx >= 0) & (idx < st.w.shape[0])
        p = p + torch.sum(_linear_lanes(st.w, idx, live) * val, dim=-1)
    if hyper.global_bias:
        p = p + st.w0
    return p, keys, Vg, xx


def sharded_ffm_gather(st: FFMState, idx, val, fields, hyper: FFMHyper,
                       mesh, axis: str, stripe_w: int, stripe_v: int):
    """The ONE copy of the feature-sharded FFM row gather + prediction,
    shared by the sharded train step and sharded scoring (FFMShardedTrainer
    .make_predict). Rows [B, K] with GLOBAL ids. Each rank gathers the
    entries it owns of each row's [K, K, k] pair block and its AdaGrad
    accumulators (exactly one owner per hashed key) and its linear
    partial; ONE all_reduce sums the three, rebuilding the full block
    everywhere. Keys hash with the full v_dims, so the sharded model is
    the same function as the unsharded one. Returns (p, local keys [B, K,
    K] (not owned -> ``stripe_v``), Vg, xx, gg, own)."""
    shard = mesh.index(axis)
    b, K = idx.shape
    k = hyper.factors
    lkeys = _row_pair_keys(idx, fields, hyper.v_dims) - shard * stripe_v
    owned = (lkeys >= 0) & (lkeys < stripe_v)
    lkeys = torch.where(owned, lkeys, torch.full_like(lkeys, stripe_v))
    safe = torch.where(owned, lkeys, torch.zeros_like(lkeys))
    vg = torch.where(owned[..., None], st.v[safe].float(), 0.0)
    gg = torch.where(owned, st.v_gg[safe].float(), 0.0)
    lin = torch.zeros(b, dtype=torch.float32, device=st.w.device)
    if hyper.linear_coeff:
        lidx, vmask = translate_to_stripe(idx, val, shard, stripe_w)
        live = (lidx >= 0) & (lidx < st.w.shape[0])
        lin = torch.sum(_linear_lanes(st.w, lidx, live) * vmask, dim=-1)
    parts = psum(torch.cat([vg.reshape(b, -1), gg.reshape(b, -1),
                            lin[:, None]], dim=1), mesh, axis)
    vg = parts[:, :K * K * k].reshape(b, K, K, k)
    gg = parts[:, K * K * k:-1].reshape(b, K, K)
    inter = torch.sum(vg * vg.transpose(-2, -3), dim=-1)
    xx = val[..., :, None] * val[..., None, :]
    p = torch.sum(torch.triu(inter * xx, 1), dim=(-2, -1))
    if hyper.linear_coeff:
        p = p + parts[:, -1]
    if hyper.global_bias:
        p = p + st.w0
    return p, lkeys, vg, xx, gg, owned.to(val.dtype)


def _set_last_lane(table: torch.Tensor, sidx: torch.Tensor,
                   live: torch.Tensor, vals: torch.Tensor) -> None:
    """``table[sidx] = vals`` over the live lanes, IN PLACE; where a slot
    repeats, the last lane in row-major order wins (XLA's CPU scatter-set
    order), the same lane on every device. Each slot's winner is the
    largest lane position an ``amax`` scatter leaves in a [D + 1] scratch
    (dead lanes go to the extra slot); then every lane of a slot writes
    the winner's value, so the repeated writes agree. Dead lanes point at
    slot 0 and write what slot 0 ends up holding."""
    d = table.shape[0]
    flat = sidx.reshape(-1)
    lane_live = live.reshape(-1)
    pos = torch.arange(flat.numel(), device=table.device)
    win = torch.full((d + 1,), -1, dtype=torch.int64, device=table.device)
    win.scatter_reduce_(0, torch.where(lane_live, flat, d), pos,
                        reduce="amax")
    w = win[flat]
    table.index_put_((flat,), torch.where(
        w >= 0, vals.reshape(-1)[w.clamp(min=0)].to(table.dtype),
        table[flat]))


def make_ffm_step(hyper: FFMHyper, mode: str = "scan",
                  row_chunk: Optional[int] = None, feature_shard=None,
                  pack_v: Optional[bool] = None,
                  update_backend: str = "xla", device: DeviceLike = None):
    """Build ``step(state, indices, values, fields, labels) -> (state,
    loss_sum)``. ``mode="scan"`` replays rows sequentially
    (reference-exact); ``"minibatch"`` reads every row against the
    block-start parameters and scatter-accumulates the updates.
    ``row_chunk`` (minibatch only) tiles the block's K^2 pairwise work into
    chunks of that many rows, each against the SAME block-start
    parameters, bounding peak activation memory at [row_chunk, K, K, k];
    one block-level w0 update then uses eta at the block's last timestep.

    ``pack_v`` interleaves V and its AdaGrad accumulator into one
    [Dv, k+1] table for the block, so one row gather and one row scatter
    serve both (None: pack when B * K^2 * 8 >= Dv, the JAX package's
    rule). ``update_backend="mxu"`` (local minibatch only) always packs,
    padded to a power-of-two lane count, and sends each row group's
    [B * K * K] pair traffic through ops/mxu_scatter.py: one sorted plan
    of the group's pair keys serves its gather and its scatter-add of
    dV + dgg, and a plan of its feature ids the FTRL z / n sums, so the
    step adds no float atomically. The linear w keeps the last-lane set
    of the xla backend, as the JAX mxu step does (it sets w the same
    way).

    ``feature_shard=(mesh, axis, stripe_w, stripe_v)`` stripes the linear
    tables (w / z / n / touched, [num_features]) and the pairwise tables
    (v / v_gg, [v_dims]) across the ranks of the axis
    (parallel/sharded_train.py FFMShardedTrainer): each row group's pair
    blocks are owner-gathered and summed in one all_reduce
    (`sharded_ffm_gather`; per chunk under ``row_chunk``), and updates
    scatter back into the owned entries only. V is never packed with its
    accumulator there."""
    if update_backend not in ("xla", "mxu"):
        raise ValueError(f"unknown update_backend {update_backend!r}")
    if update_backend == "mxu":
        if mode != "minibatch" or feature_shard is not None:
            raise ValueError("update_backend='mxu' requires the local "
                             "minibatch path")
        if pack_v is False:
            raise ValueError("update_backend='mxu' rides the packed V+gg "
                             "table; pack_v=False contradicts it")
    use_mxu = update_backend == "mxu"
    if mode not in ("scan", "minibatch"):
        raise ValueError(f"unknown mode {mode!r}")
    if row_chunk is not None and mode != "minibatch":
        raise ValueError("row_chunk applies to minibatch mode only")
    if row_chunk is not None and row_chunk <= 0:
        raise ValueError(f"row_chunk must be positive, got {row_chunk}")
    dev = resolve_device(device)
    k = hyper.factors

    def inputs(indices, values, fields, labels):
        return (_to_device(indices, torch.int64, dev),
                _to_device(values, torch.float32, dev),
                _to_device(fields, torch.int64, dev),
                _to_device(labels, torch.float32, dev))

    def dloss_fn(p, y):
        if hyper.classification:
            z = p * y
            return ((torch.sigmoid(z) - 1.0) * y,
                    torch.logaddexp(torch.zeros_like(z), -z))
        pc = torch.clamp(p, hyper.min_target, hyper.max_target)
        return pc - y, 0.5 * (pc - y) ** 2

    def row_updates(base: FFMState, idx, val, fld, y, ts, pk_base):
        """(g, loss, keys, dV, dgg, plan) of rows [B, K] against ``base``
        (its V and gg from the packed table ``pk_base`` when given; under
        mxu through ``plan``, the sorted plan of the rows' pair keys,
        returned for the scatter; else None)."""
        own = plan = None
        if feature_shard is not None:
            p, keys, Vg, xx, gg, own = sharded_ffm_gather(
                base, idx, val, fld, hyper, *feature_shard)
        else:
            keys = _row_pair_keys(idx, fld, hyper.v_dims)  # [B, K, K]
            gg = None
            if pk_base is not None:
                if use_mxu:
                    from ..ops import mxu_scatter as mxu

                    plan = mxu.make_plan(keys.reshape(-1), hyper.v_dims)
                    pg = mxu.gather(pk_base, plan).reshape(
                        keys.shape + (pk_base.shape[-1],))[..., :k + 1]
                else:
                    pg = pk_base[keys]  # [B, K, K, k+1]
                Vg, gg = pg[..., :-1], pg[..., -1]
            else:
                Vg = base.v[keys]
            p, _, _, xx = _row_predict(base, idx, val, fld, hyper, Vg=Vg,
                                       keys=keys)
        g, loss = dloss_fn(p, y)
        K = idx.shape[-1]
        offdiag = 1.0 - torch.eye(K, device=dev)
        # dV[i, j] = g * x_i x_j * V_{j, f_i} for i != j
        coeff = g[:, None, None] * xx * offdiag
        gradV = coeff[..., None] * Vg.transpose(1, 2)
        if hyper.use_adagrad:
            # AdaGrad eta per (i, j) entry, using gg BEFORE this gradient
            if gg is None:
                gg = base.v_gg[keys]
            eta_v = hyper.eta0_v / torch.sqrt(hyper.eps + gg)
        else:
            eta_v = hyper.eta.eta(ts)[:, None, None].expand(keys.shape)
        dV = -eta_v[..., None] * (gradV + 2.0 * hyper.lambda_v * Vg)
        # pad lanes (value 0) get neither the gradient nor the L2 pull
        lane = (val != 0.0).to(val.dtype)
        pair_real = lane[:, :, None] * lane[:, None, :] * offdiag
        if own is not None:  # sharded: foreign entries are not this rank's
            pair_real = pair_real * own
        dV = dV * pair_real[..., None]
        dgg = torch.sum(gradV * gradV, dim=-1) * pair_real
        return g, loss, keys, dV, dgg, plan

    def w_updates(base: FFMState, sidx, live, val, g, ts):
        """Linear-term lanes: (dz, dn, w_new), FTRL (default) or SGD."""
        grad = g[:, None] * val
        w_old = _linear_lanes(base.w, sidx, live)
        if hyper.use_ftrl:
            n_old = _linear_lanes(base.n, sidx, live)
            n_new = n_old + grad * grad
            sigma = (torch.sqrt(n_new) - torch.sqrt(n_old)) / hyper.alpha
            z_old = _linear_lanes(base.z, sidx, live)
            z_new = z_old + grad - sigma * w_old
            w_new = torch.where(
                torch.abs(z_new) <= hyper.lambda1, 0.0,
                (torch.sign(z_new) * hyper.lambda1 - z_new)
                / ((hyper.beta + torch.sqrt(n_new)) / hyper.alpha
                   + hyper.lambda2))
            return z_new - z_old, n_new - n_old, w_new
        eta = hyper.eta.eta(ts)[:, None]
        dw = -eta * (grad + 2.0 * hyper.lambda_w * w_old)
        return None, None, w_old + dw

    def apply_row_group(carry: FFMState, base: FFMState, idx, val, fld, lab,
                        ts, pk_carry=None, pk_base=None):
        """One row group's updates against the block-start ``base``,
        accumulated into ``carry`` (and ``pk_carry``) in place; every read
        of ``base`` comes before the first write, so ``carry`` may be
        ``base``. Returns (loss sum, g sum)."""
        g, loss, keys, dV, dgg, plan = row_updates(base, idx, val, fld, lab,
                                                   ts, pk_base)
        if plan is not None:
            from ..ops import mxu_scatter as mxu

            # the sorted scatter-add returns a new table: write it back
            pk_carry.copy_(mxu.scatter_add(
                pk_carry, keys.reshape(-1),
                torch.cat([dV, dgg[..., None]], dim=-1).reshape(-1, k + 1),
                plan))
        elif pk_carry is not None:
            scatter_rows_flat(pk_carry, keys.reshape(-1),
                              torch.cat([dV, dgg[..., None]], dim=-1)
                              .reshape(-1, k + 1))
        else:
            scatter_rows_flat(carry.v, keys.reshape(-1), dV.reshape(-1, k))
            if feature_shard is None:
                carry.v_gg.index_add_(0, keys.reshape(-1), dgg.reshape(-1))
            else:  # keys not owned here are past the stripe: dropped
                scatter_rows_flat(carry.v_gg[:, None], keys.reshape(-1),
                                  dgg.reshape(-1, 1))
        if feature_shard is not None:
            mesh, axis, stripe_w, _ = feature_shard
            idx, val = translate_to_stripe(idx, val, mesh.index(axis),
                                           stripe_w)
        live, sidx = live_lanes(idx, carry.w.shape[0])
        if hyper.linear_coeff:
            dz, dn, w_new = w_updates(base, sidx, live, val, g, ts)
            if dz is not None and plan is not None:
                # the FTRL sums ride a sorted plan of the lanes' ids too, so
                # the mxu step adds no float atomically (dead lanes' ids
                # are out of range: dropped)
                ids = idx.reshape(-1)
                lplan = mxu.make_plan(ids, carry.z.shape[0])
                for t, d in ((carry.z, dz), (carry.n, dn)):
                    t.copy_(mxu.scatter_add(t, ids, d.reshape(-1), lplan))
            elif dz is not None:
                flat = sidx.reshape(-1)
                carry.z.index_add_(0, flat,
                                   torch.where(live, dz, -0.0).reshape(-1))
                carry.n.index_add_(0, flat,
                                   torch.where(live, dn, -0.0).reshape(-1))
            _set_last_lane(carry.w, sidx, live, w_new)
        carry.touched.scatter_reduce_(0, sidx.reshape(-1),
                                      live.reshape(-1).to(torch.int8),
                                      reduce="amax")
        return torch.sum(loss), torch.sum(g)

    def apply_w0(st: FFMState, base_w0, g_sum, b, t_last):
        """One batch-level w0 update with eta at the batch's last
        timestep."""
        if hyper.global_bias:
            eta = hyper.eta.eta(t_last)
            st.w0 = base_w0 - eta * (g_sum + b * 2.0 * hyper.lambda_w
                                     * base_w0)
        return st

    def want_pack(b: int, K: int, state: FFMState) -> bool:
        """Packing costs ~2 full [Dv, k+1] table passes per block; the win
        is the B*K^2 scalar gg gather and scatter it folds into the V row
        ops. Pack when the block's pairwise volume dominates the table
        traffic (always at the deployment block sizes; tiny test blocks
        stay split). ``pack_v`` overrides; sharded steps never pack."""
        if feature_shard is not None:
            return False
        if pack_v is not None:
            return pack_v
        return b * K * K * 8 >= state.v.shape[0]

    def pack(state: FFMState):
        pk = torch.cat([state.v, state.v_gg[:, None]], dim=1)
        if use_mxu:
            # the mxu lane protocol needs a power-of-two lane count; the
            # extra pad lanes receive no update (kl < c scatter protocol)
            from ..ops.mxu_scatter import pad_cols

            extra = pad_cols(k + 1) - (k + 1)
            if extra:
                pk = torch.cat([pk, pk.new_zeros((pk.shape[0], extra))],
                               dim=1)
        return pk

    def unpack(st: FFMState, pk) -> FFMState:
        return st.replace(v=pk[:, :k].contiguous(),
                          v_gg=pk[:, k].contiguous())

    def timesteps(state, b):
        return (state.step + 1
                + torch.arange(b, device=dev)).to(torch.float32)

    def scan_step(state: FFMState, indices, values, fields, labels):
        indices, values, fields, labels = inputs(indices, values, fields,
                                                 labels)
        b = indices.shape[0]
        ts = timesteps(state, b)
        losses = []
        for r in range(b):
            sl = slice(r, r + 1)
            w0 = state.w0
            loss, g_sum = apply_row_group(state, state, indices[sl],
                                          values[sl], fields[sl],
                                          labels[sl], ts[sl])
            state = apply_w0(state, w0, g_sum, 1, ts[r])
            losses.append(loss)
        loss = torch.stack(losses).sum() if losses \
            else torch.zeros((), device=dev)
        return state.replace(step=state.step + b), loss

    def minibatch_step(state: FFMState, indices, values, fields, labels):
        indices, values, fields, labels = inputs(indices, values, fields,
                                                 labels)
        b = indices.shape[0]
        ts = timesteps(state, b)
        pk = pack(state) if use_mxu or want_pack(b, indices.shape[1],
                                                 state) else None
        w0 = state.w0
        loss, g_sum = apply_row_group(state, state, indices, values, fields,
                                      labels, ts, pk_carry=pk, pk_base=pk)
        if pk is not None:
            state = unpack(state, pk)
        state = apply_w0(state, w0, g_sum, b, ts[-1])
        return state.replace(step=state.step + b), loss

    def chunked_minibatch_step(state: FFMState, indices, values, fields,
                               labels):
        indices, values, fields, labels = inputs(indices, values, fields,
                                                 labels)
        b, c = indices.shape[0], row_chunk
        if b % c != 0:
            raise ValueError(f"batch {b} not divisible by row_chunk {c}")
        ts = timesteps(state, b)
        packed = use_mxu or want_pack(b, indices.shape[1], state)
        # the block-start parameters every chunk reads: snapshots of the
        # tables the chunks write
        base = state.replace(
            w=state.w.clone(), z=state.z.clone(), n=state.n.clone(),
            v=state.v if packed else state.v.clone(),
            v_gg=state.v_gg if packed else state.v_gg.clone())
        pk_base = pack(state) if packed else None
        pk = pk_base.clone() if packed else None
        losses, g_sums = [], []
        for s in range(0, b, c):
            sl = slice(s, s + c)
            loss, g_sum = apply_row_group(state, base, indices[sl],
                                          values[sl], fields[sl],
                                          labels[sl], ts[sl], pk_carry=pk,
                                          pk_base=pk_base)
            losses.append(loss)
            g_sums.append(g_sum)
        if pk is not None:
            state = unpack(state, pk)
        state = apply_w0(state, base.w0, torch.stack(g_sums).sum(), b,
                         ts[-1])
        return state.replace(step=state.step + b), torch.stack(losses).sum()

    if mode == "scan":
        return scan_step
    return chunked_minibatch_step if row_chunk is not None \
        else minibatch_step


_SCORE_BLOCK = 4096  # rows scored per call: bounds the [B, K, K, k] gather


def _ffm_scores(state: FFMState, hyper: FFMHyper, indices, values,
                fields) -> torch.Tensor:
    """Scores [B] of padded rows on the state's device — the one scorer of
    TrainedFFMModel.predict and the FFM servable."""
    dev = state.device
    indices = _to_device(indices, torch.int64, dev)
    values = _to_device(values, torch.float32, dev)
    fields = _to_device(fields, torch.int64, dev)
    out = [_row_predict(state, indices[s:s + _SCORE_BLOCK],
                        values[s:s + _SCORE_BLOCK],
                        fields[s:s + _SCORE_BLOCK], hyper)[0]
           for s in range(0, indices.shape[0], _SCORE_BLOCK)]
    return torch.cat(out) if out else torch.zeros(0, device=dev)


@dataclass
class TrainedFFMModel:
    state: FFMState
    hyper: FFMHyper

    def predict(self, rows: Sequence[Sequence[str]]) -> np.ndarray:
        """Scores of "field:idx:value" string rows on the state's device;
        numpy results."""
        idx, val, fld, _ = _stage_ffm_rows(rows, None, self.hyper)
        return _ffm_scores(self.state, self.hyper, idx, val, fld) \
            .cpu().numpy()

    def model_rows(self):
        """(feature, w) over touched features, and w0."""
        touched = _numpy(self.state.touched) != 0
        feats = np.nonzero(touched)[0]
        return feats, _numpy(self.state.w)[feats], float(self.state.w0)

    def to_blob(self, half_float: bool = True) -> bytes:
        """The JAX package's compressed model blob, byte for byte (the
        FFMPredictionModel.writeExternal analog, ref:
        fm/FFMPredictionModel.java:46,149-200): a header, the linear part
        as utils/codec.encode_sparse_model, and the V rows that differ from
        the seeded initial draw as (delta-zigzag key, k values), deflated;
        the rest is re-derived from the draw at decode, so
        from_blob().predict reproduces this model's predict (bit for bit
        with half_float=False)."""
        import struct as _struct

        from ..utils.codec import (compress_model_blob, encode_sparse_model,
                                   float_to_half, zigzag_leb128_encode_array)

        hy = self.hyper
        feats, w, w0 = self.model_rows()
        w_blob = encode_sparse_model(feats, w, half_float=half_float)
        v = _numpy(self.state.v).astype(np.float32)
        changed = np.nonzero(np.any(v != initial_v(hy), axis=1))[0]
        vkeys = zigzag_leb128_encode_array(np.diff(changed, prepend=0))
        vvals = v[changed].ravel()
        v_bytes = (float_to_half(vvals).tobytes() if half_float
                   else vvals.astype("<f4").tobytes())
        flags = ((1 if hy.linear_coeff else 0)
                 | (2 if hy.global_bias else 0)
                 | (4 if hy.classification else 0)
                 | (8 if half_float else 0))
        header = _struct.pack(
            "<4sBiqqqqfBf", b"HFM1", 1, hy.factors, hy.num_features,
            hy.num_fields, hy.v_dims, hy.seed, hy.sigma, flags, w0)
        v_section = compress_model_blob(
            _struct.pack("<qq", len(changed), len(vkeys)) + vkeys + v_bytes)
        return (header + _struct.pack("<qq", len(w_blob), len(v_section))
                + w_blob + v_section)

    @classmethod
    def from_blob(cls, blob: bytes,
                  device: DeviceLike = None) -> "TrainedFFMModel":
        """Decode a to_blob() emission (of either package) into a servable
        model on ``device`` — the FFMPredictUDF deserialization path (ref:
        fm/FFMPredictUDF.java + FFMPredictionModel.readExternal)."""
        import struct as _struct

        from ..utils.codec import (decode_sparse_model,
                                   decompress_model_blob, half_to_float,
                                   zigzag_leb128_decode_array)

        magic, version, k, d, nf, dv, seed, sigma, flags, w0 = \
            _struct.unpack_from("<4sBiqqqqfBf", blob, 0)
        if magic != b"HFM1" or version != 1:
            raise ValueError("not an FFM model blob")
        off = _struct.calcsize("<4sBiqqqqfBf")
        wlen, vlen = _struct.unpack_from("<qq", blob, off)
        off += 16
        feats, w_sparse = decode_sparse_model(blob[off:off + wlen])
        off += wlen
        v_section = decompress_model_blob(blob[off:off + vlen])
        n_changed, keys_len = _struct.unpack_from("<qq", v_section, 0)
        deltas = zigzag_leb128_decode_array(v_section[16:16 + keys_len],
                                            n_changed)
        vkeys = np.cumsum(np.asarray(deltas, np.int64))
        raw = v_section[16 + keys_len:]
        if flags & 8:
            vvals = half_to_float(
                np.frombuffer(raw, np.float16, count=n_changed * k))
        else:
            vvals = np.frombuffer(raw, "<f4", count=n_changed * k).copy()
        vvals = np.asarray(vvals, np.float32).reshape(n_changed, k)

        hyper = FFMHyper(factors=int(k), classification=bool(flags & 4),
                         global_bias=bool(flags & 2),
                         linear_coeff=bool(flags & 1),
                         num_features=int(d), num_fields=int(nf),
                         v_dims=int(dv), seed=int(seed), sigma=float(sigma))
        dev = resolve_device(device)
        w_full = np.zeros(int(d), np.float32)
        w_full[np.asarray(feats, np.int64)] = w_sparse
        touched = np.zeros(int(d), np.int8)
        touched[np.asarray(feats, np.int64)] = 1
        v = initial_v(hyper)
        v[vkeys] = vvals
        zeros = np.zeros(int(d), np.float32)
        st = ffm_state_from_numpy(
            {"w0": np.float32(w0), "w": w_full, "z": zeros, "n": zeros,
             "v": v, "v_gg": np.zeros(int(dv), np.float32),
             "touched": touched, "step": 0}, dev)
        return cls(state=st, hyper=hyper)


def _stage_ffm_rows(rows, labels, hyper: FFMHyper,
                    b_pad: Optional[int] = None,
                    width_cap: Optional[int] = None):
    """Parse "field:idx:value" rows into padded [B, K] arrays (pad lane:
    idx = num_features, value 0, field 0). K is the widest row's bucket,
    capped at ``width_cap`` (longer rows truncate); ``b_pad`` pads the
    batch with empty rows (the serving engine's buckets)."""
    parsed = [[FMFeature.parse(f, num_features=hyper.num_features,
                               num_fields=hyper.num_fields) for f in row]
              for row in rows]
    width = pad_to_bucket(max((len(r) for r in parsed), default=1))
    if width_cap is not None:
        width = min(width, width_cap)
    B = len(parsed) if b_pad is None else b_pad
    idx = np.full((B, width), hyper.num_features, np.int32)
    val = np.zeros((B, width), np.float32)
    fld = np.zeros((B, width), np.int32)
    for r, row in enumerate(parsed):
        for c, f in enumerate(row[:width]):
            idx[r, c] = f.index % hyper.num_features
            val[r, c] = f.value
            fld[r, c] = (f.field if f.field >= 0 else 0) % hyper.num_fields
    lab = None
    if labels is not None:
        lab = np.asarray(labels, np.float32)
        if hyper.classification:
            lab = np.where(lab > 0, 1.0, -1.0).astype(np.float32)
    return idx, val, fld, lab


def _ffm_options() -> Options:
    o = _fm_options()
    o.add("w0", "global_bias", False, "Include global bias w0 [default: OFF]")
    o.add("disable_wi", "no_coeff", False, "Exclude the linear term")
    o.add("feature_hashing", None, True,
          "Feature hashing bits [18,31] [default 21]", default=21, type=int)
    o.add("num_fields", None, True, "Number of fields [default 1024]",
          default=1024, type=int)
    o.add("disable_adagrad", None, False, "Disable AdaGrad for V")
    o.add("eta0_V", None, True, "Initial learning rate for V [default 1.0]",
          default=1.0, type=float)
    o.add("eps", None, True, "AdaGrad denominator constant [default 1.0]",
          default=1.0, type=float)
    o.add("disable_ftrl", None, False, "Disable FTRL for W")
    o.add("alpha", "alphaFTRL", True, "FTRL alpha [default 0.1]", default=0.1,
          type=float)
    o.add("beta", "betaFTRL", True, "FTRL beta [default 1.0]", default=1.0,
          type=float)
    o.add("lambda1", None, True, "FTRL L1 [default 0.1]", default=0.1,
          type=float)
    o.add("lambda2", None, True, "FTRL L2 [default 0.01]", default=0.01,
          type=float)
    o.add("v_bits", None, True, "log2 size of the hashed V table [default 22]",
          default=22, type=int)
    o.add("row_chunk", None, True,
          "Tile minibatch K^2 pairwise work in chunks of this many rows "
          "(bounds activation memory; 0 = no tiling)", default=0, type=int)
    return o


def ffm_hyper_from_options(cl) -> FFMHyper:
    """FFMHyper of parsed train_ffm options (the JAX package's mapping)."""
    lam = cl.get_float("lambda0", 0.01)
    return FFMHyper(
        factors=cl.get_int("factor", 4),
        classification=True,  # FFM is a CTR classifier; -c accepted for parity
        lambda_w=lam,
        lambda_v=lam,
        global_bias=cl.has("w0"),
        linear_coeff=not cl.has("disable_wi"),
        use_ftrl=not cl.has("disable_ftrl"),
        use_adagrad=not cl.has("disable_adagrad"),
        eta0_v=cl.get_float("eta0_V", 1.0),
        eps=cl.get_float("eps", 1.0),
        alpha=cl.get_float("alpha", 0.1),
        beta=cl.get_float("beta", 1.0),
        lambda1=cl.get_float("lambda1", 0.1),
        lambda2=cl.get_float("lambda2", 0.01),
        sigma=cl.get_float("sigma", 0.1),
        num_features=1 << cl.get_int("feature_hashing", 21),
        num_fields=cl.get_int("num_fields", 1024),
        v_dims=1 << cl.get_int("v_bits", 22),
        eta=get_eta(cl, 0.2),
        seed=cl.get_int("seed", 31),
    )


def train_ffm(rows: Sequence[Sequence[str]], labels,
              options: Optional[str] = None,
              device: DeviceLike = None) -> TrainedFFMModel:
    """Train an FFM on the CUDA device (``device="cpu"`` asks for the CPU)
    from "field:idx:value" string rows. Default ``-mini_batch 1`` is the
    exact per-row scan; ``-mini_batch B`` the minibatch, tiled by
    ``-row_chunk``. ``-mxu_scatter`` with ``-mini_batch`` selects the
    sorted-id backend (`make_ffm_step` update_backend="mxu"); in scan mode
    it is ignored, as in the JAX package."""
    cl = _ffm_options().parse(options, "train_ffm")
    dev = resolve_device(device)
    hyper = ffm_hyper_from_options(cl)
    idx, val, fld, lab = _stage_ffm_rows(rows, labels, hyper)
    mini_batch = cl.get_int("mini_batch", 1)
    mode = "minibatch" if mini_batch > 1 else "scan"
    block = mini_batch if mode == "minibatch" \
        else cl.get_int("block_size", 4096)
    row_chunk = cl.get_int("row_chunk", 0) or None
    if row_chunk is not None:
        # positivity is validated by make_ffm_step (single source)
        if mode != "minibatch":
            raise ValueError("-row_chunk requires -mini_batch > 1 "
                             "(it tiles the minibatch pairwise work)")
        if block % row_chunk != 0:
            raise ValueError(
                f"-mini_batch {block} not divisible by -row_chunk "
                f"{row_chunk}")
    backend = "mxu" if (cl.has("mxu_scatter") and mode == "minibatch") \
        else "xla"
    step = make_ffm_step(hyper, mode, row_chunk=row_chunk,
                         update_backend=backend, device=dev)
    # the trailing partial block (n % block rows) won't divide by
    # row_chunk; it goes through an untiled step (same semantics)
    tail_step = make_ffm_step(hyper, mode, update_backend=backend,
                              device=dev) if row_chunk is not None else step
    state = init_ffm_state(hyper, device=dev)
    iters = cl.get_int("iters", 1)
    conv = ConversionState(not cl.has("disable_cv"),
                           cl.get_float("cv_rate", 0.005))
    n = len(rows)
    for _ in range(max(1, iters)):
        # block losses stay on the device; ONE transfer per epoch, summed
        # on the host in block order as the JAX loop does
        losses = []
        for s in range(0, n, block):
            e = min(s + block, n)
            use = step if (row_chunk is None or (e - s) % row_chunk == 0) \
                else tail_step
            state, loss = use(state, idx[s:e], val[s:e], fld[s:e], lab[s:e])
            losses.append(loss)
        conv.incr_loss(sum(torch.stack(losses).cpu().tolist()) if losses
                       else 0.0)
        if iters > 1 and conv.is_converged(n):
            break
    return TrainedFFMModel(state=state, hyper=hyper)


def ffm_predict(model: TrainedFFMModel,
                rows: Sequence[Sequence[str]]) -> np.ndarray:
    """`ffm_predict` equivalent (ref: fm/FFMPredictUDF.java deserializes the
    compressed model; here the trained model object scores directly)."""
    return model.predict(rows)
