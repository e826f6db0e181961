"""Histogram-based decision-tree growth (classification + regression) — the
port of `hivemall_tpu/models/trees/grow.py`.

One tree level = ONE scatter-add in lane order (on the card a stable
sort of the lanes by bin and a sequential sum per bin) building
per-(node, feature, bin) histograms + one split evaluation over the
whole frontier + one routing step, on the device; the host walks the
(tiny) frontier bookkeeping and reads each level's split decisions in ONE
device-to-host copy (``SYNCS["grow"]`` counts them). The JAX package's
functions are plain XLA (no Pallas kernel), so these are plain torch ops.

Split criteria: GINI or ENTROPY for classification (the reference's -rule
option, RandomForestClassifierUDTF.java:130), variance reduction for
regression. Nominal features split by equality (bin == v), numeric by
threshold (bin <= v), mirroring the reference's NOMINAL/NUMERIC split types.

Where the port differs in form, never in result:

- **Dropped lanes.** JAX drops the lanes of settled rows (``assign < 0``)
  with ``mode="drop"`` at an index past the table; here a settled row's
  slot becomes a sink slot past the frontier, whose lanes sort after the
  last bin and are never summed. No index is ever clamped into a live
  bin.
- **Hoisting.** A histogram lane's offset inside its slot's ``[F, B(, C)]``
  block, and its broadcast weight (and target terms), do not change from
  level to level: the growers build them once per tree (per forest for the
  offsets) and a level computes ``slot * block + offset`` only.
- **Groups.** ``grow_forest(strategy="batched")`` chunks the trees of a
  level exactly as JAX does (power-of-two ``G`` under
  ``hist_budget_bytes``), but eager torch needs no fixed shapes, so a chunk
  holds only its real trees: there are no dummy slots to drop.
- **Summation order.** The JAX package's sums on the CPU follow XLA's
  rewrites: a reduction longer than 32 runs as sequential 32-long windows
  (the padding split between both ends) and then a reduction of the window
  sums; a cumulative sum longer than 16 as sequential 16-long blocks plus a
  cumulative sum of the block totals. The split search sums in that same
  order with explicit adds (``_ordered_sum``, ``_ordered_cumsum``), so
  float histograms — regression targets, GBT residuals — pick the same
  splits as JAX on the CPU. (torch's own CPU ``cumsum`` accumulates float32
  in float64, and its ``sum`` in cascades.) XLA also contracts the
  classification gain's multiply-adds into fused multiply-adds (``Σ p²``,
  ``imp_l * n_l + imp_r * n_r`` and ``imp_p * n_p - child``); the port
  computes those in float64 and rounds once to float32 (``_fma``), the
  same value on the CPU and the card. Entropy's ``log2`` is evaluated as
  ``jnp.log2`` lowers on the CPU: XLA's own ``log`` (Cephes logf, its
  multiply-adds fused; ``_xla_log``) times the float32 reciprocal of
  ``log(2)``. So gini and entropy gains both equal JAX's bit for bit.
- **The walk** (``predict_forest_binned``) takes ``min(depth of the stacked
  trees, max_depth)`` steps instead of ``max_depth``: a row at a leaf stays
  there, so the answer is the same with fewer launches, and a tree deeper
  than ``max_depth`` still stops at an internal node, as in JAX.

Exactness: every histogram bin adds its lanes in lane order
(``_scatter_hist``; on the card through ``_ordered_hist``), the order of
the CPU's ``index_add_`` and of XLA's CPU scatter. So the card grows the
CPU's trees node for node, float targets and GBT residuals included, and
two card runs grow the same trees.

**Row-sharded growth** (``row_shard=(mesh, axis)``, `RowShard`): every
rank holds all the rows and grows the same tree; each builds the partial
histogram of its own slice of the rows (the slices of JAX's row sharding,
rows padded to a multiple of the axis size) in the order above, and ONE
all_reduce a level (a chunk, in a batched group) sums the partials
(`_sharded_hist`). The split search then runs on the global histogram, so
growth is the single-rank growth up to the order of that sum: exact for
integer-valued histograms (classification counts), within float rounding
for GBT residuals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.collectives import Mesh, psum
from ...device import DeviceLike, resolve_device
from ...utils.jax_prng import _LOG_P, _LOG_Q1, _LOG_Q2
from ...utils.jax_prng import _xla_log as _np_xla_log

NEG = -1e30

# device-to-host copies made by the growers (one per level, per chunk for
# a batched group) and by the walks' callers in forest.py
SYNCS = {"grow": 0, "walk": 0}


# (mesh, axis_name): histogram builds over rank-sharded rows with one
# all_reduce; see _sharded_hist
RowShard = Tuple[Mesh, str]


@dataclass
class TreeArrays:
    """Array-form tree; node 0 is the root. feature == -1 marks leaves."""

    feature: np.ndarray  # [M] int32
    threshold_bin: np.ndarray  # [M] int32 (bin id)
    nominal: np.ndarray  # [M] bool
    left: np.ndarray  # [M] int32
    right: np.ndarray  # [M] int32
    leaf_dist: Optional[np.ndarray]  # [M, C] classification posteriors
    leaf_value: np.ndarray  # [M] regression output / argmax class
    n_nodes: int
    # accumulated impurity gain per feature (the reference's variable
    # importance, RandomForestClassifierUDTF importance accumulation)
    importance: Optional[np.ndarray] = None

    @property
    def max_depth_used(self) -> int:
        # depth via BFS
        depth = {0: 0}
        best = 0
        for i in range(self.n_nodes):
            d = depth.get(i, 0)
            best = max(best, d)
            if self.feature[i] >= 0:
                depth[int(self.left[i])] = d + 1
                depth[int(self.right[i])] = d + 1
        return best


def _on(x, dtype, dev: torch.device) -> torch.Tensor:
    """numpy or tensor -> tensor of ``dtype`` on ``dev`` (no copy when it
    already is one)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def _to_host(t: torch.Tensor, kind: str) -> np.ndarray:
    SYNCS[kind] += 1
    return t.cpu().numpy()


# ---- histograms -------------------------------------------------------------

def _lane_offsets(Xb, B: int, C: int = 0, y=None) -> torch.Tensor:
    """[N, F] int64 offset of each (row, feature) lane inside one slot's
    histogram block: ``f * B + Xb[n, f]``, times C plus the class for
    classification — JAX's flat index less its ``slot * block`` term."""
    F = Xb.shape[1]
    off = torch.arange(F, device=Xb.device) * B + Xb.long()
    if C:
        off = off * C + y.long()[:, None]
    return off


def _lanes(v: torch.Tensor, F: int) -> torch.Tensor:
    """A per-row vector ([N] or [G, N]) broadcast over the F feature lanes
    and flattened, as JAX's ``broadcast_to(v[..., None], (..., F))``."""
    return v[..., None].expand(*v.shape, F).reshape(-1)


def _reg_values(W: torch.Tensor, y: torch.Tensor, F: int, group: bool):
    """(count, sum, sumsq) lane values with JAX's own rounding: ``w * y`` and
    ``w * (y * y)`` for one tree, ``w * y * y`` for a group."""
    sq = W * y * y if group else W * (y * y)
    return _lanes(W, F), _lanes(W * y, F), _lanes(sq, F)


def _scatter_hist(offsets, slot, n_slots: int, block: int, values):
    """Sum each lane vector of ``values`` into ``[n_slots * block]`` at
    ``slot * block + offset``; a negative slot (a settled row) goes to a
    sink slot past the table, cut off after. ``slot`` is [N] or [G, N]
    (already offset by tree), ``offsets`` [N, F]. Returns
    [len(values), n_slots * block] f32.

    Every bin adds its lanes in lane order, from 0.0, one add at a time —
    the order of XLA's CPU scatter — on both devices. The CPU's
    ``index_add_`` adds in that order by itself; CUDA's adds in atomic
    order, so on the card `_ordered_hist` sums instead. Float histograms
    are then the same on every run and on both devices, with no float
    atomics and no process-wide flag."""
    slot = torch.where(slot >= 0, slot, n_slots).long()
    flat = (slot[..., None] * block + offsets).reshape(-1)
    if flat.device.type != "cpu":
        return _ordered_hist(flat, values, n_slots * block)
    out = torch.zeros((len(values), (n_slots + 1) * block),
                      dtype=torch.float32)
    for k, v in enumerate(values):
        out[k].index_add_(0, flat, v)
    return out[:, :n_slots * block]


def _ordered_hist(flat, values, size: int) -> torch.Tensor:
    """[len(values), size] sums of each lane vector at ``flat``, lanes at
    or past ``size`` dropped, each bin adding its lanes in lane order from
    0.0: a stable sort groups the lanes by bin without reordering them,
    and ``segment_reduce`` over a ``[lanes, 1]`` column runs one
    sequential loop per bin (on CUDA, a thread a bin)."""
    order = torch.argsort(flat, stable=True)
    bounds = torch.searchsorted(flat[order], torch.arange(
        size + 1, device=flat.device))
    return torch.stack([
        torch.segment_reduce(v[order][:, None], "sum", offsets=bounds,
                             axis=0, unsafe=True, initial=0.0)[:, 0]
        for v in values])


def _sharded_hist(offsets, slot, n_slots: int, block: int, values,
                  row_shard: Optional[RowShard]):
    """`_scatter_hist`; with ``row_shard``, of this rank's rows only (rank
    r of n holds rows [r * ceil(N / n), (r + 1) * ceil(N / n)), JAX's
    padded row sharding), then summed over the axis in one all_reduce.
    The rank's lanes keep their order, so each bin of its partial adds
    them as the unsharded build adds the same rows."""
    if row_shard is None:
        return _scatter_hist(offsets, slot, n_slots, block, values)
    mesh, axis = row_shard
    n_rows, F = offsets.shape
    per = -(-n_rows // mesh.shape[axis])
    lo = mesh.index(axis) * per
    hi = min(lo + per, n_rows)
    mine = [v.reshape(*slot.shape, F)[..., lo:hi, :].reshape(-1)
            for v in values]
    sums = _scatter_hist(offsets[lo:hi], slot[..., lo:hi], n_slots, block,
                         mine)
    return psum(sums, mesh, axis)


def _reg_stats(sums, n_slots: int, F: int, B: int) -> torch.Tensor:
    return sums.t().reshape(n_slots, F, B, 3)


def _group_slots(assign, S: int) -> torch.Tensor:
    """[G, N] frontier slots -> slots of the flattened (tree, slot) axis."""
    tid = torch.arange(assign.shape[0], device=assign.device)[:, None]
    return torch.where(assign >= 0, tid * S + assign, -1)


def _hist_classification(Xb, y, w, assign, S: int, B: int, C: int):
    """[S, F, B, C] weighted class histograms for the current frontier."""
    F = Xb.shape[1]
    sums = _scatter_hist(_lane_offsets(Xb, B, C, y), assign, S, F * B * C,
                         (_lanes(w, F),))
    return sums[0].reshape(S, F, B, C)


def _hist_regression(Xb, y, w, S: int, B: int, assign=None):
    """[S, F, B, 3] (count, sum, sumsq) histograms."""
    F = Xb.shape[1]
    sums = _scatter_hist(_lane_offsets(Xb, B), assign, S, F * B,
                         _reg_values(w, y, F, group=False))
    return _reg_stats(sums, S, F, B)


def _hist_classification_forest(Xb, y, W, assign, S: int, B: int, C: int):
    """Class histograms for a GROUP of trees in one scatter.

    Xb [N,F] shared binned rows; W [G,N] per-tree bootstrap weights;
    assign [G,N] per-tree frontier slots. Returns [G*S, F, B, C] laid out so
    the single-tree split functions apply unchanged over the flattened
    (tree, slot) axis."""
    F = Xb.shape[1]
    G = W.shape[0]
    sums = _scatter_hist(_lane_offsets(Xb, B, C, y), _group_slots(assign, S),
                         G * S, F * B * C, (_lanes(W, F),))
    return sums[0].reshape(G * S, F, B, C)


def _hist_regression_forest(Xb, y, W, assign, S: int, B: int):
    """[G*S, F, B, 3] (count, sum, sumsq) histograms for a group of trees.
    y is [G, N] — per-tree targets (GBT grows K class-trees per round on
    different residuals; plain forests broadcast one target row)."""
    F = Xb.shape[1]
    G = W.shape[0]
    sums = _scatter_hist(_lane_offsets(Xb, B), _group_slots(assign, S),
                         G * S, F * B, _reg_values(W, y, F, group=True))
    return _reg_stats(sums, G * S, F, B)


# ---- split search -----------------------------------------------------------

# the JAX package's summation order on the CPU (module docstring)
_SUM_WINDOW = 32
_SCAN_BLOCK = 16


def _ordered_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in XLA's CPU order: sequential adds up to 32
    elements; beyond, sequential 32-long windows (zero padding split
    between both ends), then the window sums the same way."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SUM_WINDOW:
        s = x[..., 0]
        for i in range(1, n):
            s = s + x[..., i]
        return s
    nw = -(-n // _SUM_WINDOW)
    pad = nw * _SUM_WINDOW - n
    x = TF.pad(x, (pad // 2, pad - pad // 2))
    return _ordered_sum(_ordered_sum(
        x.reshape(*x.shape[:-1], nw, _SUM_WINDOW)))


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis in XLA's CPU order:
    sequential up to 16 elements; beyond, sequential 16-long blocks plus
    the prefix of the block totals."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, -1)
    nb = -(-n // _SCAN_BLOCK)
    inb = _prefix(TF.pad(x, (0, nb * _SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, _SCAN_BLOCK))
    off = _prefix(inb[..., -1])
    off = torch.cat([torch.zeros_like(off[..., :1]), off[..., :-1]], -1)
    return (inb + off[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _ordered_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _prefix(x.movedim(dim, -1)).movedim(-1, dim)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (exact products in float64)."""
    return (a.double() * b.double() + c.double()).float()  # graftcheck: disable=G003 (exact float64 products, one f32 rounding: _xla_log's bit-equal entropy)


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU code computes it: the torch form of
    ``utils/jax_prng._xla_log`` (Cephes logf: frexp, one sqrt(1/2) fold, a
    degree-8 polynomial whose multiply-adds are fused)."""
    x = torch.clamp(x, min=1.17549435e-38)
    m, e = torch.frexp(x)
    e = e.float()
    fold = m < 0.707106781186547524
    t = m - 1.0
    e = e - fold.float()
    t = t + torch.where(fold, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    c = [torch.tensor(v, dtype=torch.float32) for v in _LOG_P]
    y = _fma(_fma(c[0], t, c[1]), t, c[2])
    y1 = _fma(_fma(c[3], t, c[4]), t, c[5])
    y2 = _fma(_fma(c[6], t, c[7]), t, c[8])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * _LOG_Q1)
    t = _fma(t2, torch.tensor(-0.5), t)
    t = t + y
    return _fma(e, torch.tensor(_LOG_Q2), t)


# jnp.log2(x) on the CPU: log(x) / log(2), the division by a constant
# folded into a multiply by its float32 reciprocal
_INV_LN2 = float(np.float32(1.0) / _np_xla_log(np.float32(2.0)))


def _impurity_parts(counts, rule: str):
    """counts [..., C] -> (impurity, n); impurity * n is additive over
    parent and children."""
    n = _ordered_sum(counts)
    p = counts / torch.clamp(n, min=1e-12)[..., None]
    if rule == "entropy":
        log2 = _xla_log(torch.clamp(p, min=1e-12)) * _INV_LN2
        return -_ordered_sum(torch.where(p > 0, p * log2, 0.0)), n
    sq = p[..., 0] * p[..., 0]  # Σ p² as XLA's fused multiply-add chain
    for c in range(1, p.shape[-1]):
        sq = _fma(p[..., c], p[..., c], sq)
    return 1.0 - sq, n


def _impurity(counts, rule: str):
    """counts [..., C] -> impurity * n (so parent/child weighting is additive)."""
    imp, n = _impurity_parts(counts, rule)
    return imp * n


def _pick(gain, nominal_mask, feat_ok, valid):
    """Mask invalid (feature, bin) candidates to NEG and take the first
    maximum per slot: (best gain, feature, bin)."""
    S, F, B = gain.shape
    # numeric cannot split on the last bin (empty right side by construction)
    last_bin = torch.arange(B, device=gain.device)[None, None, :] == (B - 1)
    valid = valid & ~(last_bin & ~nominal_mask[None, :, None])
    valid = valid & feat_ok[:, :, None]
    flat = torch.where(valid, gain, NEG).reshape(S, F * B)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
    return best_gain, best // B, best % B


def _best_split_classification(hist, nominal_mask, feat_ok, rule: str,
                               min_leaf: float = 1.0):
    """hist [S,F,B,C]; nominal_mask [F] bool; feat_ok [S,F] per-node random
    subspace. Returns per slot: gain, feature, bin, node class counts [C]."""
    total = _ordered_sum(hist, 2)  # [S, F, C] (same per F)
    node_counts = total[:, 0, :]  # [S, C]
    imp_p, n_p = _impurity_parts(node_counts, rule)  # [S]

    cum = _ordered_cumsum(hist, 2)  # [S,F,B,C] numeric left counts
    nom = nominal_mask[None, :, None, None]
    left = torch.where(nom, hist, cum)
    right = total[:, :, None, :] - left

    imp_l, nl = _impurity_parts(left, rule)
    imp_r, nr = _impurity_parts(right, rule)
    child_imp = _fma(imp_l, nl, imp_r * nr)  # [S,F,B]
    gain = _fma(imp_p[:, None, None], n_p[:, None, None], -child_imp)
    best_gain, bf, bb = _pick(gain, nominal_mask, feat_ok,
                              (nl >= min_leaf) & (nr >= min_leaf))
    return best_gain, bf, bb, node_counts


def _best_split_regression(stats, nominal_mask, feat_ok, min_leaf: float = 1.0):
    """stats [S,F,B,3] -> variance-reduction split. Returns gain, f, b, and
    (count, mean) per slot."""
    total = _ordered_sum(stats, 2)  # [S,F,3]
    node_stats = total[:, 0, :]  # [S,3]

    def sse(st):
        cnt, s, s2 = st[..., 0], st[..., 1], st[..., 2]
        return s2 - torch.where(cnt > 0, s * s / torch.clamp(cnt, min=1e-12),
                                0.0)

    parent = sse(node_stats)
    cum = _ordered_cumsum(stats, 2)
    left = torch.where(nominal_mask[None, :, None, None], stats, cum)
    right = total[:, :, None, :] - left
    gain = parent[:, None, None] - (sse(left) + sse(right))
    best_gain, bf, bb = _pick(gain, nominal_mask, feat_ok,
                              (left[..., 0] >= min_leaf)
                              & (right[..., 0] >= min_leaf))
    mean = node_stats[:, 1] / torch.clamp(node_stats[:, 0], min=1e-12)
    return best_gain, bf, bb, node_stats[:, 0], mean


def _split_to_host(split):
    """A split search's outputs in ONE device-to-host copy: gain [S] f32,
    feature / bin [S] int32, and the class counts [S, C] (classification)
    or the node sizes and means [S] (regression). Feature and bin ids ride
    the f32 copy exactly (both < 2^24)."""
    gain, bf, bb = split[:3]
    cols = [gain[:, None], bf[:, None].float(), bb[:, None].float()]
    cols += [t if t.dim() == 2 else t[:, None] for t in split[3:]]
    out = _to_host(torch.cat(cols, 1), "grow")
    head = (out[:, 0], out[:, 1].astype(np.int32), out[:, 2].astype(np.int32))
    if len(split) == 4:
        return head + (out[:, 3:],)
    return head + (out[:, 3], out[:, 4])


# ---- routing ----------------------------------------------------------------

def _bins_at(Xb: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Xb[n, f[..., n]] for f [..., N]: each row's bin on its own feature."""
    N, F = Xb.shape
    rows = torch.arange(N, device=Xb.device) * F
    return Xb.reshape(-1)[rows + f.long()]


def _route(Xb, assign, feat, thr, nominal, leftslot, rightslot, isleaf):
    """Route rows to next-level slots (-1 = settled in a leaf). One tree:
    assign [N] and tables [S]; a group of trees: assign [G, N] and tables
    [G, S] (JAX's vmapped form)."""
    if assign.dim() == 1:
        return _route(Xb, assign[None], feat[None], thr[None], nominal[None],
                      leftslot[None], rightslot[None], isleaf[None])[0]
    slot = torch.clamp(assign, min=0).long()
    f = torch.gather(feat, 1, slot)
    t = torch.gather(thr, 1, slot)
    b = _bins_at(Xb, f)
    go_left = torch.where(torch.gather(nominal, 1, slot), b == t, b <= t)
    nxt = torch.where(go_left, torch.gather(leftslot, 1, slot),
                      torch.gather(rightslot, 1, slot))
    nxt = torch.where(torch.gather(isleaf, 1, slot), -1, nxt)
    return torch.where(assign < 0, -1, nxt)


def _route_tables(feat, thr, nom, leftslot, rightslot, isleaf, dev):
    """The six host routing tables in ONE host-to-device copy, as
    (feat, thr, nominal, leftslot, rightslot, isleaf) int32 / bool views."""
    tab = torch.from_numpy(np.stack([
        feat, thr, nom.astype(np.int32), leftslot, rightslot,
        isleaf.astype(np.int32)])).to(dev)
    return (tab[0], tab[1], tab[2].bool(), tab[3], tab[4], tab[5].bool())


# ---- growth -----------------------------------------------------------------

def _feature_subspace(S_pad: int, S: int, F: int, num_vars, rng):
    """[S_pad, F] candidate features of the S frontier nodes, drawn node by
    node from the tree's own rng (the reference samples numVars candidates
    per node); padded slots get none, and nothing reads their split."""
    feat_ok = np.zeros((S_pad, F), bool)
    if num_vars is None or num_vars >= F:
        feat_ok[:S] = True
        return feat_ok
    for s in range(S):
        feat_ok[s, rng.choice(F, size=num_vars, replace=False)] = True
    return feat_ok


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def grow_tree(
    Xb,  # [N, F] int32 binned (numpy, or a tensor already on the device)
    y,  # [N] int (classification) or float (regression)
    w,  # [N] float32 bootstrap weights
    nominal_mask: np.ndarray,  # [F] bool
    n_bins: int,
    *,
    classification: bool,
    n_classes: int = 0,
    rule: str = "gini",
    max_depth: int = 10,
    min_split: int = 2,
    min_leaf: int = 1,
    max_leaf_nodes: int = 512,
    num_vars: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
    row_shard=None,
    device: DeviceLike = None,
) -> TreeArrays:
    """Level-wise growth; per-node random feature subspace of size `num_vars`
    (the reference samples numVars candidates per node, DecisionTree.java).
    Runs on ``device`` (None: the CUDA device, or a RuntimeError when there
    is none). ``row_shard=(mesh, axis)``: the histograms build over the
    axis' ranks (module docstring); every rank passes the same rows and
    rng and grows the same tree."""
    dev = resolve_device(device)
    rng = rng or np.random.RandomState(0)
    N, F = Xb.shape
    C = n_classes if classification else 0
    Xbt = _on(Xb, torch.int32, dev)
    yt = _on(y, torch.int32 if classification else torch.float32, dev)
    wt = _on(w, torch.float32, dev)
    nomt = _on(np.asarray(nominal_mask, bool), torch.bool, dev)
    nominal_mask = np.asarray(nominal_mask, bool)
    offsets = _lane_offsets(Xbt, n_bins, C, yt)
    values = ((_lanes(wt, F),) if classification
              else _reg_values(wt, yt, F, group=False))
    block = F * n_bins * (C or 1)

    # host node table
    feature: List[int] = []
    thr: List[int] = []
    nom: List[bool] = []
    left: List[int] = []
    right: List[int] = []
    dists: List[np.ndarray] = []
    values_out: List[float] = []
    importance = np.zeros(F)

    def new_node():
        feature.append(-1)
        thr.append(0)
        nom.append(False)
        left.append(-1)
        right.append(-1)
        dists.append(None)
        values_out.append(0.0)
        return len(feature) - 1

    root = new_node()
    frontier = [root]  # node ids for current slots
    assign = torch.zeros(N, dtype=torch.int32, device=dev)
    n_leaves = 1

    for depth in range(max_depth + 1):
        S = len(frontier)
        if S == 0:
            break
        # the frontier pads to the next power of two, as in JAX (where it
        # bounds the compiled shapes); padded slots are empty leaves
        S_pad = _pow2(S)
        feat_ok = _on(_feature_subspace(S_pad, S, F, num_vars, rng),
                      torch.bool, dev)
        sums = _sharded_hist(offsets, assign, S_pad, block, values,  # graftcheck: disable=G036 (psum copies through the host only when gloo reduces CUDA tensors; NCCL sums on the card)
                             row_shard)
        if classification:
            gain, bf, bb, counts = _split_to_host(_best_split_classification(
                sums[0].reshape(S_pad, F, n_bins, C), nomt, feat_ok, rule,
                float(min_leaf)))
            node_sizes = counts.sum(-1)
        else:
            gain, bf, bb, node_sizes, means = _split_to_host(
                _best_split_regression(_reg_stats(sums, S_pad, F, n_bins),
                                       nomt, feat_ok, float(min_leaf)))

        # decide splits on host (tiny); build next frontier (padded slots
        # stay leaves)
        isleaf = np.ones(S_pad, bool)
        leftslot = np.full(S_pad, -1, np.int32)
        rightslot = np.full(S_pad, -1, np.int32)
        next_frontier: List[int] = []
        for s, nid in enumerate(frontier):
            if classification:
                dists[nid] = counts[s]
                values_out[nid] = float(np.argmax(counts[s]))
            else:
                values_out[nid] = float(means[s])
            can_split = (
                depth < max_depth
                and gain[s] > 1e-7
                and node_sizes[s] >= min_split
                and n_leaves < max_leaf_nodes
            )
            if not can_split:
                continue
            isleaf[s] = False
            feature[nid] = int(bf[s])
            thr[nid] = int(bb[s])
            nom[nid] = bool(nominal_mask[bf[s]])
            importance[feature[nid]] += float(gain[s])
            l, r = new_node(), new_node()
            left[nid], right[nid] = l, r
            leftslot[s] = len(next_frontier)
            next_frontier.append(l)
            rightslot[s] = len(next_frontier)
            next_frontier.append(r)
            n_leaves += 1  # one leaf became two

        if not next_frontier:
            break
        feat_arr = np.zeros(S_pad, np.int32)
        thr_arr = np.zeros(S_pad, np.int32)
        nom_arr = np.zeros(S_pad, bool)
        for s, nid in enumerate(frontier):
            feat_arr[s] = feature[nid] if feature[nid] >= 0 else 0
            thr_arr[s] = thr[nid]
            nom_arr[s] = nom[nid]
        assign = _route(Xbt, assign, *_route_tables(
            feat_arr, thr_arr, nom_arr, leftslot, rightslot, isleaf, dev))
        frontier = next_frontier

    M = len(feature)
    leaf_dist = None
    if classification:
        leaf_dist = np.zeros((M, C), np.float32)
        for i, d in enumerate(dists):
            if d is not None:
                leaf_dist[i] = d
    return TreeArrays(
        feature=np.asarray(feature, np.int32),
        threshold_bin=np.asarray(thr, np.int32),
        nominal=np.asarray(nom, bool),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        leaf_dist=leaf_dist,
        leaf_value=np.asarray(values_out, np.float32),
        n_nodes=M,
        importance=importance,
    )


class _TreeBuild:
    """Host-side bookkeeping for one tree growing inside a forest group."""

    __slots__ = ("feature", "thr", "nom", "left", "right", "dists", "values",
                 "importance", "frontier", "n_leaves", "rng")

    def __init__(self, rng, n_features: int):
        self.feature: List[int] = []
        self.thr: List[int] = []
        self.nom: List[bool] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.dists: List[Optional[np.ndarray]] = []
        self.values: List[float] = []
        self.importance = np.zeros(n_features)
        self.rng = rng
        self.frontier = [self.new_node()]
        self.n_leaves = 1

    def new_node(self) -> int:
        self.feature.append(-1)
        self.thr.append(0)
        self.nom.append(False)
        self.left.append(-1)
        self.right.append(-1)
        self.dists.append(None)
        self.values.append(0.0)
        return len(self.feature) - 1

    def finish(self, classification: bool, n_classes: int) -> TreeArrays:
        M = len(self.feature)
        leaf_dist = None
        if classification:
            leaf_dist = np.zeros((M, n_classes), np.float32)
            for i, d in enumerate(self.dists):
                if d is not None:
                    leaf_dist[i] = d
        return TreeArrays(
            feature=np.asarray(self.feature, np.int32),
            threshold_bin=np.asarray(self.thr, np.int32),
            nominal=np.asarray(self.nom, bool),
            left=np.asarray(self.left, np.int32),
            right=np.asarray(self.right, np.int32),
            leaf_dist=leaf_dist,
            leaf_value=np.asarray(self.values, np.float32),
            n_nodes=M,
            importance=self.importance,
        )


def grow_forest(
    Xb,  # [N, F] int32 binned (shared by all trees)
    y,  # [N] int (classification) or float (regression); [T, N] targets
    W,  # [T, N] float32 per-tree bootstrap weights
    nominal_mask: np.ndarray,
    n_bins: int,
    *,
    classification: bool,
    n_classes: int = 0,
    rule: str = "gini",
    max_depth: int = 10,
    min_split: int = 2,
    min_leaf: int = 1,
    max_leaf_nodes: int = 512,
    num_vars: Optional[int] = None,
    rngs: Optional[Sequence[np.random.RandomState]] = None,
    hist_budget_bytes: int = 1 << 26,
    row_shard=None,
    strategy: str = "auto",
    device: DeviceLike = None,
) -> List[TreeArrays]:
    """Grow ALL trees of a forest.

    Two strategies, IDENTICAL results (each tree draws its per-node feature
    subspace from its OWN rng, so both reproduce `grow_tree(..., rng=r_t)`
    exactly — parity-tested):

    - "per_tree": loop `grow_tree` — the direct analog of the reference's
      one-TrainingTask-per-tree thread pool
      (ref: smile/utils/SmileTaskExecutor.java:63-78).
    - "batched": level-synchronous — per level, ONE scatter-add builds the
      (node, feature, bin) histograms of a chunk of trees and one split
      search scores every split. The trees of a level are chunked so the
      histogram stays under `hist_budget_bytes` (``G`` a power of two, as
      in JAX).
    - "auto" (default): per_tree unless `row_shard` is set, as in JAX.

    ``row_shard=(mesh, axis)``: each level's histograms build over the
    axis' ranks with one all_reduce a chunk (module docstring).

    Runs on ``device`` (None: the CUDA device, or a RuntimeError when there
    is none); the binned rows and targets go to the device once."""
    if strategy not in ("auto", "batched", "per_tree"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "auto":
        strategy = "batched" if row_shard is not None else "per_tree"
    dev = resolve_device(device)
    y = np.asarray(y)
    W = np.asarray(W)
    # ONE copy of the default-rng policy for both strategies — the
    # IDENTICAL-results guarantee depends on it
    rngs = list(rngs) if rngs is not None else [
        np.random.RandomState(t) for t in range(W.shape[0])]
    per_tree_y = (not classification) and y.ndim == 2
    Xbt = _on(Xb, torch.int32, dev)
    yt = _on(y, torch.int32 if classification else torch.float32, dev)
    if strategy == "per_tree":
        return [
            grow_tree(Xbt, yt[t] if per_tree_y else yt, W[t],
                      nominal_mask, n_bins, classification=classification,
                      n_classes=n_classes, rule=rule, max_depth=max_depth,
                      min_split=min_split, min_leaf=min_leaf,
                      max_leaf_nodes=max_leaf_nodes, num_vars=num_vars,
                      rng=rngs[t], row_shard=row_shard, device=dev)
            for t in range(W.shape[0])]
    N, F = Xbt.shape
    T = W.shape[0]
    C = n_classes if classification else 0
    stat_w = n_classes if classification else 3
    Wt = _on(W, torch.float32, dev)
    nominal_mask = np.asarray(nominal_mask, bool)
    nomt = _on(nominal_mask, torch.bool, dev)
    offsets = _lane_offsets(Xbt, n_bins, C, yt if classification else None)
    block = F * n_bins * (C or 1)

    builds = [_TreeBuild(rngs[t], F) for t in range(T)]
    assign = torch.zeros((T, N), dtype=torch.int32, device=dev)

    for depth in range(max_depth + 1):
        # sort active trees by frontier size so chunks group similar shapes
        # and each chunk pads S only to ITS largest frontier
        act = sorted((t for t in range(T) if builds[t].frontier),
                     key=lambda t: -len(builds[t].frontier))
        if not act:
            break
        c0 = 0
        while c0 < len(act):
            S_pad = _pow2(len(builds[act[c0]].frontier))
            # chunk the tree axis so [G, S, F, B, C] fits the budget; G is
            # a power of two, as in JAX
            per_tree = S_pad * F * n_bins * stat_w * 4
            G = max(1, min(64, len(act) - c0,
                           hist_budget_bytes // max(per_tree, 1)))
            while G & (G - 1):
                G &= G - 1
            chunk = act[c0:c0 + G]
            c0 += G
            g = len(chunk)
            idx = torch.as_tensor(chunk, device=dev)
            W_c = Wt[idx]
            a_c = assign[idx]

            feat_ok = np.zeros((g * S_pad, F), bool)
            for ci, t in enumerate(chunk):
                b = builds[t]
                feat_ok[ci * S_pad:(ci + 1) * S_pad] = _feature_subspace(
                    S_pad, len(b.frontier), F, num_vars, b.rng)
            feat_okt = _on(feat_ok, torch.bool, dev)

            slots = _group_slots(a_c, S_pad)
            if classification:
                sums = _sharded_hist(offsets, slots, g * S_pad, block,  # graftcheck: disable=G036 (psum copies through the host only when gloo reduces CUDA tensors; NCCL sums on the card)
                                     (_lanes(W_c, F),), row_shard)
                gain, bf, bb, counts = _split_to_host(
                    _best_split_classification(
                        sums[0].reshape(g * S_pad, F, n_bins, C), nomt,
                        feat_okt, rule, float(min_leaf)))
                node_sizes = counts.sum(-1)
            else:
                y_c = yt[idx] if per_tree_y else yt[None, :].expand(g, N)
                sums = _sharded_hist(offsets, slots, g * S_pad, block,  # graftcheck: disable=G036 (psum copies through the host only when gloo reduces CUDA tensors; NCCL sums on the card)
                                     _reg_values(W_c, y_c, F, group=True),
                                     row_shard)
                gain, bf, bb, node_sizes, means = _split_to_host(
                    _best_split_regression(
                        _reg_stats(sums, g * S_pad, F, n_bins), nomt,
                        feat_okt, float(min_leaf)))

            # host split decisions per tree (same policy as grow_tree)
            isleaf = np.ones((g, S_pad), bool)
            leftslot = np.full((g, S_pad), -1, np.int32)
            rightslot = np.full((g, S_pad), -1, np.int32)
            feat_arr = np.zeros((g, S_pad), np.int32)
            thr_arr = np.zeros((g, S_pad), np.int32)
            nom_arr = np.zeros((g, S_pad), bool)
            any_next = False
            for ci, t in enumerate(chunk):
                b = builds[t]
                frontier = b.frontier
                next_frontier: List[int] = []
                for s, nid in enumerate(frontier):
                    k = ci * S_pad + s
                    if classification:
                        b.dists[nid] = counts[k]
                        b.values[nid] = float(np.argmax(counts[k]))
                    else:
                        b.values[nid] = float(means[k])
                    can_split = (
                        depth < max_depth
                        and gain[k] > 1e-7
                        and node_sizes[k] >= min_split
                        and b.n_leaves < max_leaf_nodes
                    )
                    if not can_split:
                        continue
                    isleaf[ci, s] = False
                    b.feature[nid] = int(bf[k])
                    b.thr[nid] = int(bb[k])
                    b.nom[nid] = bool(nominal_mask[bf[k]])
                    b.importance[b.feature[nid]] += float(gain[k])
                    l, r = b.new_node(), b.new_node()
                    b.left[nid], b.right[nid] = l, r
                    leftslot[ci, s] = len(next_frontier)
                    next_frontier.append(l)
                    rightslot[ci, s] = len(next_frontier)
                    next_frontier.append(r)
                    b.n_leaves += 1
                    feat_arr[ci, s] = b.feature[nid]
                    thr_arr[ci, s] = b.thr[nid]
                    nom_arr[ci, s] = b.nom[nid]
                b.frontier = next_frontier
                any_next = any_next or bool(next_frontier)

            if any_next:
                assign[idx] = _route(Xbt, a_c, *_route_tables(
                    feat_arr, thr_arr, nom_arr, leftslot, rightslot, isleaf,
                    dev))

    return [b.finish(classification, n_classes) for b in builds]


# ---- prediction -------------------------------------------------------------

def stack_trees(trees, device: DeviceLike = None) -> dict:
    """Pad per-tree arrays to a common node count for the batched walk, on
    ``device``; ``"depth"`` is the deepest tree's depth (host int)."""
    dev = resolve_device(device)
    M = max(t.n_nodes for t in trees)

    def pad(a, fill, dtype):
        out = np.full((len(trees), M), fill, dtype=dtype)
        for i, x in enumerate(a):
            out[i, : len(x)] = x
        return torch.from_numpy(out).to(dev)

    return {
        "feature": pad([t.feature for t in trees], -1, np.int32),
        "thr": pad([t.threshold_bin for t in trees], 0, np.int32),
        "nominal": pad([t.nominal for t in trees], False, bool),
        "left": pad([t.left for t in trees], -1, np.int64),
        "right": pad([t.right for t in trees], -1, np.int64),
        "value": pad([t.leaf_value for t in trees], 0.0, np.float32),
        "depth": max(t.max_depth_used for t in trees),
    }


def _walk(stacked: dict, Xb, max_depth: int) -> torch.Tensor:
    """Every tree x every row -> node ids [T, N] int64 after
    ``min(stacked depth, max_depth)`` steps."""
    feature = stacked["feature"]
    Xbt = _on(Xb, torch.int32, feature.device)
    node = torch.zeros((feature.shape[0], Xbt.shape[0]), dtype=torch.int64,
                       device=feature.device)
    for _ in range(min(int(stacked["depth"]), int(max_depth))):
        f = torch.gather(feature, 1, node)
        b = _bins_at(Xbt, torch.clamp(f, min=0))
        t = torch.gather(stacked["thr"], 1, node)
        go_left = torch.where(torch.gather(stacked["nominal"], 1, node),
                              b == t, b <= t)
        nxt = torch.where(go_left, torch.gather(stacked["left"], 1, node),
                          torch.gather(stacked["right"], 1, node))
        node = torch.where(f < 0, node, nxt)
    return node


def predict_forest_binned(stacked: dict, Xb, max_depth: int = 64):
    """All trees x all rows in one batched walk -> leaf values [T, N], a
    tensor on the stacked trees' device."""
    return torch.gather(stacked["value"], 1, _walk(stacked, Xb, max_depth))


def predict_binned(tree: TreeArrays, Xb, max_depth: int = 64,
                   device: DeviceLike = None) -> np.ndarray:
    """Vectorized tree walk on binned rows -> leaf node ids (host int32)."""
    node = _walk(stack_trees([tree], device), Xb, max_depth)[0]
    return _to_host(node, "walk").astype(np.int32)
