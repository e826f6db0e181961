"""Model-sharded servables — score models bigger than one device (the port
of ``hivemall_tpu/serving/sharded.py``).

Training stripes the hashed weight table across a mesh (parallel/,
core/striping.py); this module gives SERVING the same headroom. An
artifact's score tables stripe along their gathered axis over the
placement's ``[batch][model]`` grid of local devices
(serving/placement.py): the device at ``(b, j)`` holds stripe ``j`` of
every striped table, request batches split along ``b``. A table that
exceeds one device's memory serves, and devices that idled under
single-device placement do work.

The JAX package runs one ``shard_map`` per family: each device gathers its
stripe's lanes and a ``psum`` over the model axis adds the partials. Here
each family has a plain torch body over ONE stripe (``_BODIES``) that
returns the stripe's partials, and the cross-stripe sum moves each
stripe's partials to the batch row's lead device (``grid[b][0]``) and adds
them in stripe order 0..n-1; a finishing step (FM's pairwise term, MF's
dot product) runs on the sum. The batch rows' results meet on
``grid[0][0]``.

Three invariants carried over from the single-device engine:

- **one striping, one scoring body.** Tables pad and stripe with
  ``core.striping.stripe_grid`` / ``restripe_array`` — the sharded
  trainers' own grid arithmetic — and score through the per-stripe halves
  the trainers use (``parallel.sharded.stripe_partial``,
  ``models.fm.stripe_gather_partials``), so a served-sharded score cannot
  drift from a trained-sharded one. Training sums those partials with a
  process-group ``psum``, serving across local devices.
- **dequant-free quantized scoring.** int8 tables stripe as int8 with
  their f32 scale arrays striped on the block grid — the stripe is
  aligned up to ``block_rows`` (stripe_grid's ``align``), so a scale block
  never straddles two stripes and ``local_id >> block_shift`` indexes the
  local scale slice directly; bf16 tables stripe AT bf16 and each gathered
  window widens to f32, as the single-device ``q8_*`` scorers do.
- **one staging.** The sharded servables inherit the sparse-row / pair
  staging of their single-device counterparts (serving/engine.py), so
  request parsing, width bucketing, pad lanes (index == dims, value 0) and
  the pre-parsed request forms behave identically; ``translate_to_stripe``
  routes every lane to its owning stripe, foreign and pad lanes adding 0.

A device may repeat in the grid; a stripe is placed once per distinct
device it is assigned to (a ``(2, 2)`` grid over one card holds each
stripe once). MF ids outside the tables land in no stripe and score
``mu`` (the JAX package's sharded trade); the single-device MF servable
raises on them instead. FFM and the trees have no striped score path and
refuse, as ``host_score_tables`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.striping import restripe_array, stripe_grid, translate_to_stripe
from .artifact import host_score_tables
from .engine import _ArgmaxLabelServable, _PairServable, _SparseRowServable
from .placement import ModelSharded

# --- per-family stripe bodies -------------------------------------------------
# body(tables, idx, val, shard, stripe, block_shift) -> tuple of partials,
# summed over the stripes; finish(replicated, summed) -> scores. ``tables``
# are one stripe's tensors on one device, idx / val that device's copy of
# the batch row's [B, K] ids (int64) and values (f32).


def _linear_body(tables, idx, val, shard, stripe, block_shift):
    from ..parallel.sharded import stripe_partial

    return (stripe_partial(tables[0], idx, val, shard, stripe),)


def _q8_linear_body(tables, idx, val, shard, stripe, block_shift):
    from .engine import q8_linear_scores

    lidx, vmask = translate_to_stripe(idx, val, shard, stripe)
    return (q8_linear_scores(tables[0], tables[1], lidx, vmask,
                             block_shift),)


def _multiclass_body(tables, idx, val, shard, stripe, block_shift):
    from ..models.multiclass import _mc_scores

    lidx, vmask = translate_to_stripe(idx, val, shard, stripe)
    return (_mc_scores(tables[0], lidx, vmask),)


def _q8_multiclass_body(tables, idx, val, shard, stripe, block_shift):
    from .engine import q8_mc_scores

    lidx, vmask = translate_to_stripe(idx, val, shard, stripe)
    return (q8_mc_scores(tables[0], tables[1], lidx, vmask, block_shift),)


def _fm_body(tables, idx, val, shard, stripe, block_shift):
    from ..models.fm import stripe_gather_partials

    return (stripe_gather_partials(tables[0], tables[1], idx, val, shard,
                                   stripe)[4],)


def _q8_fm_body(tables, idx, val, shard, stripe, block_shift):
    from ..models.fm import fm_partials
    from .engine import q8_fm_gather

    lidx, vmask = translate_to_stripe(idx, val, shard, stripe)
    wg, vg = q8_fm_gather(*tables, lidx, block_shift)
    return (fm_partials(wg, vg, vmask),)


def _mf_rows(table, scales, ids, shard, stripe, block_shift):
    """One stripe's f32 rows of ``table`` for global ``ids`` (0 where the
    stripe does not own the id), scale-folded for int8; and the bias
    gather's (live, safe index)."""
    from ..core.engine import live_lanes

    lid, _ = translate_to_stripe(ids, torch.ones(ids.shape,
                                                 device=ids.device),
                                 shard, stripe)
    live, sid = live_lanes(lid, table.shape[0])
    g = torch.where(live[:, None], table[sid].float(),
                    torch.zeros((), device=table.device))
    if scales is not None:
        g = g * scales[sid >> block_shift]
    return g, live, sid


def _mf_body(tables, u, i, shard, stripe, block_shift):
    """MF pair partials: this stripe's rows of P / Bu (user grid) and Q /
    Bi (item grid); summed over the stripes they assemble the full
    gathered windows. ``stripe`` is (stripe_users, stripe_items)."""
    P, Q, Bu, Bi = tables[:4]
    ps, qs = tables[4:] if len(tables) > 4 else (None, None)
    pg, lu, su = _mf_rows(P, ps, u, shard, stripe[0], block_shift)
    qg, li, si = _mf_rows(Q, qs, i, shard, stripe[1], block_shift)
    zero = torch.zeros((), device=P.device)
    return (pg, qg, torch.where(lu, Bu[su], zero),
            torch.where(li, Bi[si], zero))


def _sum_finish(rep, parts):
    return parts[0]


def _fm_finish(rep, parts):
    from ..models.fm import predict_from_partials

    kp = (parts[0].shape[-1] - 1) // 2
    return predict_from_partials(rep["w0"], parts[0], kp)[0]


def _mf_finish(use_bias):
    def finish(rep, parts):
        pg, qg, bu, bi = parts
        out = torch.sum(pg * qg, dim=-1) + rep["mu"]
        if use_bias:
            out = out + bu + bi
        return out

    return finish


_BODIES = {"linear": _linear_body, "q8_linear": _q8_linear_body,
           "multiclass": _multiclass_body,
           "q8_multiclass": _q8_multiclass_body,
           "fm": _fm_body, "q8_fm": _q8_fm_body, "mf": _mf_body}


def row_sum(row, stripes, body, inputs, stripe, block_shift):
    """``body``'s partials over one grid row: stripe j's on ``row[j]``
    from ``inputs`` (tensors, copied once per distinct device; ids widen
    to int64 there, values stay f32), each moved to ``row[0]`` and added
    in stripe order 0..n-1 — JAX's psum over the model axis."""
    moved: Dict[torch.device, list] = {}
    acc = None
    for j, dev in enumerate(row):
        args = moved.get(dev)
        if args is None:
            args = moved[dev] = [x.to(dev) if x.dtype.is_floating_point
                                 else x.to(dev).long() for x in inputs]
        parts = [p.to(row[0])
                 for p in body(stripes[j], *args, j, stripe, block_shift)]
        acc = parts if acc is None else [a + p for a, p in zip(acc, parts)]
    return acc


# --- table placement ----------------------------------------------------------


def _as_numpy(arr) -> np.ndarray:
    """A host table as numpy; a bf16 CPU tensor as its int16 bit view (the
    pad fill 0 is bf16's +0.0)."""
    if torch.is_tensor(arr):
        return arr.view(torch.int16).numpy() if arr.dtype == torch.bfloat16 \
            else arr.numpy()
    return np.asarray(arr)


def _stripe_put(arr, axis: int, dims: int, dims_padded: int, grid,
                stripe: int) -> List[List[torch.Tensor]]:
    """Pad a host table to the stripe grid (core.striping.restripe_array,
    fill 0: the score path has no covariances) and place stripe ``j`` on
    every device of grid column ``j`` — once per distinct device. Returns
    ``parts[b][j]``. Stripes are copies, never views of ``arr``."""
    bf16 = torch.is_tensor(arr) and arr.dtype == torch.bfloat16
    a = restripe_array(_as_numpy(arr), axis, dims, dims_padded, fill=0)
    placed: Dict[tuple, torch.Tensor] = {}
    out = []
    for row in grid:
        parts = []
        for j, dev in enumerate(row):
            t = placed.get((j, dev))
            if t is None:
                sl = [slice(None)] * a.ndim
                sl[axis] = slice(j * stripe, (j + 1) * stripe)
                t = torch.from_numpy(np.array(a[tuple(sl)], order="C",
                                              copy=True))
                if bf16:
                    t = t.view(torch.bfloat16)
                t = placed[(j, dev)] = t.to(dev)
            parts.append(t)
        out.append(parts)
    return out


def _replicate_put(arr, grid) -> List[torch.Tensor]:
    """A replicated f32 array (w0, mu) on each batch row's lead device."""
    placed: Dict[torch.device, torch.Tensor] = {}
    out = []
    for row in grid:
        t = placed.get(row[0])
        if t is None:
            t = placed[row[0]] = torch.tensor(
                np.asarray(arr, np.float32), device=row[0])
        out.append(t)
    return out


def _per_row_elems(arr, axis: int) -> int:
    n = int(np.prod(tuple(arr.shape)))
    return n // int(arr.shape[axis])


# --- the sharded servables ----------------------------------------------------


class _ShardedMixin:
    """Placement bookkeeping and the grid dispatch shared by every sharded
    servable: what the engine surfaces on /models (placement_info), what
    the warmup-dummy cache keys on (mesh_shape), what budget checks meter
    (per_device_table_bytes)."""

    per_device_table_bytes: int = 0

    def _init_grid(self, kind: str, placement: ModelSharded,
                   striped: List[List[List[torch.Tensor]]],
                   replicated: Dict[str, List[torch.Tensor]], stripe,
                   block_shift: Optional[int], finish) -> None:
        """``striped[t][b][j]``: table t's stripe j on grid[b][j], in the
        body's argument order; ``replicated[name][b]`` on grid[b][0]."""
        self.grid = placement.mesh()
        self.device = self.grid[0][0]
        self.mesh_shape = (len(self.grid), len(self.grid[0]))
        self._body = _BODIES[kind]
        self._finish = finish
        self._stripe = stripe
        self._block_shift = block_shift
        self._stripes = [[tuple(t[b][j] for t in striped)
                          for j in range(self.mesh_shape[1])]
                         for b in range(self.mesh_shape[0])]
        self._replicated = [{k: v[b] for k, v in replicated.items()}
                            for b in range(self.mesh_shape[0])]

    def _init_placement(self, placement: ModelSharded, spec: dict,
                        grids: dict, per_device: int) -> None:
        self.weights_dtype = spec["weights_dtype"]
        self.per_device_table_bytes = int(per_device)
        self.placement_info = dict(placement.describe())
        self.placement_info["stripe_grids"] = {
            g: {"dims": d, "stripe": s, "dims_padded": p}
            for g, (d, s, p) in grids.items()}
        self.placement_info["per_device_table_bytes"] = int(per_device)

    def device_tables(self):
        """The logical tables — batch row 0's stripes and replicated
        scalars — deduplicated by identity (a device that repeats in the
        grid holds one copy)."""
        seen, out = set(), []
        for t in [t for part in self._stripes[0] for t in part] \
                + list(self._replicated[0].values()):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def _dispatch(self, *batch: np.ndarray) -> torch.Tensor:
        """Score staged host arrays [b_pad, ...] over the grid: batch row
        b takes rows [b * per, (b + 1) * per) and sums its stripes'
        partials (`row_sum`); the rows' scores meet on grid[0][0]."""
        n_b = self.mesh_shape[0]
        per = batch[0].shape[0] // n_b
        outs = []
        for b, row in enumerate(self.grid):
            host = [torch.from_numpy(np.ascontiguousarray(
                a[b * per:(b + 1) * per])) for a in batch]
            acc = row_sum(row, self._stripes[b], self._body, host,
                          self._stripe, self._block_shift)
            outs.append(self._finish(self._replicated[b], acc).to(
                self.device))
        return outs[0] if n_b == 1 else torch.cat(outs)


class _ShardedRowServable(_ShardedMixin, _SparseRowServable):
    """Sharded sparse-row families (linear / FM, any precision): staging
    inherited from the single-device path, scoring over the grid."""

    def __init__(self, kind: str, family: str, striped, replicated,
                 dims: int, placement: ModelSharded, stripe: int,
                 block_shift: Optional[int] = None) -> None:
        self.family = family
        self._init_grid(kind, placement, striped, replicated, stripe,
                        block_shift,
                        _fm_finish if family == "fm" else _sum_finish)
        _SparseRowServable.__init__(self, dims, self.device)

    def dispatch(self, staged):
        return self._dispatch(staged.indices, staged.values)


class _ShardedLabelServable(_ShardedRowServable, _ArgmaxLabelServable):
    """Multiclass over the grid: sharded scores + the shared argmax / vocab
    label selection."""

    def __init__(self, kind: str, striped, dims: int, label_vocab,
                 placement: ModelSharded, stripe: int,
                 block_shift: Optional[int] = None) -> None:
        super().__init__(kind, "multiclass", striped, {}, dims, placement,
                         stripe, block_shift=block_shift)
        self.label_vocab = list(label_vocab)


class _ShardedMFServable(_ShardedMixin, _PairServable):
    """MF over the grid: pair staging inherited; P / Bu stripe over the
    user grid and Q / Bi over the item grid; the stripes' gathered rows
    sum into the full windows and the dot product runs on the device
    (unlike the single-device MF servable's host numpy gather-dot:
    assembling rows across stripes is device work)."""

    def __init__(self, striped, replicated, placement: ModelSharded,
                 stripe: tuple, use_bias: bool,
                 block_shift: Optional[int] = None) -> None:
        self._init_grid("mf", placement, striped, replicated, stripe,
                        block_shift, _mf_finish(use_bias))

    def dispatch(self, staged):
        return self._dispatch(*staged)

    def finalize(self, raw, n: int):
        return raw.detach().cpu().numpy()[:n]


# --- the sharded load path ----------------------------------------------------


def sharded_servable(source, placement: ModelSharded):
    """Artifact | trained model -> sharded servable on ``placement``.

    Normalize the score tables to host arrays at their serving dtype
    (serving.artifact.host_score_tables — the manifest dtype pin applies
    there), derive each id space's stripe with the trainers' own grid
    arithmetic (stripe_grid; int8 aligns the stripe to the scale block),
    check the budget against the PER-DEVICE resident bytes — the quantity
    sharding divides — before anything is placed, then pad and place every
    striped table over the grid and bind the family's body."""
    from ..io.checkpoint import QUANT_SCHEME_INT8

    spec = host_score_tables(source)
    quant = spec["quant"]
    is_int8 = bool(quant) and quant["scheme"] == QUANT_SCHEME_INT8
    block_rows = int(quant["block_rows"]) if is_int8 else 1
    block_shift = block_rows.bit_length() - 1 if is_int8 else None
    n = placement.model_shards
    meta = spec["meta"]

    # one stripe grid per id space (features; users + items for MF)
    grid_dims = {"features": int(meta["dims"]) if "dims" in meta else None,
                 "users": int(meta.get("num_users", 0)),
                 "items": int(meta.get("num_items", 0))}
    grids = {}
    for _, _, _, g in spec["striped"]:
        if g not in grids:
            stripe, padded = stripe_grid(grid_dims[g], n, align=block_rows)
            grids[g] = (grid_dims[g], stripe, padded)

    per_device = 0
    for name, arr, axis, g in spec["striped"]:
        stripe = grids[g][1]
        per_device += stripe * _per_row_elems(arr, axis) \
            * (arr.element_size() if torch.is_tensor(arr)
               else arr.dtype.itemsize)
        scales = spec["scales"].get(name)
        if scales is not None:
            per_device += (stripe // block_rows) \
                * _per_row_elems(scales, axis) * 4
    for arr in spec["replicated"].values():
        per_device += int(np.asarray(arr).size) * 4
    placement.check_budget(
        int(per_device), f"{spec['family']} model ({spec['weights_dtype']})")

    grid = placement.mesh()
    placed = {}
    for name, arr, axis, g in spec["striped"]:
        dims_g, stripe, padded = grids[g]
        placed[name] = _stripe_put(arr, axis, dims_g, padded, grid, stripe)
        scales = spec["scales"].get(name)
        if scales is not None:
            # scales stripe WITH their blocks: the block grid is the row
            # grid divided by block_rows, and the stripe is block-aligned
            nb = -(-dims_g // block_rows)
            placed[name + "__scale"] = _stripe_put(
                scales, axis, nb, padded // block_rows, grid,
                stripe // block_rows)
    replicated = {k: _replicate_put(v, grid)
                  for k, v in spec["replicated"].items()}

    family = spec["family"]
    q8 = "q8_" if is_int8 else ""
    if family in ("linear", "multiclass", "fm"):
        stripe = grids["features"][1]
        names = {"linear": ("weights",), "multiclass": ("weights",),
                 "fm": ("w", "v")}[family]
        striped = []
        for nm in names:
            striped.append(placed[nm])
            if is_int8:
                striped.append(placed[nm + "__scale"])
        if family == "multiclass":
            sv = _ShardedLabelServable(
                q8 + family, striped, grid_dims["features"],
                meta["label_vocab"], placement, stripe,
                block_shift=block_shift)
        else:
            sv = _ShardedRowServable(
                q8 + family, family, striped, replicated,
                grid_dims["features"], placement, stripe,
                block_shift=block_shift)
    else:  # mf
        striped = [placed[k] for k in ("P", "Q", "Bu", "Bi")]
        if is_int8:
            striped += [placed["P__scale"], placed["Q__scale"]]
        sv = _ShardedMFServable(
            striped, replicated, placement,
            (grids["users"][1], grids["items"][1]),
            bool(meta["use_bias"]), block_shift=block_shift)
    sv._init_placement(placement, spec, grids, per_device)
    return sv
