"""Top-K retrieval serving on one device: score one user against the full
item catalog — the port of `hivemall_tpu/serving/retrieval.py`
(single-device placement).

The embedding families (MF, FM) serve "given user u, return the top-K of N
items": a [B, F] x [F, N] product plus a top-K, the catalog read once per
query batch.

- **Staged query, streamed catalog.** The user side is gathered ONCE per
  request into ``(qvec, base)`` such that for every item j

      score(u, j) = base_u + bias_j + <qvec_u, vec_j>

  For MF that is ``mu + Bu[u]`` / ``Bi[j]`` / ``P[u].Q[j]``; for FM, with
  item feature j one-hot at value 1, ``FM(x_u + e_j) = p(x_u) + w[j] +
  <sumVfX(x_u), v[j]>`` exactly — so ONE block scorer serves both
  families. The catalog is scored in fixed-size blocks of ``block_items``
  rows with a running top-K merge over carry ++ block, so no [B, N] score
  matrix is ever materialized.
- **Warm steady state.** Batch sizes pad to pow2 buckets, FM query widths
  to the engine width buckets, candidate slices to pow2 buckets;
  :meth:`RetrievalEngine.warmup` sweeps them all. Eager torch compiles
  nothing, so the JAX package's zero-recompile pin becomes the port's
  allocator pin: ``runtime.metrics.alloc_segment_guard`` around every
  request (counter ``allocator.new_segments.serving.<name>.topk``) stays
  flat after warmup.
- **int8 catalogs** serve dequant-free: only the sliced window widens to
  f32, scales fold by ``id >> block_shift``, the sum is f32.
- **LSH candidate pruning.** ``freeze(..., retrieval_index=...)`` builds
  signed-random-projection buckets over the item vectors into the artifact
  (manifest ``index`` block, arrays ``index__*``); a probe hashes ``qvec``
  once on the host, unions the Hamming-<=1 buckets, and the candidate
  scorer ranks the padded slice. Requests fall back to exact scoring
  (counted) when a bucket union is smaller than k or larger than
  ``candidate_cap``.

Everything here is plain torch on the device plus host numpy, as the JAX
package's is XLA plus host numpy; no step reaches a ``pallas_call``.

**Tie order.** The contract is the JAX package's: the blocked merge equals
a stable descending argsort of the materialized scores, ids and f32 score
bits alike. JAX gets it from ``lax.top_k``, which keeps the lowest
position among equal values, over a carry-first concat of ascending-id
blocks. ``torch.topk`` promises no order among equal values, so the merge
takes a STABLE descending sort of carry ++ block (-0.0 compared as +0.0,
as numpy's argsort compares) and keeps its first ``k_pad`` — equal scores
resolve to the lowest item id.

**One score expression.** The merge and ``score_catalog`` run the same
per-block function at the same ``[B, block_items]`` shape: the product's
kernel is chosen by shape, so a single ``[B, N]`` product could differ in
its low bits. The product must be true f32: on CUDA the scorers raise if
``torch.backends.cuda.matmul.allow_tf32`` is set.

**Indexing.** JAX's gathers read 0 past a table (``mode="fill"``); a
torch gather out of range raises on the CPU and is undefined on CUDA. So
the catalog (and its int8 scales) is zero-padded to a multiple of
``block_items``, which keeps every block window and scale row in range,
and the candidate scorer masks any id outside the padded catalog to a
zero row. Pad rows (past ``n_items``) score ``-inf`` and the carry starts
at ``(-inf, n_pad)``, so no pad id reaches a result.

Sharded catalogs (``ModelSharded`` placement) are a later slice of the
port (ROADMAP Queue 1 #7) and raise by name.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..runtime.metrics import REGISTRY, alloc_segment_guard
from ..runtime.tracing import TRACER
from .artifact import Artifact, family_of, host_score_tables, load
from .engine import LATENCY_BUCKETS
from .placement import resolve_placement

RETRIEVAL_FAMILIES = ("mf", "fm")


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _check_f32_product(t: torch.Tensor) -> None:
    """The catalog product must be f32, as the reference's is: TF32 would
    round the inputs to 10 mantissa bits on the card."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "top-K retrieval scores in float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (TF32 rounds "
            "the product's inputs and breaks parity with the reference)")


def _stable_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """The ``k`` largest of ``vals`` [B, M] per row, descending, equal
    values in their original order (lowest position first: lax.top_k's
    order, a stable descending argsort's), with the matching ``ids``."""
    # + 0.0 turns -0.0 into +0.0, so the two zeros compare equal here as
    # they do in numpy's argsort (a radix sort orders them apart)
    order = torch.sort(vals + 0.0, dim=1, descending=True,
                       stable=True).indices[:, :k]
    return vals.gather(1, order), ids.gather(1, order)


def _host_tensor(table) -> torch.Tensor:
    """A host table (numpy, or a CPU bf16 tensor) as a CPU tensor, dtype
    kept."""
    return table if torch.is_tensor(table) \
        else torch.from_numpy(np.ascontiguousarray(table))


def _on_device(table, dev: torch.device, rows: int = 0) -> torch.Tensor:
    """A host table on ``dev``, zero-padded to ``rows`` rows."""
    t = _host_tensor(table)
    if t.shape[0] < rows:
        t = torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])
    return t.to(dev)


# --- LSH index (host numpy, the JAX package's code as it is) ---------------


def build_srp_index(item_vectors, n_planes: int = 8, seed: int = 0,
                    item_lo: int = 0):
    """Signed-random-projection buckets over item vectors: deterministic in
    ``seed``, built from the f32 vectors (BEFORE any quantization — the
    index approximates angles, not stored bits).

    Returns ``(planes [P,F] f32, item_ids [N] int64 global ids grouped by
    bucket, offsets [2^P+1] int64)`` — the ``index__*`` arrays
    freeze(..., retrieval_index=...) packs into the artifact."""
    vecs = np.asarray(item_vectors, np.float32)
    if vecs.ndim != 2 or vecs.shape[0] == 0:
        raise ValueError(
            f"retrieval index needs a non-empty [N, F] vector table, got "
            f"shape {vecs.shape}")
    n_planes = int(n_planes)
    if not 1 <= n_planes <= 24:
        raise ValueError(f"n_planes must be in [1, 24], got {n_planes}")
    rng = np.random.RandomState(int(seed))
    planes = rng.standard_normal((n_planes, vecs.shape[1])).astype(
        np.float32)
    # MIPS shift trick: hash items CENTERED on the catalog mean. For any
    # query q, <q, x_j> = <q, x_j - c> + <q, c> and the second term is
    # constant over j, so top-K by score == top-K by <q, x_j - c> — and
    # centered directions spread a trained catalog across the bucket
    # space. The query hashes UNCENTERED (its shift is the same constant),
    # so the center never ships in the artifact.
    bits = ((vecs - vecs.mean(axis=0)) @ planes.T) > 0.0
    codes = (bits.astype(np.int64)
             << np.arange(n_planes, dtype=np.int64)).sum(axis=1)
    order = np.argsort(codes, kind="stable")
    item_ids = (order + int(item_lo)).astype(np.int64)
    counts = np.bincount(codes, minlength=1 << n_planes)
    offsets = np.zeros((1 << n_planes) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return planes, item_ids, offsets


class SRPIndex:
    """Query-time view of a frozen SRP index: hash qvec once, union the
    Hamming-<=1 buckets (1 + n_planes probes) into a sorted candidate id
    list per query. Host-side — probing is O(P*F + candidates)."""

    def __init__(self, planes, item_ids, offsets, item_lo: int,
                 item_hi: int, n_planes: int, seed: int) -> None:
        self.planes = np.asarray(planes, np.float32)
        self.item_ids = np.asarray(item_ids, np.int64)
        self.offsets = np.asarray(offsets, np.int64)
        self.item_lo = int(item_lo)
        self.item_hi = int(item_hi)
        self.n_planes = int(n_planes)
        self.seed = int(seed)

    @classmethod
    def from_artifact(cls, artifact: Artifact) -> Optional["SRPIndex"]:
        info = artifact.meta.get("index")
        if not info:
            return None
        if info.get("scheme") != "srp_lsh":
            raise ValueError(
                f"unknown retrieval index scheme {info.get('scheme')!r} "
                f"(this build reads 'srp_lsh')")
        a = artifact.arrays
        return cls(a["index__planes"], a["index__item_ids"],
                   a["index__offsets"], int(info["item_lo"]),
                   int(info["item_hi"]), int(info["planes"]),
                   int(info["seed"]))

    def probe(self, qvecs: np.ndarray) -> List[np.ndarray]:
        bits = (np.asarray(qvecs, np.float32) @ self.planes.T) > 0.0
        codes = (bits.astype(np.int64)
                 << np.arange(self.n_planes, dtype=np.int64)).sum(axis=1)
        out = []
        for code in codes:
            buckets = [code] + [code ^ (1 << i)
                                for i in range(self.n_planes)]
            parts = [self.item_ids[self.offsets[b]:self.offsets[b + 1]]
                     for b in buckets]
            ids = np.concatenate(parts)
            ids.sort()  # ascending ids = stable tie order in the scorer
            out.append(ids)
        return out

    def describe(self) -> dict:
        return {"scheme": "srp_lsh", "planes": self.n_planes,
                "seed": self.seed,
                "item_range": [self.item_lo, self.item_hi],
                "buckets": 1 << self.n_planes}


# --- the catalog -------------------------------------------------------------


class _SingleCatalog:
    """The padded item tables on ONE device and the scorers over them.
    ``vec`` / ``bias`` keep their serving dtype (f32, bf16 or int8) and
    are zero-padded to a multiple of ``block_items`` so no block window
    runs past the table; int8 scales are padded to match."""

    def __init__(self, vec, bias, vscale, bscale, n_items: int,
                 block_items: int, k_pad: int,
                 block_shift: Optional[int], bias_scaled: bool,
                 device: torch.device) -> None:
        self.device = device
        self.n_items = int(n_items)
        self.bk = int(block_items)
        self.k_pad = int(k_pad)
        self.n_pad = -(-self.n_items // self.bk) * self.bk
        self.n_steps = self.n_pad // self.bk
        self.block_shift = block_shift
        self.bias_scaled = bool(bias_scaled)
        self.vec = _on_device(vec, device, self.n_pad)
        self.bias = _on_device(bias, device, self.n_pad)
        self.vscale = self.bscale = None
        if block_shift is not None:
            nb_pad = self.n_pad >> block_shift
            self.vscale = _on_device(np.asarray(vscale, np.float32), device,
                                     nb_pad)
            if bias_scaled:
                self.bscale = _on_device(np.asarray(bscale, np.float32),
                                         device, nb_pad)
        self.ids = torch.arange(self.n_pad, device=device)

    def block_scores(self, qvec: torch.Tensor, base: torch.Tensor,
                     start: int):
        """Scores [B, bk] of catalog rows [start, start + bk) and their
        ids — the ONE score expression of the merge and of the
        materializing baseline. Rows past n_items score -inf."""
        _check_f32_product(qvec)
        end = start + self.bk
        ids = self.ids[start:end]
        w = self.vec[start:end].float()  # per-window widen only
        b = self.bias[start:end].float()
        if self.block_shift is not None:
            # scales are [nb, F] for the vector table (per block of rows,
            # per column); the gather aligns shapes, the fold is
            # elementwise. ids >> block_shift < nb_pad: in range
            blk = ids >> self.block_shift
            w = w * self.vscale[blk]
            if self.bias_scaled:
                b = b * self.bscale[blk]
        scores = base[:, None] + qvec @ w.T + b[None, :]
        if end > self.n_items:  # pad lanes must lose every merge
            scores = torch.where(ids[None, :] < self.n_items, scores,
                                 float("-inf"))
        return scores, ids

    def _staged(self, qvec: np.ndarray, base: np.ndarray):
        return (torch.from_numpy(qvec).to(self.device),
                torch.from_numpy(base).to(self.device))

    def run_blocks(self, qvec: np.ndarray, base: np.ndarray):
        """The streamed merge over every block: (top values [B, k_pad],
        their catalog-row ids [B, k_pad]), on the device."""
        return self.sweep(*self._staged(qvec, base))

    def sweep(self, q: torch.Tensor, bs: torch.Tensor):
        """run_blocks on staged device tensors. Carry first, blocks in
        ascending id order: ties resolve to the lowest id."""
        b = q.shape[0]
        cv = torch.full((b, self.k_pad), float("-inf"), device=self.device)
        ci = torch.full((b, self.k_pad), self.n_pad, dtype=torch.int64,
                        device=self.device)
        for s in range(self.n_steps):
            scores, ids = self.block_scores(q, bs, s * self.bk)
            cv, ci = _stable_topk(torch.cat([cv, scores], dim=1),
                                  torch.cat([ci, ids.expand(b, -1)], dim=1),
                                  self.k_pad)
        return cv, ci

    def run_cand(self, qvec, base, ids, mask):
        """Score a padded candidate slice [B, C] (LSH probe output)
        directly — a per-request gather instead of the block sweep. An id
        outside the padded catalog reads a zero row, as JAX's fill-mode
        gather does."""
        q, bs = self._staged(qvec, base)
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        mask = torch.from_numpy(np.asarray(mask, bool)).to(self.device)
        live = (ids >= 0) & (ids < self.n_pad)
        sid = torch.where(live, ids, torch.zeros_like(ids))
        w = self.vec[sid].float()  # [B, C, F]
        b = self.bias[sid].float()
        if self.block_shift is not None:
            blk = sid >> self.block_shift
            w = w * self.vscale[blk]
            if self.bias_scaled:
                b = b * self.bscale[blk]
        zero = torch.zeros((), device=self.device)
        w = torch.where(live[..., None], w, zero)
        b = torch.where(live, b, zero)
        _check_f32_product(q)
        scores = bs[:, None] + torch.einsum("bf,bcf->bc", q, w) + b
        scores = torch.where(mask, scores, float("-inf"))
        return _stable_topk(scores, ids, self.k_pad)

    def score_catalog(self, qvec: np.ndarray, base: np.ndarray) -> np.ndarray:
        """Materialized scores [B, n_items] through block_scores."""
        q, bs = self._staged(qvec, base)
        outs = [self.block_scores(q, bs, s * self.bk)[0]
                for s in range(self.n_steps)]
        return torch.cat(outs, dim=1)[:, :self.n_items].cpu().numpy()

    @property
    def table_bytes(self) -> int:
        return int(sum(t.nbytes for t in (self.vec, self.bias, self.vscale,
                                          self.bscale) if t is not None))


# --- query stagers -----------------------------------------------------------


class _MFStager:
    """MF user staging is a host gather, as in the JAX package: qvec =
    P[u] (scale-folded for int8), base = mu + Bu[u]."""

    has_width = False

    def __init__(self, p_table, bu, mu, p_scales,
                 block_shift: Optional[int], num_users: int) -> None:
        self.p_table = _host_tensor(p_table)
        self.bu = np.asarray(bu, np.float32)
        self.mu = float(np.asarray(mu))
        self.p_scales = None if p_scales is None \
            else np.asarray(p_scales, np.float32)
        self.block_shift = block_shift
        self.num_users = int(num_users)

    def width_buckets(self) -> list:
        return [None]

    def dummy(self, width=None):
        return 0

    def _uids(self, queries) -> np.ndarray:
        uids = np.empty(len(queries), np.int64)
        for i, q in enumerate(queries):
            if isinstance(q, dict):
                q = q["user"]
            elif isinstance(q, (list, tuple, np.ndarray)):
                q = q[0]
            u = int(q)
            if not 0 <= u < self.num_users:
                raise ValueError(
                    f"user id {u} out of range [0, {self.num_users})")
            uids[i] = u
        return uids

    def stage(self, queries: Sequence, b_pad: int):
        from ..models.mf import _host_rows

        u = self._uids(queries)
        g = _host_rows(self.p_table, u)
        if self.p_scales is not None:
            g = g * self.p_scales[u >> self.block_shift]
        base = self.mu + self.bu[u]
        n = len(u)
        if b_pad > n:
            g = np.concatenate(
                [g, np.zeros((b_pad - n, g.shape[1]), np.float32)])
            base = np.concatenate([base, np.zeros(b_pad - n, np.float32)])
        return np.ascontiguousarray(g, np.float32), \
            np.ascontiguousarray(base, np.float32)


class _FMStager:
    """FM query staging: parse / pad sparse rows to a width bucket, then
    ``fn(idx, val) -> (p, sumVfX)`` on the device (the f32 / bf16 or the
    int8 row math of the FM scorers) over ``tables``, the device tensors
    it reads."""

    has_width = True

    def __init__(self, fn, tables: tuple, dims: int, max_width: int,
                 device: torch.device) -> None:
        self.fn = fn
        self.tables = tables
        self.dims = int(dims)
        self.max_width = int(max_width)
        self.device = device

    def width_buckets(self) -> list:
        out, w = [], 8
        while w < self.max_width:
            out.append(w)
            w <<= 1
        out.append(self.max_width)
        return out

    def dummy(self, width: Optional[int] = None):
        w = min(width or 8, self.max_width)
        return [(i % self.dims, 1.0) for i in range(w)]

    def stage(self, queries: Sequence, b_pad: int):
        from ..models.base import _stage_rows

        idx_rows, val_rows = _stage_rows(list(queries), self.dims)
        width = max((len(r) for r in idx_rows), default=1)
        w_pad = min(max(8, _pow2_at_least(width)), self.max_width)
        idx = np.full((b_pad, w_pad), self.dims, np.int64)
        val = np.zeros((b_pad, w_pad), np.float32)
        for i, (ir, vr) in enumerate(zip(idx_rows, val_rows)):
            t = min(len(ir), w_pad)  # over-wide rows truncate (engine rule)
            idx[i, :t] = ir[:t]
            val[i, :t] = vr[:t]
        base, qvec = self.fn(torch.from_numpy(idx).to(self.device),
                             torch.from_numpy(val).to(self.device))
        return qvec.cpu().numpy(), base.cpu().numpy()


# --- the engine --------------------------------------------------------------


class RetrievalEngine:
    """Blocked streamed top-K over an MF/FM catalog on one device (module
    docstring).

    ``source`` is an :class:`Artifact`, an artifact path, or a trained
    model (an LSH index rides only in artifacts). Queries are user ids
    (MF) or sparse feature rows (FM); results are ``{"items": [...],
    "scores": [...]}`` per query, item ids in the catalog's id space (MF
    item index / FM feature index). The catalog lives on ``device`` (None:
    the CUDA device, or a RuntimeError when there is none).

    ``k`` is the engine ceiling: per-request k clamps to it (and pads to
    ``k_pad``, the pow2 the merge carry holds). ``probe`` requests
    candidate pruning; without an index — or when the bucket union is < k
    or > ``candidate_cap`` — the request falls back to exact scoring
    (counter ``retrieval.<name>.fallback``)."""

    def __init__(self, source, *, name: str = "default", k: int = 16,
                 block_items: int = 4096, max_batch: int = 8,
                 max_width: int = 64, candidate_cap: int = 1024,
                 probe_default: bool = False,
                 item_range: Optional[Tuple[int, int]] = None,
                 placement=None, device: DeviceLike = None) -> None:
        from ..io.checkpoint import QUANT_SCHEME_INT8

        # replicated / model-sharded catalogs are a later slice: raises
        placement = resolve_placement(placement)
        if isinstance(source, str):
            source = load(source)
        family = source.family if isinstance(source, Artifact) \
            else family_of(source)
        if family not in RETRIEVAL_FAMILIES:
            raise ValueError(
                f"family {family!r} has no retrieval path — top-K serves "
                f"the embedding families ({', '.join(RETRIEVAL_FAMILIES)})")
        self.device = resolve_device(device)
        self.name = name
        self.family = family
        spec = host_score_tables(source)
        meta = spec["meta"]
        quant = spec["quant"]
        is_int8 = bool(quant) and quant["scheme"] == QUANT_SCHEME_INT8
        block_rows = int(quant["block_rows"]) if is_int8 else 1
        block_shift = block_rows.bit_length() - 1 if is_int8 else None
        self.weights_dtype = spec["weights_dtype"]

        self.index = SRPIndex.from_artifact(source) \
            if isinstance(source, Artifact) else None
        full = (0, int(meta["num_items"])) if family == "mf" \
            else (0, int(meta["dims"]))
        if self.index is not None:
            lo, hi = self.index.item_lo, self.index.item_hi
            if item_range is not None and tuple(item_range) != (lo, hi):
                raise ValueError(
                    f"item_range {tuple(item_range)} does not match the "
                    f"artifact index's ({lo}, {hi})")
        elif item_range is not None:
            lo, hi = int(item_range[0]), int(item_range[1])
        else:
            lo, hi = full
        if not (full[0] <= lo < hi <= full[1]):
            raise ValueError(
                f"item_range ({lo}, {hi}) outside the catalog's {full}")
        self.item_lo, self.item_hi = lo, hi
        self.n_items = hi - lo

        block_items = int(block_items)
        if block_items < 1:
            raise ValueError(f"block_items must be >= 1, got {block_items}")
        if is_int8 and (block_items % block_rows or lo % block_rows):
            raise ValueError(
                f"int8 catalogs need block_items ({block_items}) and "
                f"item_lo ({lo}) aligned to the quant block_rows "
                f"({block_rows}) so scale blocks never straddle a window")
        self.block_items = block_items
        self.k = int(k)
        if not 1 <= self.k <= self.n_items:
            raise ValueError(
                f"k={k} out of range [1, {self.n_items}] for this catalog")
        self.k_pad = _pow2_at_least(self.k)
        self.max_batch = _pow2_at_least(int(max_batch))
        self.max_width = max(8, _pow2_at_least(int(max_width)))
        self.cand_min = max(16, self.k_pad)
        self.candidate_cap = max(_pow2_at_least(int(candidate_cap)),
                                 self.cand_min)
        self.probe_default = bool(probe_default)

        striped = {nm: arr for nm, arr, _axis, _grid in spec["striped"]}
        scales = spec["scales"]
        if family == "mf":
            use_bias = bool(meta.get("use_bias", True))
            bi = striped["Bi"] if use_bias \
                else np.zeros_like(striped["Bi"])
            vec_host = striped["Q"][lo:hi]
            bias_host = bi[lo:hi]
            vscale = scales.get("Q")
            bscale = None
            bias_scaled = False
        else:
            vec_host = striped["v"][lo:hi]
            bias_host = striped["w"][lo:hi]
            vscale = scales.get("v")
            bscale = scales.get("w")
            bias_scaled = is_int8
        if block_shift is not None:
            blo, bhi = lo >> block_shift, ((hi - 1) >> block_shift) + 1
            vscale = np.asarray(vscale, np.float32)[blo:bhi]
            if bias_scaled:
                bscale = np.asarray(bscale, np.float32)[blo:bhi]

        self.placement_info = placement.describe()
        self._catalog = _SingleCatalog(
            vec_host, bias_host, vscale, bscale, self.n_items,
            self.block_items, self.k_pad, block_shift, bias_scaled,
            self.device)
        self._stager = self._make_stager(spec, striped, scales, meta,
                                         block_shift)

        self._queries_ctr = REGISTRY.counter("retrieval",
                                             f"{name}.queries")
        self._exact_ctr = REGISTRY.counter("retrieval", f"{name}.exact")
        self._probed_ctr = REGISTRY.counter("retrieval", f"{name}.probed")
        self._fallback_ctr = REGISTRY.counter("retrieval",
                                              f"{name}.fallback")
        self._cand_ctr = REGISTRY.counter("retrieval",
                                          f"{name}.candidates")
        self._latency = REGISTRY.histogram(
            f"retrieval.{name}.topk_seconds", LATENCY_BUCKETS)
        REGISTRY.set_gauge(f"retrieval.{name}.catalog_items",
                           float(self.n_items))
        REGISTRY.set_gauge(f"retrieval.{name}.table_bytes",
                           float(self.table_bytes()))

    def _make_stager(self, spec, striped, scales, meta, block_shift):
        if self.family == "mf":
            use_bias = bool(meta.get("use_bias", True))
            bu = striped["Bu"] if use_bias \
                else np.zeros_like(striped["Bu"])
            return _MFStager(striped["P"], bu, spec["replicated"]["mu"],
                             scales.get("P"), block_shift,
                             int(meta["num_users"]))
        from ..models.fm import _fm_rows
        from .engine import _fm_serving_state, q8_fm_rows

        dev = self.device
        w0 = spec["replicated"]["w0"]
        if block_shift is not None:
            tables = tuple(_on_device(t, dev) for t in (
                np.asarray(w0, np.float32), striped["w"],
                np.asarray(scales["w"], np.float32), striped["v"],
                np.asarray(scales["v"], np.float32)))

            def fn(idx, val):
                return q8_fm_rows(*tables, idx, val, block_shift)
        else:
            state = _fm_serving_state(w0, _on_device(striped["w"], dev),
                                      _on_device(striped["v"], dev), dev)
            tables = (state.w0, state.w, state.v)

            def fn(idx, val):
                return _fm_rows(state, idx, val)
        return _FMStager(fn, tables, int(meta["dims"]), self.max_width, dev)

    # -- buckets -------------------------------------------------------------

    def batch_buckets(self) -> list:
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b <<= 1
        out.append(self.max_batch)
        return out

    def _bucket(self, n: int) -> int:
        return min(_pow2_at_least(n), self.max_batch)

    def cand_buckets(self) -> list:
        out, c = [], self.cand_min
        while c < self.candidate_cap:
            out.append(c)
            c <<= 1
        out.append(self.candidate_cap)
        return out

    def _cand_bucket(self, m: int) -> int:
        return min(max(_pow2_at_least(m), self.cand_min),
                   self.candidate_cap)

    # -- serving -------------------------------------------------------------

    def warmup(self) -> int:
        """Run every (batch, width) bucket through the block merge and,
        with an index, every candidate bucket; returns the caching-
        allocator segments the sweep added on the device (all of them paid
        here, none in the steady state; 0 on the CPU)."""
        t0 = time.perf_counter()
        with TRACER.span("retrieval.warmup",
                         args={"engine": self.name,
                               "family": self.family}), \
                alloc_segment_guard(f"serving.{self.name}.topk.warmup",
                                    self.device) as g:
            for b in self.batch_buckets():
                qvec = base = None
                for w in self._stager.width_buckets():
                    qvec, base = self._stager.stage(
                        [self._stager.dummy(w)] * b, b)
                cv, _ci = self._catalog.run_blocks(qvec, base)
                cv.cpu()
                if self.index is not None:
                    for c in self.cand_buckets():
                        ids = np.zeros((b, c), np.int64)
                        mask = np.zeros((b, c), bool)
                        tv, _ti = self._catalog.run_cand(qvec, base, ids,
                                                         mask)
                        tv.cpu()
        REGISTRY.set_gauge(f"retrieval.{self.name}.warmup_seconds",
                           time.perf_counter() - t0)
        REGISTRY.set_gauge(f"retrieval.{self.name}.warmup_segments",
                           float(g.segments))
        return g.segments

    def topk(self, queries: Sequence, k: Optional[int] = None,
             probe: Optional[bool] = None) -> List[dict]:
        """Top-K for a list of queries (one shared k/probe)."""
        return self.topk_batch([(q, k, probe) for q in queries])

    def topk_batch(self, rows: Sequence[tuple]) -> List[dict]:
        """Batcher entry point: rows of ``(query, k|None, probe|None)``.
        Chunks above max_batch; per-row k clamps to the engine k."""
        n = len(rows)
        if n == 0:
            return []
        t0 = time.perf_counter()
        outs: List[dict] = []
        with TRACER.span("retrieval.topk",
                         args={"engine": self.name, "rows": n}) as rspan:
            for s in range(0, n, self.max_batch):
                outs.extend(self._topk_chunk(rows[s:s + self.max_batch]))
            self._queries_ctr.increment(n)
            self._latency.observe(time.perf_counter() - t0,
                                  trace_id=TRACER.exemplar_id(rspan))
        return outs

    def _topk_chunk(self, rows: Sequence[tuple]) -> List[dict]:
        n = len(rows)
        queries = [r[0] for r in rows]
        ks = []
        for _q, rk, _p in rows:
            kk = self.k if rk is None else int(rk)
            if kk < 1:
                raise ValueError(f"k must be >= 1, got {kk}")
            ks.append(min(kk, self.k))
        probes = [self.probe_default if rp is None else bool(rp)
                  for _q, _k, rp in rows]
        b_pad = self._bucket(n)
        with alloc_segment_guard(f"serving.{self.name}.topk", self.device):
            with TRACER.span("topk.gather",
                             args={"rows": n, "b_pad": b_pad}):
                qvec, base = self._stager.stage(queries, b_pad)
            exact_idx = []
            cand: dict = {}
            for i in range(n):
                if probes[i] and self.index is None:
                    self._fallback_ctr.increment()  # probe without index
                if probes[i] and self.index is not None:
                    cand[i] = None  # resolved below
                else:
                    exact_idx.append(i)
            if cand:
                probed = self.index.probe(qvec[sorted(cand)])
                for i, c in zip(sorted(cand), probed):
                    if len(c) < ks[i] or len(c) > self.candidate_cap:
                        del cand[i]
                        exact_idx.append(i)
                        self._fallback_ctr.increment()
                    else:
                        cand[i] = c
                exact_idx.sort()
            pidx = sorted(cand)
            results: List[Optional[dict]] = [None] * n
            cv = ci = pv = pi = None
            with TRACER.span("topk.block_score",
                             args={"exact": len(exact_idx),
                                   "probed": len(pidx)}):
                if exact_idx:
                    bb = self._bucket(len(exact_idx))
                    qe = np.zeros((bb, qvec.shape[1]), np.float32)
                    qe[:len(exact_idx)] = qvec[exact_idx]
                    be = np.zeros((bb,), np.float32)
                    be[:len(exact_idx)] = base[exact_idx]
                    cv, ci = self._catalog.run_blocks(qe, be)
                    self._exact_ctr.increment(len(exact_idx))
                if pidx:
                    cmax = max(len(cand[i]) for i in pidx)
                    c_pad = self._cand_bucket(cmax)
                    bb = self._bucket(len(pidx))
                    ids = np.zeros((bb, c_pad), np.int64)
                    mask = np.zeros((bb, c_pad), bool)
                    total = 0
                    for r, i in enumerate(pidx):
                        c = cand[i] - self.item_lo  # catalog-row space
                        ids[r, :len(c)] = c
                        mask[r, :len(c)] = True
                        total += len(c)
                    qp = np.zeros((bb, qvec.shape[1]), np.float32)
                    qp[:len(pidx)] = qvec[pidx]
                    bp = np.zeros((bb,), np.float32)
                    bp[:len(pidx)] = base[pidx]
                    pv, pi = self._catalog.run_cand(qp, bp, ids, mask)
                    self._probed_ctr.increment(len(pidx))
                    self._cand_ctr.increment(total)
            # the .cpu() copies are where the host waits for the device
            with TRACER.span("topk.merge"):
                if exact_idx:
                    cvh, cih = cv.cpu().numpy(), ci.cpu().numpy()
                    for r, i in enumerate(exact_idx):
                        results[i] = self._row_result(cvh[r], cih[r], ks[i])
                if pidx:
                    pvh, pih = pv.cpu().numpy(), pi.cpu().numpy()
                    for r, i in enumerate(pidx):
                        results[i] = self._row_result(pvh[r], pih[r], ks[i])
        return results  # type: ignore[return-value]

    def _row_result(self, vals: np.ndarray, ids: np.ndarray,
                    k: int) -> dict:
        return {
            "items": (ids[:k].astype(np.int64) + self.item_lo).tolist(),
            # f32 carry values; .tolist() alone widens to Python floats
            "scores": vals[:k].tolist(),
        }

    def score_catalog(self, queries: Sequence) -> np.ndarray:
        """Materialized exact scores [n, n_items] — the naive-argsort
        baseline's input. Shares the block score expression bit for bit
        with the streamed merge. Not a serving path."""
        outs = []
        for s in range(0, len(queries), self.max_batch):
            chunk = queries[s:s + self.max_batch]
            qvec, base = self._stager.stage(chunk, self._bucket(len(chunk)))
            outs.append(self._catalog.score_catalog(qvec, base)[:len(chunk)])
        return np.concatenate(outs, axis=0)

    # -- introspection -------------------------------------------------------

    def table_bytes(self) -> int:
        n = self._catalog.table_bytes
        for t in getattr(self._stager, "tables", ()):
            n += int(t.nbytes)
        return n

    def describe(self) -> dict:
        return {
            "family": self.family,
            "weights_dtype": self.weights_dtype,
            "k": self.k,
            "catalog_items": self.n_items,
            "item_range": [self.item_lo, self.item_hi],
            "block_items": self.block_items,
            "max_batch": self.max_batch,
            "candidate_cap": self.candidate_cap,
            "probe_default": self.probe_default,
            "placement": self.placement_info,
            "device": str(self.device),
            "index": None if self.index is None else self.index.describe(),
            "table_bytes": self.table_bytes(),
        }
