"""Shape-bucketed online predictors for the linear, multiclass, FM, FFM,
MF, random forest and GBT families.

The port of the JAX package's `serving/engine.py`. There, XLA compiles one
program per input shape, so the engine pads every request to a
power-of-two (batch, width) bucket and warms every bucket at load time.
Eager torch compiles nothing, but the same buckets bound what the card
sees: a fixed set of tensor shapes, whose memory the CUDA caching allocator
holds after ``warmup()`` has run each once. The steady state then asks the
driver for no new memory — witnessed by ``runtime.metrics.
alloc_segment_guard`` around every predict (counter
``allocator.new_segments.serving.<name>`` stays flat).

- row width pads to a power of two >= 8 (``pad_to_bucket``), capped at
  ``max_width`` (longer rows truncate, counted);
- batch size pads to a power of two >= ``min_batch_bucket``, capped at
  ``max_batch`` (bigger requests chunk);
- staging is host numpy; the scorer runs on the servable's device; the
  host waits for the scores in ``finalize`` (the ``.cpu()`` copy).

Scorers (plain torch ops on the card, as the JAX scorers are plain jnp):
- f32 / bf16 tables: the function the trained model's own predict runs —
  ``core/engine.make_predict`` (linear), ``models/multiclass._mc_scores``
  (multiclass), ``models/fm._fm_scores`` (FM), ``models/ffm._ffm_scores``
  (FFM, f32 only) — so a served score equals the live model's; bf16
  tables serve AT bf16 (the gathered window widens to f32 inside the
  product);
- int8 tables: ``_QuantLinearServable`` / ``_QuantMulticlassServable`` /
  ``_QuantFMServable`` gather the int8 ``[B, K]`` (multiclass's
  ``[L, B, K]``, FM's ``[B, K, kp]``) windows, widen only those windows,
  fold in ``scales[id >> block_shift]`` and sum in f32 — the tables are
  never dequantized;
- multiclass answers labels: the ``[B, L]`` scores come back to the host
  and the argmax runs there in numpy, mapped through the label
  vocabulary (the JAX package's ``finalize``);
- FFM stages ``"field:idx:value"`` string rows into ``[B, K]`` ids, values
  and fields, and scores the pairwise block on the device;
- MF (``[user, item]`` pairs, ``_MFServable`` / ``_QuantMFServable``):
  the JAX package's MF servables are host numpy gather-dots, so the
  port's are too — the requested rows are gathered on the servable's
  device (bf16 / int8 windows widened there), copied to the host, and
  scaled, dotted and biased in numpy f32 with the reference's own
  expression, so a served score equals the JAX package's bit for bit;
- forest / GBT (raw feature rows, ``_ForestServable`` / ``_GBTServable``):
  requests bin on the host (f32, the edges narrowed alongside; f64 when
  narrowing would collapse two edges), the stacked node tables live on the
  servable's device and every tree walks there in one batched walk; the
  ``[T, B]`` leaf values come back to the host, where the forest votes (or
  averages) and GBT sums its rounds — labels through ``/predict``.

Placements other than single-device (``ModelSharded``, ``Replicated``)
route to serving/sharded.py, which stripes the same tables over a grid of
local devices and scores them with the same per-family bodies.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..core.batch import FeatureBlock, pack_rows, pad_to_bucket
from ..core.engine import live_lanes, make_predict
from ..device import DeviceLike, resolve_device
from ..runtime.metrics import REGISTRY, alloc_segment_guard
from ..runtime.tracing import TRACER
from .artifact import (PORTED_FAMILIES, Artifact, family_of, load,
                       manifest_dtype, manifest_quant)
from .placement import resolve_placement

# serving latency is sub-ms-to-seconds shaped; finer low end than the
# metrics default
LATENCY_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


class _Servable:
    """THE servable protocol: host staging + padded scoring.

    The engine, batcher, registry and /predict endpoint depend on nothing
    else. The request path is three separated stages so the tracer can
    attribute time per stage:

    - ``stage(instances, b_pad, width_cap)`` — host-side parse + pad to
      ``[b_pad, width_bucket]`` arrays (the "pad" span);
    - ``dispatch(staged)`` — the host-to-device copy and the scorer's
      launches, asynchronous on the card (the "dispatch" span);
    - ``finalize(raw, n)`` — the scores back on the host as numpy: the
      ``.cpu()`` copy is where the host waits (the "block" span).
    """

    family: str = ""
    # False for servables whose requests have no row width to bucket (MF
    # pairs): the engine then warms and serves one width
    has_width: bool = True
    # the dtype the weight tables SERVE at (the manifest weights_dtype for
    # artifacts) — surfaced per model on /models and /metrics
    weights_dtype: str = "float32"
    device: torch.device = torch.device("cpu")
    # the (batch, model) grid shape of a sharded servable, () single-device;
    # its /models placement block (None: the single-device default)
    mesh_shape: tuple = ()
    placement_info: Optional[dict] = None

    def device_tables(self) -> List[torch.Tensor]:
        """The resident score tables — whatever a request's gathers read.
        Feeds table_bytes."""
        return []

    def table_bytes(self) -> int:
        """Resident bytes of the score tables, ``numel * element_size``
        summed — the quantity bf16/int8 artifacts shrink 2-4x."""
        return sum(t.numel() * t.element_size() for t in self.device_tables())

    def stage(self, instances, b_pad: int, width_cap: int):
        raise NotImplementedError

    def dispatch(self, staged):
        raise NotImplementedError

    def run_padded(self, instances, b_pad: int, width_cap: int):
        return self.dispatch(self.stage(instances, b_pad, width_cap))

    def finalize(self, raw, n: int):
        return raw.detach().cpu().numpy()[:n]

    def dummy_instance(self, width: int):
        raise NotImplementedError

    def count_overwide(self, instances, width_cap: int) -> int:
        """How many rows will actually truncate at ``width_cap``."""
        return sum(1 for r in instances if len(r) > width_cap)

    def row_keys(self, instances, width_cap: int):
        """Per-row canonical keys for a hot-row score cache, or None when
        the request (or the family) is not cacheable."""
        return None


def _is_preparsed(instances) -> bool:
    """Pre-parsed requests (a LIST is always rows to parse):

    - 2-TUPLE ``(idx_rows, val_rows)`` of per-row arrays — the
      models.base._stage_rows convention;
    - 3-TUPLE ``(flat_idx, flat_val, lens)`` — the same rows pre-packed
      into flat arrays with per-row lengths, so staging needs no
      per-request concatenate at all."""
    return isinstance(instances, tuple) and len(instances) in (2, 3)


def _preparsed_len(instances) -> int:
    """Row count of a pre-parsed request (either tuple form)."""
    return len(instances[2] if len(instances) == 3 else instances[0])


def _preparsed_offsets(instances):
    """Element offsets for slicing a flat pre-parsed request — computed
    ONCE per predict call, not per chunk."""
    if len(instances) == 2:
        return None
    lens = instances[2]
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    return off


def _preparsed_chunk(instances, s: int, e: int, off=None):
    """Rows [s:e) of a pre-parsed request, preserving its form (the flat
    form slices by the precomputed element offsets ``off``)."""
    if len(instances) == 2:
        return (instances[0][s:e], instances[1][s:e])
    flat_i, flat_v, lens = instances
    return (flat_i[off[s]:off[e]], flat_v[off[s]:off[e]], lens[s:e])


class _SparseRowServable(_Servable):
    """Shared staging for the "feature[:value]" row families: parse ->
    width-bucket -> one padded FeatureBlock. Subclasses provide the score
    call."""

    def __init__(self, dims: int, device: torch.device) -> None:
        self.dims = dims
        self.device = device

    def count_overwide(self, instances, width_cap: int) -> int:
        if _is_preparsed(instances):
            if len(instances) == 3:
                return int(np.count_nonzero(
                    np.asarray(instances[2]) > width_cap))
            instances = instances[0]
        return sum(1 for r in instances if len(r) > width_cap)

    def stage(self, instances, b_pad: int, width_cap: int):
        if _is_preparsed(instances):
            return self._stage_preparsed(instances, b_pad, width_cap)
        from ..models.base import _stage_rows

        idx_rows, val_rows = _stage_rows(instances, self.dims)
        n = len(idx_rows)
        max_nnz = max((len(r) for r in idx_rows), default=1)
        width = min(pad_to_bucket(max_nnz), width_cap)
        return pack_rows(idx_rows, val_rows, np.zeros(n, dtype=np.float32),
                         self.dims, width=width, batch_size=b_pad)

    def _stage_preparsed(self, instances, b_pad: int, width_cap: int):
        """Vectorised staging for pre-parsed requests: one masked
        [n, width] gather over the flattened rows replaces the per-row
        loop of pack_rows, with the same semantics (ids mod dims, rows past
        width_cap truncate, pad lanes carry index == dims with value 0)."""
        if len(instances) == 3:
            flat_i, flat_v, lens = instances
            n = len(lens)
            lens = np.asarray(lens, np.int64)
            flat_i = np.asarray(flat_i)
            flat_v = np.asarray(flat_v, np.float32)
        else:
            idx_rows, val_rows = instances
            n = len(idx_rows)
            lens = np.fromiter((len(r) for r in idx_rows), np.int64,
                               count=n)
            flat_i = (np.concatenate(
                [np.asarray(r, np.int64).ravel() for r in idx_rows])
                if n else np.zeros(0, np.int64))
            flat_v = (np.concatenate(
                [np.asarray(r, np.float32).ravel() for r in val_rows])
                if n else np.zeros(0, np.float32))
        max_nnz = int(lens.max()) if n else 1
        width = min(pad_to_bucket(max(1, max_nnz)), width_cap)
        k = np.minimum(lens, width)
        indices = np.full((b_pad, width), self.dims, dtype=np.int32)
        values = np.zeros((b_pad, width), dtype=np.float32)
        nnz = np.zeros(b_pad, dtype=np.int32)
        total = int(lens.sum())
        if total:
            off = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=off[1:])
            pos = np.arange(width, dtype=np.int64)
            mask = pos[None, :] < k[:, None]
            src = np.minimum(off[:, None] + pos[None, :], total - 1)
            indices[:n] = np.where(mask, flat_i[src] % self.dims,
                                   self.dims)
            values[:n] = np.where(mask, flat_v[src], np.float32(0.0))
        nnz[:n] = k.astype(np.int32)
        return FeatureBlock(indices, values,
                            np.zeros(b_pad, dtype=np.float32), nnz)

    def dummy_instance(self, width):
        return [(i, 1.0) for i in range(width)]

    def row_keys(self, instances, width_cap: int):
        """blake2b-128 digests over (ids mod dims as int64, values as f32),
        in row order — the JAX package's keys, so a string row and its
        pre-parsed twin share one key. Rows wider than ``width_cap`` make
        the WHOLE request uncacheable (None): truncation lives in staging.
        Unparseable rows too: the parse error re-surfaces on the predict
        path with its real message."""
        from hashlib import blake2b

        if _is_preparsed(instances):
            if len(instances) == 3:
                flat_i, flat_v, lens = instances
                lens = np.asarray(lens, np.int64)
                if lens.size and int(lens.max()) > width_cap:
                    return None
                flat_i = np.asarray(flat_i, np.int64) % self.dims
                flat_v = np.asarray(flat_v, np.float32)
                off = np.zeros(len(lens) + 1, np.int64)
                np.cumsum(lens, out=off[1:])
                idx_rows = [flat_i[off[i]:off[i + 1]]
                            for i in range(len(lens))]
                val_rows = [flat_v[off[i]:off[i + 1]]
                            for i in range(len(lens))]
            else:
                idx_rows = [np.asarray(r, np.int64) % self.dims
                            for r in instances[0]]
                val_rows = [np.asarray(v, np.float32) for v in instances[1]]
        else:
            from ..models.base import _stage_rows

            try:
                idx_rows, val_rows = _stage_rows(instances, self.dims)
            except Exception:  # graftcheck: disable=G028 (None = uncacheable; the error re-surfaces on the predict path)
                return None
        keys = []
        for idx, val in zip(idx_rows, val_rows):
            if len(idx) > width_cap:
                return None
            keys.append(blake2b(
                np.ascontiguousarray(idx, np.int64).tobytes()
                + np.ascontiguousarray(val, np.float32).tobytes(),
                digest_size=16).digest())
        return keys


class _LinearServable(_SparseRowServable):
    """f32 or bf16 weights scored by core/engine.make_predict — the
    function the trained model's own predict runs."""

    family = "linear"

    def __init__(self, state, dims: int) -> None:
        from ..io.checkpoint import dtype_name

        super().__init__(dims, state.device)
        self.state = state
        self.weights_dtype = dtype_name(state.weights.dtype)
        self._predict = make_predict(use_covariance=False)

    def dispatch(self, staged):
        # the staged numpy arrays are fresh per request and never written
        # again, and make_predict's copy to the device is a blocking one
        return self._predict(self.state, staged.indices, staged.values)

    def device_tables(self):
        # weights only: the serving predict is built use_covariance=False,
        # so a resident covariance table is reload baggage, not score-path
        # bytes
        return [self.state.weights]


def q8_linear_scores(qw: torch.Tensor, scales: torch.Tensor,
                     indices: torch.Tensor, values: torch.Tensor,
                     block_shift: int) -> torch.Tensor:
    """Dequant-free int8 scoring: gather the int8 [B, K] window, widen only
    it, fold in its rows' per-block scales and sum in f32. A pad lane
    (index outside [0, D)) reads index 0 and is masked to 0 — torch has no
    fill mode, and an out-of-range index would be a device-side assert."""
    live, sidx = live_lanes(indices, qw.shape[0])
    w = qw[sidx].float() * scales[sidx >> block_shift]
    w = torch.where(live, w, torch.zeros((), dtype=w.dtype, device=w.device))
    return torch.sum(w * values, dim=-1)


class _QuantLinearServable(_SparseRowServable):
    """int8 linear weights served dequant-free (q8_linear_scores)."""

    family = "linear"
    weights_dtype = "int8"

    def __init__(self, qw: torch.Tensor, scales: torch.Tensor,
                 block_rows: int, dims: int) -> None:
        super().__init__(dims, qw.device)
        self.qw = qw
        self.scales = scales
        self.block_shift = int(block_rows).bit_length() - 1

    def dispatch(self, staged):
        idx = torch.from_numpy(staged.indices).to(self.device).long()
        val = torch.from_numpy(staged.values).to(self.device)
        return q8_linear_scores(self.qw, self.scales, idx, val,
                                self.block_shift)

    def device_tables(self):
        return [self.qw, self.scales]


class _ArgmaxLabelServable(_SparseRowServable):
    """Shared label selection for the multiclass servables (f32/bf16 and
    int8): the [B, L] scores come to the host, where the argmax (first
    maximal index) maps through label_vocab."""

    label_vocab: list

    def finalize(self, raw, n):
        scores = raw.detach().cpu().numpy()[:n]
        return [self.label_vocab[i] for i in np.argmax(scores, axis=1)]


class _MulticlassServable(_ArgmaxLabelServable):
    """f32 or bf16 [L, D] weights scored by models/multiclass._mc_scores —
    the function TrainedMulticlassModel.scores runs."""

    family = "multiclass"

    def __init__(self, weights: torch.Tensor, label_vocab,
                 dims: int) -> None:
        from ..io.checkpoint import dtype_name

        super().__init__(dims, weights.device)
        self.weights = weights
        self.label_vocab = list(label_vocab)
        self.weights_dtype = dtype_name(weights.dtype)

    def dispatch(self, staged):
        from ..models.multiclass import _mc_scores

        return _mc_scores(self.weights, staged.indices, staged.values)

    def device_tables(self):
        # the scorer reads the weight matrix only (see _LinearServable)
        return [self.weights]


def q8_mc_scores(qW: torch.Tensor, scales: torch.Tensor,
                 indices: torch.Tensor, values: torch.Tensor,
                 block_shift: int) -> torch.Tensor:
    """Dequant-free int8 multiclass scores [B, L]: weights [L, D] int8,
    scales [L, D / block_rows] f32 (blocked along the gathered feature
    axis); the gathered [L, B, K] window widens, the scales fold in, the
    lane sum runs in f32. Pad lanes read feature 0 and are masked to 0."""
    live, sidx = live_lanes(indices, qW.shape[1])
    W = qW[:, sidx].float() * scales[:, sidx >> block_shift]
    W = torch.where(live, W, torch.zeros((), dtype=W.dtype, device=W.device))
    return torch.sum(W * values, dim=-1).transpose(0, 1)


class _QuantMulticlassServable(_ArgmaxLabelServable):
    """int8 multiclass [L, D] table served dequant-free (q8_mc_scores);
    argmax label selection shared with _MulticlassServable."""

    family = "multiclass"
    weights_dtype = "int8"

    def __init__(self, qW: torch.Tensor, scales: torch.Tensor,
                 block_rows: int, label_vocab, dims: int) -> None:
        super().__init__(dims, qW.device)
        self.qW = qW
        self.scales = scales
        self.label_vocab = list(label_vocab)
        self.block_shift = int(block_rows).bit_length() - 1

    def dispatch(self, staged):
        idx = torch.from_numpy(staged.indices).to(self.device).long()
        val = torch.from_numpy(staged.values).to(self.device)
        return q8_mc_scores(self.qW, self.scales, idx, val, self.block_shift)

    def device_tables(self):
        return [self.qW, self.scales]


class _FMServable(_SparseRowServable):
    """f32 or bf16 FM tables scored by models/fm._fm_scores — the function
    TrainedFMModel.predict runs."""

    family = "fm"

    def __init__(self, state, dims: int) -> None:
        from ..io.checkpoint import dtype_name

        super().__init__(dims, state.device)
        self.state = state
        self.weights_dtype = dtype_name(state.w.dtype)

    def dispatch(self, staged):
        from ..models.fm import _fm_scores

        return _fm_scores(self.state, staged.indices, staged.values)

    def device_tables(self):
        return [self.state.w, self.state.v]


def q8_fm_gather(qw: torch.Tensor, w_scales: torch.Tensor,
                 qv: torch.Tensor, v_scales: torch.Tensor,
                 indices: torch.Tensor, block_shift: int):
    """Dequant-free int8 FM gather: the int8 w [B, K] and v [B, K, kp]
    windows, widened alone and scaled by their rows' per-block scales
    (``v_scales`` is [D / block_rows, kp]), f32. Pad lanes (index outside
    [0, D)) read index 0 and are masked to 0, as in q8_linear_scores.
    Returns (wg, vg)."""
    live, sidx = live_lanes(indices, qw.shape[0])
    blk = sidx >> block_shift
    zero = torch.zeros((), dtype=torch.float32, device=qw.device)
    wg = torch.where(live, qw[sidx].float() * w_scales[blk], zero)
    vg = torch.where(live[..., None], qv[sidx].float() * v_scales[blk], zero)
    return wg, vg


def q8_fm_rows(w0: torch.Tensor, qw: torch.Tensor, w_scales: torch.Tensor,
               qv: torch.Tensor, v_scales: torch.Tensor,
               indices: torch.Tensor, values: torch.Tensor,
               block_shift: int):
    """Dequant-free int8 FM row math: the `q8_fm_gather` windows combined
    with the live scorer's row math (models/fm._row_predict), f32
    throughout. Returns (p [B], sumVfX [B, kp])."""
    from ..models.fm import _row_predict

    wg, vg = q8_fm_gather(qw, w_scales, qv, v_scales, indices, block_shift)
    return _row_predict(w0, wg, vg, values)


def q8_fm_scores(w0, qw, w_scales, qv, v_scales, indices, values,
                 block_shift: int) -> torch.Tensor:
    """The scores [B] of q8_fm_rows."""
    return q8_fm_rows(w0, qw, w_scales, qv, v_scales, indices, values,
                      block_shift)[0]


class _QuantFMServable(_SparseRowServable):
    """int8 FM w and v served dequant-free (q8_fm_scores); w0 stays f32."""

    family = "fm"
    weights_dtype = "int8"

    def __init__(self, w0: torch.Tensor, qw: torch.Tensor,
                 w_scales: torch.Tensor, qv: torch.Tensor,
                 v_scales: torch.Tensor, block_rows: int, dims: int) -> None:
        super().__init__(dims, qw.device)
        self.w0 = w0
        self.qw = qw
        self.w_scales = w_scales
        self.qv = qv
        self.v_scales = v_scales
        self.block_shift = int(block_rows).bit_length() - 1

    def dispatch(self, staged):
        idx = torch.from_numpy(staged.indices).to(self.device).long()
        val = torch.from_numpy(staged.values).to(self.device)
        return q8_fm_scores(self.w0, self.qw, self.w_scales, self.qv,
                            self.v_scales, idx, val, self.block_shift)

    def device_tables(self):
        return [self.qw, self.w_scales, self.qv, self.v_scales]


class _FFMServable(_Servable):
    """An FFM model scored by models/ffm._ffm_scores — the function
    TrainedFFMModel.predict runs — over staged "field:idx:value" rows."""

    family = "ffm"

    def __init__(self, state, hyper) -> None:
        self.state = state
        self.hyper = hyper
        self.device = state.device

    def device_tables(self):
        # _ffm_scores reads v, w and w0; the FTRL and AdaGrad tables riding
        # on the state are not score-path bytes
        return [self.state.v, self.state.w, self.state.w0]

    def stage(self, instances, b_pad, width_cap):
        from ..models.ffm import _stage_ffm_rows

        return _stage_ffm_rows(instances, None, self.hyper, b_pad,
                               width_cap)[:3]

    def dispatch(self, staged):
        from ..models.ffm import _ffm_scores

        return _ffm_scores(self.state, self.hyper, *staged)

    def dummy_instance(self, width):
        return [f"{k % 8}:{k}:1.0" for k in range(width)]

    def row_keys(self, instances, width_cap: int):
        """blake2b-128 over the canonical (field, id, value) triples — ids
        mod num_features, fields normalized as staging does (negative -> 0,
        mod num_fields), values f32 — so a string row and a differently
        written equivalent share one key. Rows wider than ``width_cap``
        make the request uncacheable (truncation lives in staging);
        unparseable rows too: the parse error re-surfaces on the predict
        path with its real message."""
        from hashlib import blake2b

        from ..utils.feature import FMFeature

        hy = self.hyper
        keys = []
        try:
            for row in instances:
                if len(row) > width_cap:
                    return None
                idx = np.empty(len(row), np.int64)
                fld = np.empty(len(row), np.int64)
                val = np.empty(len(row), np.float32)
                for c, f in enumerate(row):
                    p = FMFeature.parse(f, num_features=hy.num_features,
                                        num_fields=hy.num_fields)
                    idx[c] = p.index % hy.num_features
                    fld[c] = (p.field if p.field >= 0 else 0) % hy.num_fields
                    val[c] = p.value
                keys.append(blake2b(
                    idx.tobytes() + fld.tobytes() + val.tobytes(),
                    digest_size=16).digest())
        except Exception:  # graftcheck: disable=G028 (None = uncacheable; the error re-surfaces on the predict path)
            return None
        return keys


class _PairServable(_Servable):
    """Shared ``[user, item]`` pair staging for the MF servables (f32 and
    quantized): no row width to bucket (``has_width`` False). Pad pairs are
    (0, 0); ids are checked on the host (numpy's indexing rules) before
    any device gather."""

    family = "mf"
    has_width = False

    def stage(self, instances, b_pad, width_cap):
        pairs = np.asarray(instances, np.int64).reshape(len(instances), 2)
        u = np.zeros(b_pad, np.int64)
        i = np.zeros(b_pad, np.int64)
        u[:len(instances)] = pairs[:, 0]
        i[:len(instances)] = pairs[:, 1]
        return u, i

    def finalize(self, raw, n: int):
        return np.asarray(raw)[:n]

    def dummy_instance(self, width):
        return (0, 0)

    def row_keys(self, instances, width_cap: int):
        """A (user, item) pair IS its own canonical 16-byte key — no
        digest needed (same length as the sparse families' blake2b-128,
        so cache cost accounting is uniform)."""
        try:
            pairs = np.ascontiguousarray(
                np.asarray(instances, np.int64).reshape(len(instances), 2))
        except (TypeError, ValueError):
            return None
        return [p.tobytes() for p in pairs]


class _MFServable(_PairServable):
    """f32 MF tables scored by TrainedMFModel.predict — rows gathered on
    the state's device, the dot in numpy on the host (the JAX package's
    host gather-dot, bit for bit)."""

    def __init__(self, model) -> None:
        from ..io.checkpoint import dtype_name

        self.model = model
        self.device = model.state.device
        self.weights_dtype = dtype_name(model.state.P.dtype)

    def device_tables(self):
        st = self.model.state
        return [st.P, st.Q, st.Bu, st.Bi]

    def dispatch(self, staged):
        u, i = staged
        return self.model.predict(u, i)


class _QuantMFServable(_PairServable):
    """MF over reduced P/Q tables (bf16 or int8) on the device: gather the
    requested rows, widen ONLY the gathered window to f32 — never the
    table — copy it to the host and fold the int8 row-block scales there,
    as the JAX package's host servable does; Bu, Bi and mu stay f32."""

    def __init__(self, P, Q, Bu, Bi, mu, use_bias: bool, *,
                 p_scales=None, q_scales=None, block_rows: int = 1,
                 weights_dtype: str = "bfloat16") -> None:
        self.P = P
        self.Q = Q
        self.Bu = Bu
        self.Bi = Bi
        self.mu = np.float32(mu)
        self.use_bias = bool(use_bias)
        self.p_scales = p_scales
        self.q_scales = q_scales
        self.block_shift = int(block_rows).bit_length() - 1
        self.weights_dtype = weights_dtype
        self.device = P.device

    def _rows(self, table, scales, ids):
        from ..models.mf import _host_rows

        g = _host_rows(table, ids)  # per-window widen
        if scales is not None:
            g = g * _host_rows(scales, ids >> self.block_shift)
        return g

    def dispatch(self, staged):
        from ..models.mf import _checked_ids, _host_rows

        u = _checked_ids(staged[0], self.P.shape[0], "user")
        i = _checked_ids(staged[1], self.Q.shape[0], "item")
        out = np.sum(self._rows(self.P, self.p_scales, u)
                     * self._rows(self.Q, self.q_scales, i),
                     axis=-1) + self.mu
        if self.use_bias:
            out = out + _host_rows(self.Bu, u) + _host_rows(self.Bi, i)
        return out

    def device_tables(self):
        return [t for t in (self.P, self.Q, self.p_scales, self.q_scales,
                            self.Bu, self.Bi) if t is not None]


class _TreeServable(_Servable):
    """Shared host binning + batched tree walk on the device (forest, GBT).

    f32 request staging with edges narrowed ALONGSIDE: an edge that IS a
    data value stays equal to it (both sides of the searchsorted round
    identically), so every training-valued instance bins as the tree was
    grown; a request value within one f32 ulp of an edge may bin to the
    neighbour, the f32 resolution the serving dtype accepts. Distinct edges
    that collapse under f32 (nominal codes >= 2^24, quantile edges of
    large-magnitude features) would make a bin unreachable, so then the
    model stays on the f64 path end to end — the JAX package's policy."""

    has_width = False

    def __init__(self, trees_flat, bins, device: torch.device) -> None:
        from ..models.trees.binning import BinInfo
        from ..models.trees.grow import stack_trees

        if any(np.unique(np.asarray(b.edges, np.float32)).size
               != len(b.edges) for b in bins):
            self.stage_dtype = np.float64  # graftcheck: disable=G018 (distinct bin edges collapse under f32; binning parity needs f64)
            self.bins = bins
        else:
            self.stage_dtype = np.float32
            self.bins = [BinInfo(b.nominal, np.asarray(b.edges, np.float32),
                                 b.n_bins) for b in bins]
        self.n_features = len(bins)
        self.device = device
        self.stacked = stack_trees(trees_flat, device) if trees_flat \
            else None

    def device_tables(self):
        if self.stacked is None:
            return []
        return [v for v in self.stacked.values()
                if isinstance(v, torch.Tensor)]

    def _binned(self, instances) -> np.ndarray:
        from ..models.trees.binning import bin_data

        X = np.asarray(instances, self.stage_dtype).reshape(
            len(instances), self.n_features)
        return bin_data(X, self.bins)

    def stage(self, instances, b_pad, width_cap):
        Xb = np.zeros((b_pad, self.n_features), np.int32)
        Xb[:len(instances)] = self._binned(instances)
        return Xb

    def dispatch(self, staged):
        from ..models.trees.grow import predict_forest_binned

        if self.stacked is None:
            return torch.zeros((0, staged.shape[0]), dtype=torch.float32)
        return predict_forest_binned(
            self.stacked, torch.from_numpy(staged).to(self.device))

    def leaf_values(self, raw, n: int) -> np.ndarray:
        """The walk's [T, n] leaf values on the host (the wait)."""
        return raw.detach().cpu().numpy()[:, :n]

    def dummy_instance(self, width):
        return [0.0] * self.n_features

    def row_keys(self, instances, width_cap: int):
        """blake2b-128 over the BINNED row (int32 bin ids) — the form the
        walk consumes, so two raw rows that bin alike share a key.
        Malformed requests are uncacheable (None)."""
        from hashlib import blake2b

        try:
            Xb = np.ascontiguousarray(self._binned(instances), np.int32)
        except (TypeError, ValueError):
            return None
        return [blake2b(row.tobytes(), digest_size=16).digest()
                for row in Xb]


class _ForestServable(_TreeServable):
    family = "forest"

    def __init__(self, trees, bins, classification: bool, n_classes: int,
                 device: torch.device) -> None:
        super().__init__(trees, bins, device)
        self.classification = classification
        self.n_classes = n_classes

    def finalize(self, raw, n):
        from ..models.trees.forest import forest_vote

        leaf_vals = self.leaf_values(raw, n)  # [T, n]
        if self.classification:
            return forest_vote(leaf_vals, self.n_classes)
        return leaf_vals.mean(axis=0)


class _GBTServable(_TreeServable):
    family = "gbt"

    def __init__(self, trees_flat, n_rounds: int, n_class_trees: int,
                 intercept, shrinkage: float, classes, bins,
                 device: torch.device) -> None:
        super().__init__(trees_flat, bins, device)
        self.n_rounds = n_rounds
        self.K = n_class_trees
        # at the tree path's dtype: f32 normally, f64 when the collapse
        # guard kept the model on the f64 path end to end
        self.intercept = np.asarray(intercept, self.stage_dtype)
        self.shrinkage = float(shrinkage)
        self.classes = np.asarray(classes)

    def finalize(self, raw, n):
        from ..models.trees.forest import gbt_decision_scores

        scores = gbt_decision_scores(self.leaf_values(raw, n),
                                     self.intercept, self.shrinkage,
                                     self.n_rounds, self.K)
        if scores.shape[1] == 1:
            return self.classes[(scores[:, 0] > 0).astype(int)]
        return self.classes[np.argmax(scores, axis=1)]


def _fm_serving_state(w0, w, v, dev: torch.device):
    """An FMState holding the score-path tables on ``dev``, w0 f32; the
    training-only fields are placeholders (_fm_scores reads w0, w and v
    only, and quantized artifacts drop the rest)."""
    from ..models.fm import FMState

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return FMState(w0=f32(w0), w=w.to(dev), v=v.to(dev), lambda_w0=f32(0.0),
                   lambda_w=f32(0.0),
                   lambda_v=f32(np.zeros(v.shape[1], dtype=np.float32)),
                   touched=torch.ones(w.shape[0], dtype=torch.int8,
                                      device=dev), step=0)


def _quant_servable_from_artifact(art: Artifact,
                                  dev: torch.device) -> _Servable:
    """Quantized linear, multiclass, FM or MF artifact -> dequant-free
    servable. bf16 tables reload AT bf16 (the raw uint16 bits view back
    losslessly — io.checkpoint.bf16_unpack_raw); int8 tables keep their q
    arrays + f32 scales and score through q8_linear_scores / q8_mc_scores
    / q8_fm_scores, or MF's gathered windows."""
    from ..core.state import init_linear_state
    from ..io.checkpoint import (QUANT_SCHEME_BF16, QUANT_SCHEME_INT8,
                                 SCALE_SUFFIX, bf16_unpack_raw)

    meta, a = art.meta, art.arrays
    quant = manifest_quant(meta)
    scheme, fam = quant["scheme"], art.family

    def tab(name, dt):
        return torch.from_numpy(np.array(a[name], dt)).to(dev)

    if fam == "mf":
        common = (tab("Bu", np.float32), tab("Bi", np.float32),
                  float(a["mu"]), bool(meta["use_bias"]))
        if scheme == QUANT_SCHEME_BF16:
            return _QuantMFServable(bf16_unpack_raw(a["P"]).to(dev),
                                    bf16_unpack_raw(a["Q"]).to(dev),
                                    *common, weights_dtype="bfloat16")
        if scheme == QUANT_SCHEME_INT8:
            return _QuantMFServable(
                tab("P", np.int8), tab("Q", np.int8), *common,
                p_scales=tab("P" + SCALE_SUFFIX, np.float32),
                q_scales=tab("Q" + SCALE_SUFFIX, np.float32),
                block_rows=int(quant["block_rows"]), weights_dtype="int8")
    dims = int(meta["dims"])

    if scheme == QUANT_SCHEME_BF16 and fam == "linear":
        state = init_linear_state(
            dims, use_covariance=False, dtype=torch.bfloat16,
            initial_weights=bf16_unpack_raw(a["weight"]), device=dev)
        return _LinearServable(state, dims)
    if scheme == QUANT_SCHEME_BF16 and fam == "multiclass":
        return _MulticlassServable(bf16_unpack_raw(a["weights"]).to(dev),
                                   meta["label_vocab"], dims)
    if scheme == QUANT_SCHEME_BF16 and fam == "fm":
        return _FMServable(_fm_serving_state(
            a["w0"], bf16_unpack_raw(a["w"]), bf16_unpack_raw(a["v"]), dev),
            dims)
    if scheme == QUANT_SCHEME_INT8:
        block_rows = int(quant["block_rows"])
        if fam == "linear":
            return _QuantLinearServable(
                tab("weight", np.int8), tab("weight" + SCALE_SUFFIX,
                                            np.float32), block_rows, dims)
        if fam == "multiclass":
            return _QuantMulticlassServable(
                tab("weights", np.int8),
                tab("weights" + SCALE_SUFFIX, np.float32), block_rows,
                meta["label_vocab"], dims)
        if fam == "fm":
            return _QuantFMServable(
                tab("w0", np.float32), tab("w", np.int8),
                tab("w" + SCALE_SUFFIX, np.float32), tab("v", np.int8),
                tab("v" + SCALE_SUFFIX, np.float32), block_rows, dims)
    raise ValueError(f"unknown quantized artifact: family {fam!r}, "
                     f"scheme {scheme!r}")


def _servable_from_artifact(art: Artifact, dev: torch.device) -> _Servable:
    if art.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown artifact family {art.family!r}")
    if manifest_quant(art.meta) is not None:
        return _quant_servable_from_artifact(art, dev)
    if art.family in ("forest", "gbt"):
        from .artifact import _unpack_bins, _unpack_trees

        meta, a = art.meta, art.arrays
        bins = _unpack_bins(meta, a)
        if art.family == "forest":
            return _ForestServable(
                _unpack_trees("tree", int(meta["n_trees"]), a), bins,
                bool(meta["classification"]), int(meta["n_classes"]), dev)
        n_rounds, k = int(meta["n_rounds"]), int(meta["n_class_trees"])
        return _GBTServable(_unpack_trees("tree", n_rounds * k, a), n_rounds,
                            k, a["intercept"], float(meta["shrinkage"]),
                            a["classes"], bins, dev)
    if art.family in ("mf", "ffm"):
        from .artifact import rebuild_model

        model = rebuild_model(art, dev)
        if art.family == "ffm":
            return _FFMServable(model.state, model.hyper)
        return _MFServable(model)
    if art.family == "multiclass":
        # the weights reload at the manifest dtype; the scorer reads no
        # covariance
        w = torch.from_numpy(np.asarray(art.arrays["weights"])) \
            .to(manifest_dtype(art.meta))
        return _MulticlassServable(w.to(dev), art.meta["label_vocab"],
                                   int(art.meta["dims"]))
    if art.family == "fm":
        # w and V reload at the manifest dtype; the scorer reads no
        # training-only table
        a, dt = art.arrays, manifest_dtype(art.meta)
        w, v = (torch.from_numpy(np.asarray(a[k])).to(dt) for k in "wv")
        return _FMServable(_fm_serving_state(a["w0"], w, v, dev),
                           int(art.meta["dims"]))
    from ..core.state import init_linear_state
    from ..io.checkpoint import dense_from_rows

    meta, a = art.meta, art.arrays
    # the table reloads at its MANIFEST dtype: the pack stores a bf16 table
    # widened (value-exact), and reloading it wide would serve it at twice
    # the bytes
    w, c = dense_from_rows(int(meta["dims"]), a["feature"], a["weight"],
                           a.get("covar"))
    state = init_linear_state(
        int(meta["dims"]), use_covariance=bool(meta["use_covariance"]),
        dtype=manifest_dtype(meta), initial_weights=w, initial_covars=c,
        device=dev)
    return _LinearServable(state, int(meta["dims"]))


def _servable_from_model(model, device: DeviceLike) -> _Servable:
    family = family_of(model)
    if family in ("forest", "gbt"):
        # the node arrays live on the host; they stack onto the model's
        # device unless ``device`` names another
        dev = model.device if device is None else torch.device(device)
        if family == "forest":
            return _ForestServable([t.tree for t in model.trees], model.bins,
                                   model.classification, model.n_classes,
                                   dev)
        flat = [t for round_trees in model.trees for t in round_trees]
        return _GBTServable(flat, len(model.trees),
                            len(model.trees[0]) if model.trees else 0,
                            model.intercept, model.shrinkage, model.classes,
                            model.bins, dev)
    state = model.state
    moved = device is not None and torch.device(device) != state.device
    if family == "multiclass":
        w = state.weights.to(device) if moved else state.weights
        return _MulticlassServable(w, model.label_vocab, model.dims)
    if family == "ffm":
        if moved:
            from ..models.ffm import ffm_state_from_numpy, ffm_state_to_numpy

            state = ffm_state_from_numpy(ffm_state_to_numpy(state), device)
        return _FFMServable(state, model.hyper)
    if family == "mf":
        if device is not None and torch.device(device) != state.device:
            from ..models.mf import (TrainedMFModel, mf_state_from_numpy,
                                     mf_state_to_numpy)

            model = TrainedMFModel(
                mf_state_from_numpy(mf_state_to_numpy(state), device),
                model.use_bias)
        return _MFServable(model)
    if family == "fm":
        if device is not None and torch.device(device) != state.device:
            state = _fm_serving_state(float(state.w0), state.w, state.v,
                                      torch.device(device))
        return _FMServable(state, model.dims)
    if device is not None and torch.device(device) != state.device:
        state = state.replace(
            weights=state.weights.to(device),
            covars=None if state.covars is None else state.covars.to(device))
    return _LinearServable(state, model.dims)


def _dtype_bits(name: str) -> int:
    """Bits per element of a weights_dtype name."""
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype):
        return dt.itemsize * 8
    return 32


Servable = _Servable


# Warmup dummy instances keyed by bucket shape, shared across engines:
# deploying N same-family models warms the same (batch, width) buckets,
# and dummy_instance is shape-determined (family + width + feature count +
# grid shape), so one construction serves every model. Plain dict mutation
# is GIL-atomic; a racing deploy at worst constructs one duplicate.
_WARMUP_DUMMIES: dict = {}


def _warmup_dummy(servable: _Servable, width: int):
    # the grid shape is part of the key: a sharded servable's warmup is
    # per grid, so a (1, 4) engine does not hand its entry to a (2, 2) one
    key = (servable.family, width, getattr(servable, "n_features", None),
           servable.mesh_shape)
    inst = _WARMUP_DUMMIES.get(key)
    if inst is None:
        inst = _WARMUP_DUMMIES[key] = servable.dummy_instance(width)
    return inst


def make_servable(obj, placement=None, device: DeviceLike = None) -> _Servable:
    """Artifact | artifact dir path | trained model -> servable.

    An artifact serves on ``device`` (None: the CUDA device, or a
    RuntimeError when there is none). A trained model serves where its
    state lives unless ``device`` names another device. ``placement`` is
    None, a kind string or a serving.placement.Placement: a
    ``ModelSharded`` / ``Replicated`` placement stripes the tables over its
    own grid of devices (serving/sharded.py; ``device`` is not used
    there). Its ``device_byte_budget`` is enforced here — a model whose
    per-device resident score-table bytes exceed it refuses to load
    (ModelExceedsDeviceBudget)."""
    placement = resolve_placement(placement)
    if isinstance(obj, str):
        obj = load(obj)
    if placement.kind != "single_device":
        from .sharded import sharded_servable

        return sharded_servable(obj, placement)
    if isinstance(obj, Artifact):
        servable = _servable_from_artifact(obj, resolve_device(device))
    else:
        servable = _servable_from_model(obj, device)
    if placement.device_byte_budget is not None:
        placement.check_budget(servable.table_bytes(),
                               f"{servable.family} model "
                               f"({servable.weights_dtype})")
    return servable


class ServingEngine:
    """Bucketed, warmed, metered predictor for one model version.

    `predict(instances)` is thread-safe: the tables are read-only and each
    call stages fresh host arrays. The batcher's express and general lanes,
    HTTP handler threads and a concurrent deploy's warmup may all call
    torch on one device; the rows/sec estimate is the only shared
    read-modify-write, under its lock.
    """

    def __init__(self, source, *, name: str = "default",
                 max_batch: int = 512, max_width: int = 256,
                 min_batch_bucket: int = 8, placement=None,
                 device: DeviceLike = None) -> None:
        if max_batch < min_batch_bucket:
            raise ValueError("max_batch must be >= min_batch_bucket")
        self.servable = source if isinstance(source, _Servable) \
            else make_servable(source, placement=placement, device=device)
        self.device = self.servable.device
        self.placement = self.servable.placement_info or \
            {"kind": "single_device", "devices": 1, "mesh_shape": None,
             "batch_shards": 1, "model_shards": 1}
        bs = int(self.placement.get("batch_shards", 1))
        if bs > 1 and (min_batch_bucket % bs or max_batch % bs):
            # every batch bucket must split evenly over the batch axis —
            # buckets are min_batch_bucket * 2^k capped at max_batch, so
            # divisibility of the two ends covers the whole ladder
            raise ValueError(
                f"batch_shards={bs} must divide min_batch_bucket "
                f"({min_batch_bucket}) and max_batch ({max_batch})")
        self.family = self.servable.family
        self.name = name
        self.max_batch = int(max_batch)
        self.max_width = int(max_width)
        self.min_batch_bucket = int(min_batch_bucket)
        self._latency = REGISTRY.histogram(
            f"serving.{name}.predict_seconds", LATENCY_BUCKETS)
        self._rows = REGISTRY.counter("serving", f"{name}.rows")
        self._truncated = REGISTRY.counter("serving", f"{name}.truncated_rows")
        self.warmed_buckets: List[Tuple[int, int]] = []
        # dispatch-level service-rate estimate (rows/sec EWMA over recent
        # predicts); the express and general batcher lanes both call
        # predict, so the read-modify-write is guarded
        self.rows_per_sec = 0.0
        self._rate_lock = threading.Lock()
        # per-model precision surface (/models + /metrics)
        self.weights_dtype = self.servable.weights_dtype
        self.table_bytes = int(self.servable.table_bytes())
        REGISTRY.set_gauge(f"serving.{name}.table_bytes",
                           float(self.table_bytes))
        REGISTRY.set_gauge(f"serving.{name}.weights_bits",
                           float(_dtype_bits(self.weights_dtype)))
        # placement gauges: how many devices this model's bytes spread over
        # and what one device holds (the total for single-device)
        self.per_device_table_bytes = int(getattr(
            self.servable, "per_device_table_bytes", 0)) or self.table_bytes
        REGISTRY.set_gauge(f"serving.{name}.model_shards",
                           float(self.placement.get("model_shards", 1)))
        REGISTRY.set_gauge(f"serving.{name}.per_device_table_bytes",
                           float(self.per_device_table_bytes))

    # -- buckets -------------------------------------------------------------

    def batch_buckets(self) -> List[int]:
        out, b = [], self.min_batch_bucket
        while b < self.max_batch:
            out.append(b)
            b <<= 1
        out.append(self.max_batch)
        return out

    def width_buckets(self) -> List[Optional[int]]:
        if not self.servable.has_width:
            return [None]
        out, w = [], 8
        while w < self.max_width:
            out.append(w)
            w <<= 1
        out.append(self.max_width)
        return out

    def bucket_batch(self, n: int) -> int:
        b = self.min_batch_bucket
        while b < n:
            b <<= 1
        return min(b, self.max_batch)

    # -- serving -------------------------------------------------------------

    def warmup(self) -> int:
        """Run one dummy batch through every (batch, width) bucket; returns
        the caching-allocator segments the sweep added on the device (all
        of them paid here, none in the steady state; 0 on the CPU). A
        second warmup adds none. It also builds or loads the native host
        library, through which string rows parse, so no request pays its
        compile."""
        t0 = time.perf_counter()
        native.library_path()
        self.warmed_buckets = []
        with TRACER.span("engine.warmup", args={"engine": self.name,
                                                "family": self.family}), \
                alloc_segment_guard(f"serving.{self.name}.warmup",
                                    self.device) as g:
            for width in self.width_buckets():
                inst = _warmup_dummy(self.servable, width or 8)
                for b in self.batch_buckets():
                    raw = self.servable.run_padded([inst], b, self.max_width)
                    self.servable.finalize(raw, 1)
                    self.warmed_buckets.append((b, width))
        REGISTRY.set_gauge(f"serving.{self.name}.warmup_seconds",
                           time.perf_counter() - t0)
        REGISTRY.set_gauge(f"serving.{self.name}.warmup_segments",
                           float(g.segments))
        return g.segments

    def row_keys(self, instances):
        """Per-row canonical cache keys for this request, or None when it
        is not cacheable (over-wide rows, malformed input — which then
        fails through the normal predict path). The hot-row score cache
        keys ``(model_version, row_key)`` on these (serving/cache.py)."""
        try:
            return self.servable.row_keys(instances, self.max_width)
        except Exception:  # graftcheck: disable=G028 (None = uncacheable; the error re-surfaces on the predict path)
            return None

    def predict(self, instances: Sequence):
        """Score a request of any size (chunks above max_batch). Each
        chunk's path is traced stage by stage — bucket selection, host
        pad, device dispatch, host block — as child spans of whatever
        request span is active.

        ``instances`` is a list of rows, or a pre-parsed tuple:
        ``(idx_rows, val_rows)`` per-row arrays (the
        ``models.base._stage_rows`` convention) or the flat
        ``(flat_idx, flat_val, lens)`` packed form (see _is_preparsed).
        Returns numpy f32 scores, or a list of labels for the multiclass
        family."""
        pre = (isinstance(self.servable, _SparseRowServable)
               and _is_preparsed(instances))
        off = _preparsed_offsets(instances) if pre else None
        n = _preparsed_len(instances) if pre else len(instances)
        if n == 0:
            return []
        t0 = time.perf_counter()
        outs = []
        with TRACER.span("engine.predict",
                         args={"engine": self.name, "family": self.family,
                               "rows": n}) as pspan:
            for s in range(0, n, self.max_batch):
                if pre:
                    chunk = _preparsed_chunk(instances, s,
                                             min(s + self.max_batch, n),
                                             off)
                    chunk_n = _preparsed_len(chunk)
                else:
                    chunk = instances[s:s + self.max_batch]
                    chunk_n = len(chunk)
                with TRACER.span("engine.bucket") as bspan:
                    if self.servable.has_width:
                        overwide = self.servable.count_overwide(
                            chunk, self.max_width)
                        if overwide:
                            self._truncated.increment(overwide)
                    b_pad = self.bucket_batch(chunk_n)
                    bspan.set(rows=chunk_n, b_pad=b_pad)
                with TRACER.span("engine.pad", args={"b_pad": b_pad}):
                    staged = self.servable.stage(chunk, b_pad,
                                                 self.max_width)
                with alloc_segment_guard(f"serving.{self.name}",
                                         self.device):
                    with TRACER.span("engine.dispatch"):
                        raw = self.servable.dispatch(staged)
                    # finalize copies the scores to the host: the wait for
                    # the device's launches happens here
                    with TRACER.span("engine.block"):
                        out = self.servable.finalize(raw, chunk_n)
                outs.append(out)
            self._rows.increment(n)
            dt = time.perf_counter() - t0
            self._latency.observe(dt, trace_id=TRACER.exemplar_id(pspan))
            if dt > 0:
                inst = n / dt
                with self._rate_lock:
                    self.rows_per_sec = inst if self.rows_per_sec <= 0.0 \
                        else 0.8 * self.rows_per_sec + 0.2 * inst
                    rate = self.rows_per_sec
                REGISTRY.set_gauge(f"serving.{self.name}.engine_rows_per_sec",
                                   rate)
        if len(outs) == 1:
            return outs[0]
        if isinstance(outs[0], np.ndarray):
            return np.concatenate(outs)
        return [x for o in outs for x in o]  # labels (multiclass)
