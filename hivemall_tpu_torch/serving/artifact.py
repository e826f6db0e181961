"""Frozen serving artifacts — immutable, versioned, inference-only models.

The port writes and reads the JAX package's artifact format
(`hivemall_tpu/serving/artifact.py`): a model version is a directory that
never changes after `freeze()` —

    <dir>/
      manifest.json   # family, schema, shapes, sha256 of the array pack
      arrays.npz      # every array needed to reproduce predict()

with the same array names, dtypes and manifest keys, so an artifact frozen
by either package loads and serves in the other. Rule names and dtype names
(``"float32"``, ``"bfloat16"``, ``"int8"``) are the JAX package's strings.

The port freezes seven families:

- linear: the (feature, weight[, covar]) interchange rows of
  io/checkpoint.save_model_rows at full precision, or the dense weight
  table reduced to bf16 (raw uint16 bits) or int8 (per-block absmax with
  f32 scales);
- multiclass: the [L, D] weights (and covariances) at full precision with
  the label vocabulary in the manifest, or the weights reduced the same
  way (int8 scales blocked along the features, axis 1);
- fm: every FMState table (w0, w, the lane-padded V, the lambdas,
  touched) at full precision, or w and V reduced the same way with w0
  kept f32;
- mf: P, Q, Bu, Bi and mu at full precision, or P and Q reduced the same
  way (scales blocked along users / items) with the bias terms kept f32;
- ffm: the model's compressed blob (`TrainedFFMModel.to_blob(half_float=
  False)`, byte-equal to the JAX package's), full precision only;
- forest / gbt: every tree's node arrays (``tree<i>__feature``,
  ``__threshold_bin``, ``__nominal``, ``__left``, ``__right``,
  ``__leaf_value``; GBT's trees flattened round-major) and each feature's
  bin edges (``bin<f>__edges``, float64 at rest, their nominal flags in the
  manifest); GBT adds its float64 ``intercept`` and its ``classes``. Full
  precision only.

MF and FM artifacts may carry the top-K retrieval index (``freeze(...,
retrieval_index=...)``: signed-random-projection buckets, arrays
``index__*``), built by the same numpy code as the JAX package's, so the
index bytes are equal.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

FORMAT = "hivemall-tpu-artifact"
FORMAT_VERSION = 1
MANIFEST_FILE = "manifest.json"
ARRAYS_FILE = "arrays.npz"

# the families the port freezes and serves (all of the JAX package's)
PORTED_FAMILIES = ("linear", "multiclass", "fm", "ffm", "mf", "forest", "gbt")


def _vocab_jsonable(vocab):
    """Label vocabulary entries as JSON values (numpy scalars unwrapped)."""
    return [v.item() if hasattr(v, "item") else v for v in vocab]


def _host(x) -> np.ndarray:
    """Tensor or array -> host numpy, bf16 widened to f32 (value-exact; the
    io/checkpoint at-rest protocol)."""
    from ..io.checkpoint import np_saveable

    return np_saveable(x)


def manifest_dtype(meta: dict, default: str = "float32"):
    """The torch dtype a family's device tables must reload at — the dtype
    the model TRAINED with (``meta["weights_dtype"]``, recorded at freeze),
    not whatever width the widened-at-rest pack holds."""
    from ..io.checkpoint import dtype_from_name

    return dtype_from_name(meta.get("weights_dtype", default))


def manifest_quant(meta: dict) -> Optional[dict]:
    """The manifest's quantization block, or None for full-precision
    artifacts. Shape (recorded by ``freeze(..., quantize=...)``):

        {"scheme": "bf16" | "int8_absmax",
         "block_rows": 64,            # int8 scale-block rows (power of two)
         "tables": ["weight", ...]}   # quantized pack entries

    For int8, each quantized table name ``t`` has a sibling f32 scale
    array ``t + io.checkpoint.SCALE_SUFFIX`` in the pack; for bf16, the
    pack entry holds raw uint16 bit patterns (io.checkpoint.bf16_pack_raw)."""
    return meta.get("quant")


def family_of(model) -> str:
    """Family tag for a trained model (the adapters/model_rows.py dispatch
    order, as a name)."""
    from ..models.ffm import TrainedFFMModel
    from ..models.fm import TrainedFMModel
    from ..models.mf import TrainedMFModel
    from ..models.trees.forest import TrainedForest, TrainedGBT

    if isinstance(model, TrainedGBT):
        return "gbt"
    if isinstance(model, TrainedFMModel):
        return "fm"
    if isinstance(model, TrainedFFMModel):
        return "ffm"
    if isinstance(model, TrainedForest):
        return "forest"
    if isinstance(model, TrainedMFModel):
        return "mf"
    if hasattr(model, "label_vocab"):
        return "multiclass"
    if hasattr(model, "state") and hasattr(model.state, "weights"):
        return "linear"
    raise ValueError(f"{type(model).__name__}: no serving family")


@dataclass
class Artifact:
    """A loaded artifact: manifest + host arrays (still inert — feed to
    serving.engine.make_servable for a predictor)."""

    path: str
    manifest: dict
    arrays: Dict[str, np.ndarray] = field(repr=False)

    @property
    def family(self) -> str:
        return self.manifest["family"]

    @property
    def meta(self) -> dict:
        return self.manifest["meta"]


def _columns(model):
    from ..adapters.model_rows import iter_model_rows

    try:
        cols, _ = iter_model_rows(model)
        return cols
    except ValueError:
        return None


def _pack_trees(prefix: str, trees, arrays: dict) -> None:
    for i, t in enumerate(trees):
        arrays[f"{prefix}{i}__feature"] = np.asarray(t.feature, np.int32)
        arrays[f"{prefix}{i}__threshold_bin"] = np.asarray(t.threshold_bin,
                                                          np.int32)
        arrays[f"{prefix}{i}__nominal"] = np.asarray(t.nominal, bool)
        arrays[f"{prefix}{i}__left"] = np.asarray(t.left, np.int32)
        arrays[f"{prefix}{i}__right"] = np.asarray(t.right, np.int32)
        arrays[f"{prefix}{i}__leaf_value"] = np.asarray(t.leaf_value,
                                                       np.float32)


def _unpack_trees(prefix: str, n: int, arrays: dict):
    from ..models.trees.grow import TreeArrays

    out = []
    for i in range(n):
        feature = arrays[f"{prefix}{i}__feature"]
        out.append(TreeArrays(
            feature=feature,
            threshold_bin=arrays[f"{prefix}{i}__threshold_bin"],
            nominal=arrays[f"{prefix}{i}__nominal"],
            left=arrays[f"{prefix}{i}__left"],
            right=arrays[f"{prefix}{i}__right"],
            leaf_dist=None,
            leaf_value=arrays[f"{prefix}{i}__leaf_value"],
            n_nodes=int(feature.shape[0]),
        ))
    return out


def _pack_bins(bins, arrays: dict, meta: dict) -> None:
    meta["bins_nominal"] = [bool(b.nominal) for b in bins]
    for f, b in enumerate(bins):
        # the training-precision edges at rest; the serving engine narrows
        # them to f32 at load where no two edges collapse (_TreeServable)
        arrays[f"bin{f}__edges"] = np.asarray(b.edges, np.float64)  # graftcheck: disable=G018 (at-rest precision; serving narrows at load)


def _unpack_bins(meta: dict, arrays: dict):
    from ..models.trees.binning import BinInfo

    out = []
    for f, nominal in enumerate(meta["bins_nominal"]):
        edges = arrays[f"bin{f}__edges"]
        out.append(BinInfo(bool(nominal), edges, len(edges)))
    return out


def _build_payload(model):
    """(family, arrays dict, meta dict) for a trained model."""
    from ..io.checkpoint import dtype_name

    family = family_of(model)
    arrays: Dict[str, np.ndarray] = {}
    meta: dict = {"columns": _columns(model)}
    if family == "forest":
        _pack_trees("tree", [t.tree for t in model.trees], arrays)
        _pack_bins(model.bins, arrays, meta)
        meta.update(n_trees=len(model.trees),
                    classification=bool(model.classification),
                    n_classes=int(model.n_classes),
                    attrs=list(model.attrs))
        return family, arrays, meta
    if family == "gbt":
        flat = [t for round_trees in model.trees for t in round_trees]
        _pack_trees("tree", flat, arrays)
        _pack_bins(model.bins, arrays, meta)
        arrays["intercept"] = np.asarray(model.intercept, np.float64)  # graftcheck: disable=G018 (at-rest training dtype; serving narrows at load)
        arrays["classes"] = np.asarray(model.classes)
        meta.update(n_rounds=len(model.trees),
                    n_class_trees=len(model.trees[0]) if model.trees else 0,
                    shrinkage=float(model.shrinkage))
        return family, arrays, meta
    if family == "multiclass":
        st = model.state
        arrays["weights"] = _host(st.weights)
        if st.covars is not None:
            arrays["covars"] = _host(st.covars)
        meta.update(dims=int(model.dims),
                    label_vocab=_vocab_jsonable(model.label_vocab),
                    use_covariance=st.covars is not None,
                    weights_dtype=dtype_name(st.weights.dtype))
        return family, arrays, meta
    if family == "ffm":
        # the utils/codec compressed-blob recipe (FFMPredictionModel
        # writeExternal analog); half_float=False keeps bit-exactness
        arrays["blob"] = np.frombuffer(model.to_blob(half_float=False),
                                       np.uint8)
        hy = model.hyper
        meta.update(factors=int(hy.factors),
                    num_features=int(hy.num_features),
                    num_fields=int(hy.num_fields), v_dims=int(hy.v_dims))
        return family, arrays, meta
    if family == "mf":
        st = model.state
        for k in ("P", "Q", "Bu", "Bi", "mu"):
            arrays[k] = _host(getattr(st, k))
        meta.update(use_bias=bool(model.use_bias),
                    num_users=int(arrays["P"].shape[0]),
                    num_items=int(arrays["Q"].shape[0]),
                    factor=int(arrays["P"].shape[1]),
                    weights_dtype=dtype_name(st.P.dtype))
        return family, arrays, meta
    if family == "fm":
        st, hy = model.state, model.hyper
        for k in ("w0", "w", "v", "lambda_w0", "lambda_w", "lambda_v",
                  "touched"):
            arrays[k] = _host(getattr(st, k))
        meta.update(dims=int(model.dims), factors=int(hy.factors),
                    classification=bool(hy.classification),
                    sigma=float(hy.sigma), seed=int(hy.seed),
                    lambda0=float(hy.lambda0),
                    weights_dtype=dtype_name(st.w.dtype))
        return family, arrays, meta
    # the io/checkpoint.save_model_rows interchange layout: untouched
    # entries are 0 (weights) / 1 (covars) by construction, so
    # dense_from_rows reproduces the live tables exactly
    rows = model.model_rows()
    arrays["feature"] = np.asarray(rows[0], np.int64)
    arrays["weight"] = _host(rows[1])
    if len(rows) == 3 and rows[2] is not None:
        arrays["covar"] = _host(rows[2])
    meta.update(dims=int(model.dims), rule=model.rule.name,
                use_covariance=bool(model.rule.use_covariance),
                weights_dtype=dtype_name(model.state.weights.dtype))
    return family, arrays, meta


# Families with a float weight table the quantized serving path understands
# (the sparse-row scorers and the MF embedding lookup). Trees walk int32
# structure and FFM rides an opaque codec blob, so freeze(quantize=...)
# refuses them, as in the JAX package.
QUANTIZABLE_FAMILIES = ("linear", "multiclass", "fm", "mf")


def _build_quantized_payload(model, quantize: str, block_rows: int):
    """(family, arrays, meta) holding ONLY the score-path tables, reduced.

    Quantized artifacts are serving-only by construction: the linear and
    multiclass covariances and FM's lambdas and touched mask are training
    state the scorers never read, so they are dropped, and the manifest's
    ``quant`` block records the layout. Weight tables (linear ``weight``;
    multiclass ``weights``; FM ``w`` and the lane-padded ``v``, with ``w0``
    kept f32) store as raw bf16 bits (``bf16``) or as per-block absmax int8
    with their f32 scales alongside (``<name>__scale``), blocked along the
    feature axis the scorers gather by — so FM's ``v`` scales are
    ``[ceil(D / block_rows), kp]`` and multiclass's ``[L, ceil(D /
    block_rows)]``. MF's P and Q reduce the same way along users / items;
    Bu, Bi and mu stay f32.
    """
    from ..io.checkpoint import (QUANT_SCHEME_BF16, QUANT_SCHEME_INT8,
                                 SCALE_SUFFIX, bf16_pack_raw, quantize_int8)

    family = family_of(model)
    if family not in QUANTIZABLE_FAMILIES:
        raise ValueError(
            f"freeze(quantize={quantize!r}): family {family!r} has no "
            f"quantized serving path (supported: "
            f"{', '.join(QUANTIZABLE_FAMILIES)})")
    arrays: Dict[str, np.ndarray] = {}
    meta: dict = {"columns": _columns(model)}
    # (pack name, host f32 table, quantized axis): the axis the serving
    # gather indexes by, so scale blocks align with gathered ids
    if family == "linear":
        tables = [("weight", _host(model.state.weights), 0)]
        meta.update(dims=int(model.dims), rule=model.rule.name,
                    use_covariance=False)  # covariance dropped: never scored
    elif family == "multiclass":
        tables = [("weights", _host(model.state.weights), 1)]
        meta.update(dims=int(model.dims),
                    label_vocab=_vocab_jsonable(model.label_vocab),
                    use_covariance=False)
    elif family == "fm":
        st, hy = model.state, model.hyper
        tables = [("w", _host(st.w), 0), ("v", _host(st.v), 0)]
        arrays["w0"] = np.asarray(_host(st.w0), np.float32)
        meta.update(dims=int(model.dims), factors=int(hy.factors),
                    classification=bool(hy.classification))
    else:  # mf
        st = model.state
        tables = [("P", _host(st.P), 0), ("Q", _host(st.Q), 0)]
        for k in ("Bu", "Bi", "mu"):  # bias terms: tiny, stay f32
            arrays[k] = np.asarray(_host(getattr(st, k)), np.float32)
        meta.update(use_bias=bool(model.use_bias),
                    num_users=int(st.P.shape[0]),
                    num_items=int(st.Q.shape[0]),
                    factor=int(st.P.shape[1]))

    if quantize == "bf16":
        for name, tab, _axis in tables:
            arrays[name] = bf16_pack_raw(tab)
        meta["weights_dtype"] = "bfloat16"
        meta["quant"] = {"scheme": QUANT_SCHEME_BF16,
                         "tables": [n for n, _, _ in tables]}
    else:  # int8
        for name, tab, axis in tables:
            q, scales = quantize_int8(tab, block_rows, axis=axis)
            arrays[name] = q
            arrays[name + SCALE_SUFFIX] = scales
        meta["weights_dtype"] = "int8"
        meta["quant"] = {"scheme": QUANT_SCHEME_INT8,
                         "block_rows": int(block_rows),
                         "tables": [n for n, _, _ in tables]}
    return family, arrays, meta


def _add_retrieval_index(model, family: str, arrays: dict, meta: dict,
                         opts: dict) -> None:
    """Build the retrieval LSH index into a freeze payload (freeze's
    ``retrieval_index=``): SRP buckets over the model's f32 item vectors
    — always the pre-quantization tables, so a bf16/int8 artifact carries
    the same index as its f32 twin."""
    if family not in ("mf", "fm"):
        raise ValueError(
            f"retrieval_index: family {family!r} has no retrieval path "
            f"(mf/fm only)")
    n_planes = int(opts.pop("planes", 8))
    seed = int(opts.pop("seed", 0))
    item_range = opts.pop("item_range", None)
    if opts:
        raise ValueError(
            f"retrieval_index: unknown keys {sorted(opts)} (accepted: "
            f"planes, seed, item_range)")
    vecs = np.asarray(_host(model.state.Q if family == "mf"
                            else model.state.v), np.float32)
    full = (0, vecs.shape[0])
    if item_range is None:
        lo, hi = full
    else:
        lo, hi = int(item_range[0]), int(item_range[1])
        if not (full[0] <= lo < hi <= full[1]):
            raise ValueError(
                f"retrieval_index: item_range ({lo}, {hi}) outside the "
                f"model's {full}")
    from .retrieval import build_srp_index

    planes, item_ids, offsets = build_srp_index(vecs[lo:hi], n_planes,
                                                seed, item_lo=lo)
    arrays["index__planes"] = planes
    arrays["index__item_ids"] = item_ids
    arrays["index__offsets"] = offsets
    meta["index"] = {"scheme": "srp_lsh", "planes": n_planes,
                     "seed": seed, "item_lo": lo, "item_hi": hi}


def freeze(model, path: str, *, name: Optional[str] = None,
           version: Optional[str] = None, quantize: Optional[str] = None,
           quant_block_rows: Optional[int] = None,
           retrieval_index: Optional[dict] = None) -> dict:
    """Freeze a trained model into an immutable artifact directory.

    Returns the manifest. The directory must not already hold an artifact
    (versions are immutable — freeze a NEW directory and hot-swap it in via
    serving.server.ModelRegistry.deploy).

    ``quantize="bf16"|"int8"`` stores the weight table reduced; the serving
    engine then scores it dequant-free at the manifest dtype.
    ``quant_block_rows`` sets the int8 scale-block row count (power of
    two; default io.checkpoint.QUANT_BLOCK_ROWS).

    ``retrieval_index={"planes": int, "seed": int, "item_range": (lo, hi)}``
    (MF/FM only, every key optional) additionally builds the top-K
    retrieval LSH index into the artifact: signed-random-projection
    buckets over the item vectors (MF: Q rows; FM: v rows over
    ``item_range``, default the full feature space) as ``index__*``
    arrays plus a manifest ``meta["index"]`` block, hashed from the f32
    vectors before any quantization and deterministic in ``seed``
    (serving/retrieval.py).
    """
    os.makedirs(path, exist_ok=True)
    mpath = os.path.join(path, MANIFEST_FILE)
    if os.path.exists(mpath):
        raise FileExistsError(
            f"{mpath} exists — artifacts are immutable; freeze a new "
            f"version directory instead")
    if quantize is None:
        if quant_block_rows is not None:
            raise ValueError("quant_block_rows requires quantize=")
        family, arrays, meta = _build_payload(model)
    elif quantize in ("bf16", "int8"):
        from ..io.checkpoint import QUANT_BLOCK_ROWS

        family, arrays, meta = _build_quantized_payload(
            model, quantize, quant_block_rows or QUANT_BLOCK_ROWS)
    else:
        raise ValueError(f"quantize must be 'bf16' or 'int8', "
                         f"got {quantize!r}")
    if retrieval_index is not None:
        _add_retrieval_index(model, family, arrays, meta,
                             dict(retrieval_index))
    apath = os.path.join(path, ARRAYS_FILE)
    # savez into memory so the pack is written AND hashed in one pass
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    data = buf.getvalue()
    digest = hashlib.sha256(data).hexdigest()
    with open(apath, "wb") as f:
        f.write(data)
    manifest = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "family": family,
        "name": name or family,
        "version": version or "1",
        "created_unix": time.time(),
        "arrays": ARRAYS_FILE,
        "sha256": digest,
        "meta": meta,
    }
    # atomic manifest publish: the artifact "exists" only once the rename
    # lands, so a concurrent load never sees a half-written directory
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".manifest-")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, mpath)
    return manifest


def load(path: str, verify: bool = True) -> Artifact:
    """Load an artifact directory (manifest + host arrays); verifies the
    array pack against the manifest hash unless `verify=False`."""
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} directory")
    if manifest.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"{path}: artifact format v{manifest['format_version']} is newer "
            f"than this runtime (v{FORMAT_VERSION})")
    apath = os.path.join(path, manifest["arrays"])
    # one read serves both the hash check and np.load
    with open(apath, "rb") as f:
        data = f.read()
    if verify:
        digest = hashlib.sha256(data).hexdigest()
        if digest != manifest["sha256"]:
            raise ValueError(f"{apath}: sha256 mismatch — artifact corrupt "
                             f"or tampered")
    with np.load(io.BytesIO(data)) as z:
        arrays = {k: z[k] for k in z.files}
    return Artifact(path=path, manifest=manifest, arrays=arrays)


def _host_table(t: torch.Tensor):
    """A tensor's host copy at its own dtype: numpy, except bf16, which
    stays a CPU torch tensor (numpy has no bf16)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


# Families whose score tables stripe along a gathered axis (the sharded
# serving placement's input, serving/sharded.py); trees and FFM's codec
# blob have none, as in the JAX package.
SHARDABLE_FAMILIES = ("linear", "multiclass", "fm", "mf")


def host_score_tables(source) -> dict:
    """Family-normalized HOST view of the score-path tables — the input of
    serving/sharded.py's striped placement and of serving/retrieval.py's
    RetrievalEngine (the JAX package's ``host_score_tables``).

    ``source`` is an :class:`Artifact` or a trained model. Returns::

        {"family": str,
         "weights_dtype": str,              # the dtype tables SERVE at
         "quant": None | manifest quant block,
         "meta": {...},                     # dims / label_vocab /
                                            # factors /
                                            # classification / use_bias / ...
         "striped": [(name, array, axis, grid)],
         "scales": {name: f32 scale array}, # int8 only, same axis as name
         "replicated": {name: array}}       # w0 / mu

    ``grid`` names the id space the table's axis is gathered by
    ("features" for linear/multiclass/FM, "users"/"items" for MF). Tables come back
    at their SERVING dtype: f32 and int8 tables and every scale as numpy
    arrays, a bf16 table as a CPU torch bf16 tensor (numpy has no bf16;
    the JAX package returns an ml_dtypes array there). The score path has
    no covariances and no optimizer slots."""
    from ..io.checkpoint import (QUANT_SCHEME_BF16, SCALE_SUFFIX,
                                 bf16_unpack_raw, dense_from_rows)

    if isinstance(source, Artifact):
        family, a, meta = source.family, source.arrays, dict(source.meta)
        quant = manifest_quant(source.meta)
    else:
        family, a, meta, quant = family_of(source), None, {}, None
    if family not in SHARDABLE_FAMILIES:
        raise ValueError(
            f"family {family!r} has no sharded serving path (stripeable "
            f"families: {', '.join(SHARDABLE_FAMILIES)}); serve it "
            f"single-device")

    out = {"family": family, "quant": quant, "meta": meta,
           "striped": [], "scales": {}, "replicated": {}}

    def table(name, out_name=None):
        """Pack entry at its serving dtype (artifact source only);
        ``out_name`` keys int8 scales when the striped name differs from
        the pack name (linear stores "weight", serves as "weights")."""
        if quant is None:
            # the manifest dtype pin: the pack stores reduced tables
            # widened value-exactly; reload at the TRAINED width
            return _host_table(torch.from_numpy(np.asarray(
                a[name], np.float32)).to(manifest_dtype(meta)))
        if quant["scheme"] == QUANT_SCHEME_BF16:
            return bf16_unpack_raw(a[name])
        out["scales"][out_name or name] = np.asarray(a[name + SCALE_SUFFIX],
                                                     np.float32)
        return np.asarray(a[name], np.int8)

    if a is not None:  # ---- artifact source --------------------------------
        out["weights_dtype"] = meta.get("weights_dtype", "float32")
        if family == "linear":
            if quant is None:
                w, _ = dense_from_rows(int(meta["dims"]), a["feature"],
                                       a["weight"], None)
                w = _host_table(torch.from_numpy(np.asarray(
                    w, np.float32)).to(manifest_dtype(meta)))
            else:
                w = table("weight", out_name="weights")
            out["striped"].append(("weights", w, 0, "features"))
        elif family == "multiclass":
            out["striped"].append(("weights", table("weights"), 1,
                                   "features"))
        elif family == "fm":
            out["striped"] += [("w", table("w"), 0, "features"),
                               ("v", table("v"), 0, "features")]
            out["replicated"]["w0"] = np.asarray(a["w0"], np.float32)
        else:  # mf
            out["striped"] += [("P", table("P"), 0, "users"),
                               ("Q", table("Q"), 0, "items"),
                               ("Bu", np.asarray(a["Bu"], np.float32), 0,
                                "users"),
                               ("Bi", np.asarray(a["Bi"], np.float32), 0,
                                "items")]
            out["replicated"]["mu"] = np.asarray(a["mu"], np.float32)
            meta.setdefault("num_users", int(out["striped"][0][1].shape[0]))
            meta.setdefault("num_items", int(out["striped"][1][1].shape[0]))
        return out

    # ---- live trained model -------------------------------------------------
    from ..io.checkpoint import dtype_name

    st = source.state
    if family == "linear":
        w = _host_table(st.weights)
        out["striped"].append(("weights", w, 0, "features"))
        meta["dims"] = int(source.dims)
    elif family == "multiclass":
        w = _host_table(st.weights)
        out["striped"].append(("weights", w, 1, "features"))
        meta.update(dims=int(source.dims),
                    label_vocab=list(source.label_vocab))
    elif family == "fm":
        w = _host_table(st.w)
        out["striped"] += [("w", w, 0, "features"),
                           ("v", _host_table(st.v), 0, "features")]
        out["replicated"]["w0"] = np.asarray(_host(st.w0), np.float32)
        meta.update(dims=int(source.dims),
                    classification=bool(source.hyper.classification))
    else:  # mf
        w = _host_table(st.P)
        out["striped"] += [("P", w, 0, "users"),
                           ("Q", _host_table(st.Q), 0, "items"),
                           ("Bu", np.asarray(_host(st.Bu), np.float32), 0,
                            "users"),
                           ("Bi", np.asarray(_host(st.Bi), np.float32), 0,
                            "items")]
        out["replicated"]["mu"] = np.asarray(_host(st.mu), np.float32)
        meta.update(use_bias=bool(source.use_bias),
                    num_users=int(w.shape[0]),
                    num_items=int(out["striped"][1][1].shape[0]))
    out["weights_dtype"] = dtype_name(w.dtype)
    return out


def rebuild_model(artifact: Artifact, device: DeviceLike = None):
    """Reconstruct a predictable model object from an artifact — as in the
    JAX package, an MF artifact rebuilds a TrainedMFModel and an FFM
    artifact a TrainedFFMModel (from its blob), on ``device`` (None is the
    CUDA device, or a RuntimeError when there is none); a quantized
    artifact has none, and the linear, multiclass and FM families are
    served through serving.engine.make_servable, not a model object."""
    family = artifact.family
    a, meta = artifact.arrays, artifact.meta
    if manifest_quant(meta) is not None:
        raise ValueError(
            f"rebuild_model: {family!r} artifact is quantized — there is no "
            f"full-precision model to rebuild; serve it via "
            f"serving.engine.make_servable (dequant-free score path)")
    if family == "ffm":
        from ..models.ffm import TrainedFFMModel

        return TrainedFFMModel.from_blob(a["blob"].tobytes(), device=device)
    if family == "mf":
        from ..models.mf import MFState, TrainedMFModel

        dev = resolve_device(device)
        n_u, n_i = int(meta["num_users"]), int(meta["num_items"])
        dt = manifest_dtype(meta)  # reload at the TRAINED dtype

        def t(name):
            return torch.tensor(np.asarray(a[name], np.float32)) \
                .to(dtype=dt, device=dev)

        st = MFState(
            P=t("P"), Q=t("Q"), Bu=t("Bu"), Bi=t("Bi"), mu=t("mu"),
            P_gg=None, Q_gg=None,
            touched_u=torch.ones(n_u, dtype=torch.int8, device=dev),
            touched_i=torch.ones(n_i, dtype=torch.int8, device=dev), step=0)
        return TrainedMFModel(state=st, use_bias=bool(meta["use_bias"]))
    raise ValueError(f"rebuild_model: family {family!r} is served via "
                     f"serving.engine.make_servable, not a model object")
