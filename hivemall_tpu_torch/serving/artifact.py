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

The port freezes two families:

- linear: the (feature, weight[, covar]) interchange rows of
  io/checkpoint.save_model_rows at full precision, or the dense weight
  table reduced to bf16 (raw uint16 bits) or int8 (per-block absmax with
  f32 scales);
- fm: every FMState table (w0, w, the lane-padded V, the lambdas,
  touched) at full precision, or w and V reduced the same way with w0
  kept f32.

Other families, and the retrieval index, are later slices of the port and
raise by name.
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

FORMAT = "hivemall-tpu-artifact"
FORMAT_VERSION = 1
MANIFEST_FILE = "manifest.json"
ARRAYS_FILE = "arrays.npz"

# families the JAX package freezes whose port is a later slice
LATER_SLICE_FAMILIES = ("multiclass", "ffm", "mf", "forest", "gbt")


def _later_slice(family: str, what: str) -> ValueError:
    return ValueError(
        f"{what}: the {family!r} family is a later slice of the torch port "
        f"(hivemall_tpu_torch); it serves the linear and fm families")


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
    order, as a name). The port trains the linear and fm families."""
    from ..models.fm import TrainedFMModel

    if isinstance(model, TrainedFMModel):
        return "fm"
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


def _build_payload(model):
    """(family, arrays dict, meta dict) for a trained model."""
    from ..io.checkpoint import dtype_name

    family = family_of(model)
    if family not in ("linear", "fm"):
        raise _later_slice(family, "freeze")
    arrays: Dict[str, np.ndarray] = {}
    meta: dict = {"columns": _columns(model)}
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


# Families with a float weight table the JAX package's quantized serving
# path understands; the port has linear and fm.
QUANTIZABLE_FAMILIES = ("linear", "multiclass", "fm", "mf")


def _build_quantized_payload(model, quantize: str, block_rows: int):
    """(family, arrays, meta) holding ONLY the score-path tables, reduced.

    Quantized artifacts are serving-only by construction: the linear
    covariance and FM's lambdas and touched mask are training state the
    scorers never read, so they are dropped, and the manifest's ``quant``
    block records the layout. Weight tables (linear ``weight``; FM ``w``
    and the lane-padded ``v``, with ``w0`` kept f32) store as raw bf16 bits
    (``bf16``) or as per-block absmax int8 with their f32 scales alongside
    (``<name>__scale``), blocked along the feature axis the scorers gather
    by — so FM's ``v`` scales are ``[ceil(D / block_rows), kp]``.
    """
    from ..io.checkpoint import (QUANT_SCHEME_BF16, QUANT_SCHEME_INT8,
                                 SCALE_SUFFIX, bf16_pack_raw, quantize_int8)

    family = family_of(model)
    if family not in QUANTIZABLE_FAMILIES:
        raise ValueError(
            f"freeze(quantize={quantize!r}): family {family!r} has no "
            f"quantized serving path (supported: "
            f"{', '.join(QUANTIZABLE_FAMILIES)})")
    if family not in ("linear", "fm"):
        raise _later_slice(family, f"freeze(quantize={quantize!r})")
    arrays: Dict[str, np.ndarray] = {}
    meta: dict = {"columns": _columns(model)}
    # (pack name, host f32 table, quantized axis): the axis the serving
    # gather indexes by, so scale blocks align with gathered ids
    if family == "linear":
        tables = [("weight", _host(model.state.weights), 0)]
        meta.update(dims=int(model.dims), rule=model.rule.name,
                    use_covariance=False)  # covariance dropped: never scored
    else:
        st, hy = model.state, model.hyper
        tables = [("w", _host(st.w), 0), ("v", _host(st.v), 0)]
        arrays["w0"] = np.asarray(_host(st.w0), np.float32)
        meta.update(dims=int(model.dims), factors=int(hy.factors),
                    classification=bool(hy.classification))

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
    two; default io.checkpoint.QUANT_BLOCK_ROWS). ``retrieval_index`` (the
    top-K LSH index) is a later slice of the port and raises.
    """
    if retrieval_index is not None:
        raise ValueError(
            "retrieval_index: top-K retrieval (serving/retrieval.py) is a "
            "later slice of the torch port (hivemall_tpu_torch)")
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


def rebuild_model(artifact: Artifact):
    """Reconstruct a predictable model object from an artifact — as in the
    JAX package, a quantized artifact has none, and the linear family is
    served through serving.engine.make_servable, not a model object."""
    family = artifact.family
    if manifest_quant(artifact.meta) is not None:
        raise ValueError(
            f"rebuild_model: {family!r} artifact is quantized — there is no "
            f"full-precision model to rebuild; serve it via "
            f"serving.engine.make_servable (dequant-free score path)")
    if family in ("ffm", "mf"):
        raise _later_slice(family, "rebuild_model")
    raise ValueError(f"rebuild_model: family {family!r} is served via "
                     f"serving.engine.make_servable, not a model object")
