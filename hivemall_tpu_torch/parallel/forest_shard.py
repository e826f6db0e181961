"""Multi-process random-forest training (the port of
``hivemall_tpu/parallel/forest_shard.py``).

The reference trains forests across the cluster by letting EACH mapper
grow its own trees on its data partition and emit per-tree model rows;
prediction then majority-votes over all emitted trees with rf_ensemble
(ref: smile/classification/RandomForestClassifierUDTF.java:343-351,
smile/tools/RandomForestEnsembleUDAF.java:34). Here each rank grows its
share of the forest on its local rows, and the exported model rows (opcode
/ json programs on RAW feature units) merge rank-agnostically, exactly
like the reference's model-table rows.

This module is the glue: tree-count sharding, disjoint global model ids,
decorrelated per-rank seeds, a consistent global class-index space, the
data-parallel GBT, and the row-level ensemble evaluator used to predict
from merged rows (the 6-tuples ``TrainedForest.model_rows()`` emits:
(model_id, model_type, model, var_importance, oob_errors, oob_tests)).
"""

from __future__ import annotations

import shlex
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from ..ensemble import rf_ensemble
from ..models.trees.forest import (TrainedForest,
                                   train_gradient_tree_boosting_classifier,
                                   train_randomforest_classifier,
                                   train_randomforest_regr)
from ..models.trees.predict import compile_tree
from .mesh import make_mesh


def shard_tree_counts(total_trees: int, process_count: int) -> List[int]:
    """Near-even split of the forest across processes (first shards take the
    remainder — the same arithmetic Hadoop uses for map splits)."""
    base, rem = divmod(total_trees, process_count)
    return [base + (1 if p < rem else 0) for p in range(process_count)]


def _resolve_process(process_index: Optional[int],
                     process_count: Optional[int]) -> Tuple[int, int]:
    """The caller's (index, count), else this rank and the world size (a
    world of one when torch.distributed is not initialised)."""
    if process_index is not None and process_count is not None:
        return process_index, process_count
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _split_opt(options: str) -> Tuple[int, int, List[str]]:
    """Pull -trees and -seed out of an option string (shlex-tokenized like
    Options.parse, dash-insensitive like its option matching), keep the rest
    verbatim."""
    kept: List[str] = []
    toks = shlex.split(options or "")
    i = 0
    trees, seed = 50, -1
    while i < len(toks):
        t = toks[i]
        bare = t.lstrip("-") if t.startswith("-") else ""
        if bare in ("trees", "num_trees", "seed"):
            if i + 1 >= len(toks):
                raise ValueError(f"option {t} requires a value")
            if bare == "seed":
                seed = int(toks[i + 1])
            else:
                trees = int(toks[i + 1])
            i += 2
        else:
            kept.append(t)
            i += 1
    return trees, seed, kept


def train_randomforest_sharded(
    X, y, options: str = "", *, classification: bool = True,
    classes=None, process_index: Optional[int] = None,
    process_count: Optional[int] = None, device: DeviceLike = None,
) -> TrainedForest:
    """Train THIS rank's shard of the forest on its local (X, y) partition.

    `-trees N` in `options` is the GLOBAL forest size; this rank grows its
    `shard_tree_counts` share with a seed decorrelated by its index
    (`-seed` omitted stays nondeterministic, like the trainers) and model
    ids offset so rows from all ranks merge without collision. The index
    and count default to the torch.distributed rank and world size.

    `classes`: the GLOBAL label list. Pass it whenever partitions may miss a
    class — each shard's trees then vote in the same class-index space. When
    None, the global labels are taken from the LOCAL partition (safe only if
    every partition contains every class)."""
    if classes is not None and not classification:
        raise ValueError("`classes` only applies to classification forests")
    p, P = _resolve_process(process_index, process_count)
    total, seed, kept = _split_opt(options)
    counts = shard_tree_counts(total, P)
    local = counts[p]
    offset = sum(counts[:p])
    if local == 0:
        return TrainedForest([], classification,
                             0 if classes is None else len(np.unique(classes)),
                             [], [])
    opt_parts = [shlex.quote(t) for t in kept] + [f"-trees {local}"]
    if seed >= 0:
        opt_parts.append(f"-seed {seed * 7919 + p}")
    opt = " ".join(opt_parts)
    if classification:
        forest = train_randomforest_classifier(X, y, opt, classes=classes,
                                               device=device)
    else:
        forest = train_randomforest_regr(X, y, opt, device=device)
    for t in forest.trees:
        t.model_id += offset
    return forest


def train_gbt_data_parallel(X, y, options: str = "", mesh=None,
                            device: DeviceLike = None):
    """Data-parallel gradient tree boosting over the ranks of a 1-D mesh.

    Boosting rounds are sequential, so the device-scalable axis is WITHIN
    each round: the histogram build over all N rows. Every rank passes the
    same (X, y); each builds the partial histogram of its slice of the
    rows and one all_reduce a tree level sums them (models/trees/grow.py
    _sharded_hist); the split search and every growth decision then run on
    the global histogram, identical to single-rank growth up to the order
    of that sum."""
    mesh = mesh if mesh is not None else make_mesh(device=device)
    if len(mesh.axis_names) != 1:
        raise ValueError("train_gbt_data_parallel needs a 1-D mesh, got "
                         f"axes {mesh.axis_names}")
    return train_gradient_tree_boosting_classifier(
        X, y, options, row_shard=(mesh, mesh.axis_names[0]),
        device=mesh.device)


def ensemble_predict_rows(model_rows: Sequence[Tuple], X,
                          classification: bool = True,
                          classes=None) -> np.ndarray:
    """Predict from MERGED per-tree model rows (any mix of ranks): evaluate
    each exported tree program on raw features and rf_ensemble the votes —
    the reference's tree_predict + rf_ensemble SQL plan. Opcode programs
    run in ONE pass of the native library's ``forest_eval`` (which raises
    without a C++ compiler); other formats compile once each
    (predict.compile_tree). `classes` (classification): map the voted class
    indices back to original labels."""
    if not model_rows:
        raise ValueError("no model rows to ensemble")
    X = np.asarray(X, dtype=np.float64)
    if all(row[1].lower() in ("opscode", "vm") for row in model_rows):
        from .. import native
        from ..models.trees.vm import compile_script_arrays

        leaf_vals = native.forest_eval(
            [compile_script_arrays(row[2]) for row in model_rows], X)
    else:
        evals = [compile_tree(row[1], row[2]) for row in model_rows]
        leaf_vals = np.stack([[ev(x) for x in X] for ev in evals])  # [T, N]
    if classification:
        out = np.array([rf_ensemble(int(v) for v in leaf_vals[:, r])[0]
                        for r in range(X.shape[0])], dtype=np.float64)
        if classes is not None:
            return np.unique(np.asarray(classes))[out.astype(int)]
        return out
    return leaf_vals.mean(axis=0)
