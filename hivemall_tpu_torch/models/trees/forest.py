"""Random forest + gradient tree boosting trainers — the port of
`hivemall_tpu/models/trees/forest.py`.

Mirrors the reference decision-forest subsystem (ref: SURVEY.md §2.8):
- train_randomforest_classifier (RandomForestClassifierUDTF.java:113-425):
  batch training, bootstrap bag per tree, per-node random feature subspace,
  OOB error estimate, per-tree model emission (modelId, modelType, model,
  var_importance, oob_errors, oob_tests)
- train_randomforest_regr (RandomForestRegressionUDTF.java:75)
- train_gradient_tree_boosting_classifier (GradientTreeBoostingClassifierUDTF.java:70-658):
  binary logistic GBT with shrinkage + row subsampling; multiclass via
  softmax K-trees per round

The reference parallelizes per-tree across a JVM thread pool
(SmileTaskExecutor.java:63-78); here each tree's O(N·F) histogram work runs
as torch ops on the device (grow.py) and the per-tree loop is host-side.

Every trainer takes ``device=None`` (the CUDA device, or a RuntimeError when
there is none; the tests pass ``device="cpu"``). The numpy RandomState
streams — bootstrap bags, per-tree rngs, per-node feature subspaces, GBT
subsamples — are drawn in exactly the JAX package's order, so one ``-seed``
grows the same trees in both packages wherever the histogram sums are
exact. The trained objects keep their trees as numpy TreeArrays and walk
them on their device; ``forest_from_numpy`` / ``gbt_from_numpy`` build them
from another package's numpy fields. ``row_shard=(mesh, axis)`` grows the
GBT rounds over rank-sharded rows (grow.py's module docstring).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.collectives import all_gather_host
from ...device import DeviceLike, resolve_device
from ...utils.options import Options
from .binning import BinInfo, bin_data, make_bins
from .export import to_javascript, to_json, to_opscode
from .grow import (TreeArrays, _on, _to_host, grow_forest,
                   grow_tree, predict_binned, predict_forest_binned,
                   stack_trees)


def _forest_options(gbt: bool = False) -> Options:
    o = Options()
    o.add("trees", "num_trees", True, "Number of trees [default: 50]",
          default=500 if gbt else 50, type=int)
    o.add("vars", "num_variables", True,
          "Random feature candidates per node [default: ceil(sqrt(F))]", type=float)
    o.add("depth", "max_depth", True, "Max tree depth", default=8 if gbt else 16,
          type=int)
    o.add("leafs", "max_leaf_nodes", True, "Max leaf nodes", default=512, type=int)
    o.add("splits", "min_split", True, "Min samples to split "
          "[default: 5 (gbt) / 2]", default=5 if gbt else 2, type=int)
    o.add("min_samples_leaf", None, True, "Min samples per leaf [default: 1]",
          default=1, type=int)
    o.add("seed", None, True, "Seed [default: -1 random]", default=-1, type=int)
    o.add("attrs", "attribute_types", True, "Comma-separated Q/C attribute types")
    o.add("output", "output_type", True,
          "Output type (serialization/ser, opscode/vm, javascript/js) "
          "[default: opscode]", default="opscode")
    o.add("disable_compression", None, False, "accepted for parity")
    o.add("grow", "grow_strategy", True,
          "Forest growth strategy auto|per_tree|batched [default: auto — "
          "per_tree, the JAX package's choice without row sharding]",
          default="auto")
    if gbt:
        o.add("eta", "learning_rate", True, "Learning rate [default: 0.05]",
              default=0.05, type=float)
        o.add("subsample", "sampling_frac", True, "Row subsample fraction "
              "[default: 0.7]", default=0.7, type=float)
        o.add("iters", None, True, "alias of -trees", type=int)
    else:
        o.add("rule", "split_rule", True, "Split rule GINI|ENTROPY [default GINI]",
              default="gini")
    return o


def _resolve_attrs(attrs_opt: Optional[str], F: int) -> List[str]:
    if not attrs_opt:
        return ["Q"] * F
    attrs = [a.strip().upper() for a in attrs_opt.split(",")]
    if len(attrs) != F:
        raise ValueError(f"-attrs has {len(attrs)} entries for {F} features")
    return attrs


def _num_vars(opt: Optional[float], F: int) -> int:
    """-vars: absolute count, or fraction when in (0, 1]
    (ref: RandomForestClassifierUDTF.java:115-117)."""
    if opt is None or opt <= 0:
        return max(1, int(math.ceil(math.sqrt(F))))
    if opt <= 1.0:
        return max(1, int(opt * F))
    return min(F, int(opt))


@dataclass
class TreeModel:
    model_id: int
    model_type: str  # opscode | json | javascript
    model: str
    var_importance: np.ndarray
    oob_errors: int
    oob_tests: int
    tree: TreeArrays
    bins: List[BinInfo]


def _leaf_values(trees: Sequence[TreeArrays], Xb, dev) -> np.ndarray:
    """Every tree's leaf value for every binned row, [T, N] on the host:
    one batched walk on ``dev`` and one device-to-host copy."""
    return _to_host(predict_forest_binned(stack_trees(trees, dev), Xb),
                    "walk")


@dataclass
class TrainedForest:
    trees: List[TreeModel]
    classification: bool
    n_classes: int
    bins: List[BinInfo]
    attrs: List[str]
    device: torch.device = torch.device("cpu")

    def predict(self, X) -> np.ndarray:
        """Majority vote (classification) / mean (regression) over trees —
        what rf_ensemble does over the emitted per-tree predictions. All trees
        evaluate in ONE batched walk on the forest's device (stacked node
        arrays); the vote runs on the host."""
        X = np.asarray(X, dtype=np.float64)
        Xb = bin_data(X, self.bins)
        leaf_vals = _leaf_values([t.tree for t in self.trees], Xb,
                                 self.device)  # [T, N]
        if self.classification:
            return forest_vote(leaf_vals, self.n_classes)
        return leaf_vals.mean(axis=0)

    def model_rows(self):
        """Per-tree rows (model_id, model_type, model, var_importance,
        oob_errors, oob_tests) (ref: RandomForestClassifierUDTF.java:343-351)."""
        return [(t.model_id, t.model_type, t.model, t.var_importance.tolist(),
                 t.oob_errors, t.oob_tests) for t in self.trees]


def forest_vote(leaf_vals: np.ndarray, n_classes: int) -> np.ndarray:
    """Per-tree leaf classes [T, N] -> majority-vote class ids [N]. The one
    aggregation both the trained object and the serving engine
    (serving/engine.py) run, so they cannot diverge."""
    n = leaf_vals.shape[1]
    votes = np.zeros((n, n_classes))
    for t in range(leaf_vals.shape[0]):
        votes[np.arange(n), leaf_vals[t].astype(int)] += 1
    return np.argmax(votes, axis=1)


def gbt_decision_scores(leaf_vals: np.ndarray, intercept, shrinkage: float,
                        n_rounds: int, n_class_trees: int) -> np.ndarray:
    """Per-tree leaf outputs [n_rounds * K, N] (round-major) ->
    intercept + shrinkage * per-class sums, [N, K]. Shared by
    TrainedGBT.decision_function and the serving engine."""
    n = leaf_vals.shape[1] if leaf_vals.ndim == 2 else 0
    # intercept keeps its training dtype (f64 from the boosting fit)
    scores = np.tile(np.asarray(intercept), (n, 1))
    if leaf_vals.size:
        contrib = leaf_vals.reshape(n_rounds, n_class_trees, n)
        scores += shrinkage * contrib.sum(axis=0).T
    return scores


def _var_importance(tree: TreeArrays, F: int) -> np.ndarray:
    """Accumulated impurity-gain importance recorded during growth (what the
    reference accumulates per split); split-count fallback for trees loaded
    without it."""
    if tree.importance is not None:
        return tree.importance
    imp = np.zeros(F)
    for i in range(tree.n_nodes):
        if tree.feature[i] >= 0:
            imp[tree.feature[i]] += 1.0
    return imp


def _export(tree: TreeArrays, bins, output: str) -> Tuple[str, str]:
    if output in ("opscode", "vm"):
        return "opscode", to_opscode(tree, bins)
    if output in ("javascript", "js"):
        return "javascript", to_javascript(tree, bins)
    # "serialization" -> portable JSON node graph (off-JVM analog)
    return "json", to_json(tree, bins)


def train_randomforest_classifier(X, labels, options: Optional[str] = None,
                                  classes=None, device: DeviceLike = None
                                  ) -> TrainedForest:
    """`classes`: optional GLOBAL label list — pass it when training shards
    on data partitions so every shard's exported trees vote in the same
    class-index space even if a partition is missing some class
    (the JAX package's parallel/forest_shard.py does this)."""
    cl = _forest_options().parse(options, "train_randomforest_classifier")
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(labels)
    if classes is None:
        classes, y_idx = np.unique(y, return_inverse=True)
    else:
        classes = np.unique(np.asarray(classes))  # sorted, like np.unique(y)
        y_idx = np.searchsorted(classes, y)
        if np.any(classes[np.clip(y_idx, 0, len(classes) - 1)] != y):
            raise ValueError("labels contain values not in `classes`")
    n_classes = len(classes)
    N, F = X.shape
    attrs = _resolve_attrs(cl.get("attrs"), F)
    bins = make_bins(X, attrs)
    Xb = bin_data(X, bins)
    Xbt = _on(Xb, torch.int32, dev)
    n_bins = max(b.n_bins for b in bins)
    seed = cl.get_int("seed", -1)
    rng = np.random.RandomState(seed if seed >= 0 else None)
    rule = str(cl.get("rule", "gini")).lower()
    num_vars = _num_vars(cl.get_float("vars") if cl.has("vars") else None, F)
    nominal_mask = np.array([a == "C" for a in attrs])

    # bootstrap bag per tree (ref: :362-425 TrainingTask), then grow the
    # forest (grow.grow_forest: a per-tree loop, or level-synchronous with
    # -grow batched); the binned rows go to the device once
    T = cl.get_int("trees", 50)
    W = np.stack([
        np.bincount(rng.randint(0, N, size=N), minlength=N).astype(np.float32)
        for _ in range(T)])
    tree_rngs = [np.random.RandomState(rng.randint(0, 2 ** 31)) for _ in range(T)]
    grown = grow_forest(
        Xbt, y_idx, W, nominal_mask, n_bins,
        classification=True, n_classes=n_classes, rule=rule,
        max_depth=cl.get_int("depth", 16),
        min_split=cl.get_int("splits", 2),
        min_leaf=cl.get_int("min_samples_leaf", 1),
        max_leaf_nodes=cl.get_int("leafs", 512),
        num_vars=num_vars, rngs=tree_rngs,
        strategy=str(cl.get("grow", "auto")), device=dev,
    )
    # OOB error for all trees in one batched walk (ref: :330-341)
    leaf_vals = _leaf_values(grown, Xbt, dev)  # [T, N]
    trees: List[TreeModel] = []
    output = str(cl.get("output", "opscode"))
    for t, tree in enumerate(grown):
        oob = W[t] == 0
        oob_tests = int(oob.sum())
        oob_errors = int(np.sum(leaf_vals[t, oob].astype(int) != y_idx[oob]))
        mtype, model = _export(tree, bins, output)
        trees.append(TreeModel(t, mtype, model, _var_importance(tree, F),
                               oob_errors, oob_tests, tree, bins))
    return TrainedForest(trees, True, n_classes, bins, attrs, dev)


def train_randomforest_regr(X, targets, options: Optional[str] = None,
                            device: DeviceLike = None) -> TrainedForest:
    cl = _forest_options().parse(options, "train_randomforest_regr")
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(targets, dtype=np.float32)
    N, F = X.shape
    attrs = _resolve_attrs(cl.get("attrs"), F)
    bins = make_bins(X, attrs)
    Xb = bin_data(X, bins)
    Xbt = _on(Xb, torch.int32, dev)
    n_bins = max(b.n_bins for b in bins)
    seed = cl.get_int("seed", -1)
    rng = np.random.RandomState(seed if seed >= 0 else None)
    num_vars = _num_vars(cl.get_float("vars") if cl.has("vars") else None, F)
    nominal_mask = np.array([a == "C" for a in attrs])

    T = cl.get_int("trees", 50)
    W = np.stack([
        np.bincount(rng.randint(0, N, size=N), minlength=N).astype(np.float32)
        for _ in range(T)])
    tree_rngs = [np.random.RandomState(rng.randint(0, 2 ** 31)) for _ in range(T)]
    grown = grow_forest(
        Xbt, y, W, nominal_mask, n_bins,
        classification=False,
        max_depth=cl.get_int("depth", 16),
        min_split=cl.get_int("splits", 2),
        min_leaf=cl.get_int("min_samples_leaf", 1),
        max_leaf_nodes=cl.get_int("leafs", 512),
        num_vars=num_vars, rngs=tree_rngs,
        strategy=str(cl.get("grow", "auto")), device=dev,
    )
    leaf_vals = _leaf_values(grown, Xbt, dev)  # [T, N]
    trees: List[TreeModel] = []
    output = str(cl.get("output", "opscode"))
    for t, tree in enumerate(grown):
        oob = W[t] == 0
        oob_tests = int(oob.sum())
        oob_err = float(np.sum((leaf_vals[t, oob] - y[oob]) ** 2))
        mtype, model = _export(tree, bins, output)
        trees.append(TreeModel(t, mtype, model, _var_importance(tree, F),
                               int(oob_err), oob_tests, tree, bins))
    return TrainedForest(trees, False, 0, bins, attrs, dev)


@dataclass
class TrainedGBT:
    trees: List[List[TreeArrays]]  # per round, per class (1 for binary)
    intercept: np.ndarray  # [K] initial score
    shrinkage: float
    classes: np.ndarray
    bins: List[BinInfo]
    device: torch.device = torch.device("cpu")

    def decision_function(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        Xb = bin_data(X, self.bins)
        K = len(self.intercept)
        flat = [t for round_trees in self.trees for t in round_trees]
        if not flat:
            return np.tile(self.intercept, (X.shape[0], 1))
        # rows are (round, class) in order
        leaf_vals = _leaf_values(flat, Xb, self.device)
        return gbt_decision_scores(leaf_vals, self.intercept, self.shrinkage,
                                   len(self.trees), K)

    def predict(self, X) -> np.ndarray:
        s = self.decision_function(X)
        if s.shape[1] == 1:
            return self.classes[(s[:, 0] > 0).astype(int)]
        return self.classes[np.argmax(s, axis=1)]

    def model_rows(self, output: str = "opscode"):
        """One row per (boosting round, class tree): (iter, cls,
        model_type, pred_model, intercept, shrinkage, var_importance,
        oob_error_rate, classes). The reference forwards (m, type,
        models[], intercept, shrinkage, importance, oobErrorRate) per
        round (GradientTreeBoostingClassifierUDTF.java:525-546); the
        per-class models ARRAY column flattens to one relational row per
        class here. Deviations, both documented: oob_error_rate is None
        (the subsample OOB estimate is not tracked), and a `classes` JSON
        column carries the label vocabulary — the reference needs none
        because it REQUIRES labels to be 0..K-1 indices
        (GradientTreeBoostingClassifierUDTF.java:301-303 rejects negative
        labels); this trainer accepts arbitrary labels, so predictions
        from rows must map score indices back through `classes`.
        Exported programs evaluate on RAW feature vectors (bins
        embedded), so SQL scoring is
        intercept + shrinkage * SUM(tree_predict(...)) over rounds."""
        import json as _json

        cls_vocab = _json.dumps([c.item() if hasattr(c, "item") else c
                                 for c in self.classes])
        rows = []
        for m, round_trees in enumerate(self.trees, start=1):
            for cls, tree in enumerate(round_trees):
                mtype, text = _export(tree, self.bins, output)
                imp = _var_importance(tree, len(self.bins)).tolist()
                rows.append((m, cls, mtype, text,
                             float(self.intercept[cls]),
                             float(self.shrinkage), imp, None, cls_vocab))
        return rows


def train_gradient_tree_boosting_classifier(X, labels, options: Optional[str] = None,
                                            row_shard=None,
                                            device: DeviceLike = None
                                            ) -> TrainedGBT:
    """Binary: logistic loss on y in {-1,1}, pseudo-response 2y/(1+e^{2yF}),
    shrinkage eta, row subsampling (ref: GradientTreeBoostingClassifierUDTF.java:70-658).
    Multiclass: softmax with K trees per round.

    `row_shard=(mesh, axis)`: every boosting round's histogram build runs
    over the axis' ranks with one all_reduce a level (grow.py
    _sharded_hist); parallel/forest_shard.train_gbt_data_parallel is the
    public wrapper. Every rank passes the same rows; without ``-seed`` the
    ranks draw one seed together, so they grow the same trees. The
    residuals and scores stay on the host in float64, as in JAX; each
    tree grows on ``device``."""
    cl = _forest_options(gbt=True).parse(options, "train_gradient_tree_boosting_classifier")
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    y_raw = np.asarray(labels)
    classes, y_idx = np.unique(y_raw, return_inverse=True)
    K = len(classes)
    N, F = X.shape
    attrs = _resolve_attrs(cl.get("attrs"), F)
    bins = make_bins(X, attrs)
    Xb = bin_data(X, bins)
    Xbt = _on(Xb, torch.int32, dev)
    n_bins = max(b.n_bins for b in bins)
    seed = cl.get_int("seed", -1)
    if seed < 0 and row_shard is not None:
        seed = int(all_gather_host(np.random.randint(2 ** 31), *row_shard)[0])
    rng = np.random.RandomState(seed if seed >= 0 else None)
    eta = cl.get_float("eta", 0.05)
    subsample = cl.get_float("subsample", 0.7)
    n_trees = cl.get_int("iters") or cl.get_int("trees", 500)
    depth = cl.get_int("depth", 8)
    min_split = cl.get_int("splits", 5)
    nominal_mask = np.array([a == "C" for a in attrs])
    num_vars = _num_vars(cl.get_float("vars") if cl.has("vars") else None, F)

    def fit_residual_tree(residual, mask):
        w = mask.astype(np.float32)
        return grow_tree(Xbt, residual.astype(np.float32), w, nominal_mask, n_bins,
                         classification=False, max_depth=depth, min_split=min_split,
                         min_leaf=cl.get_int("min_samples_leaf", 1),
                         max_leaf_nodes=cl.get_int("leafs", 512),
                         num_vars=num_vars, rng=rng, row_shard=row_shard,
                         device=dev)

    rounds: List[List[TreeArrays]] = []
    if K == 2:
        yb = np.where(y_idx == 1, 1.0, -1.0)
        p1 = max(1e-6, min(1 - 1e-6, float(np.mean(y_idx == 1))))
        f0 = 0.5 * math.log(p1 / (1 - p1)) * 2.0  # smile's 2-scaled logit init
        intercept = np.array([f0])
        Fx = np.full(N, f0)
        for _ in range(n_trees):
            response = 2.0 * yb / (1.0 + np.exp(2.0 * yb * Fx))
            mask = rng.rand(N) < subsample
            tree = fit_residual_tree(response, mask)
            leaf = predict_binned(tree, Xbt, device=dev)
            Fx = Fx + eta * tree.leaf_value[leaf]
            rounds.append([tree])
        return TrainedGBT(rounds, intercept, eta, classes, bins, dev)

    # multiclass softmax: the K class-trees of a round share the subsample
    # mask but fit different residuals — grown as ONE batched forest pass
    # via grow_forest's per-tree targets
    intercept = np.zeros(K)
    Fx = np.zeros((N, K))
    Y = np.eye(K)[y_idx]
    for _ in range(n_trees):
        e = np.exp(Fx - Fx.max(axis=1, keepdims=True))
        P = e / e.sum(axis=1, keepdims=True)
        mask = rng.rand(N) < subsample
        responses = (Y - P).T.astype(np.float32)  # [K, N]
        Wk = np.tile(mask.astype(np.float32), (K, 1))
        round_rngs = [np.random.RandomState(rng.randint(0, 2 ** 31))
                      for _ in range(K)]
        round_trees = grow_forest(
            Xbt, responses, Wk, nominal_mask, n_bins,
            classification=False, max_depth=depth, min_split=min_split,
            min_leaf=cl.get_int("min_samples_leaf", 1),
            max_leaf_nodes=cl.get_int("leafs", 512),
            num_vars=num_vars, rngs=round_rngs, row_shard=row_shard,
            device=dev)
        leaf_vals = _leaf_values(round_trees, Xbt, dev)  # [K, N]
        Fx += eta * leaf_vals.T
        rounds.append(round_trees)
    return TrainedGBT(rounds, intercept, eta, classes, bins, dev)


# ---- carrying models across ------------------------------------------------

def _tree_from_numpy(t) -> TreeArrays:
    """A TreeArrays from any object with TreeArrays' fields (another
    package's tree): numpy copies at the port's dtypes."""
    imp = getattr(t, "importance", None)
    return TreeArrays(
        feature=np.array(t.feature, np.int32),
        threshold_bin=np.array(t.threshold_bin, np.int32),
        nominal=np.array(t.nominal, bool),
        left=np.array(t.left, np.int32),
        right=np.array(t.right, np.int32),
        leaf_dist=(None if t.leaf_dist is None
                   else np.array(t.leaf_dist, np.float32)),
        leaf_value=np.array(t.leaf_value, np.float32),
        n_nodes=int(t.n_nodes),
        importance=None if imp is None else np.array(imp),
    )


def _bins_from_numpy(bins) -> List[BinInfo]:
    return [BinInfo(bool(b.nominal), np.array(b.edges, np.float64),  # graftcheck: disable=G003 (bin edges stay float64, as binning.py keeps them)
                    int(b.n_bins)) for b in bins]


def forest_from_numpy(trees, bins, classification: bool, n_classes: int,
                      attrs, device: DeviceLike = None) -> TrainedForest:
    """The port's TrainedForest from another package's numpy fields.

    ``trees`` holds one object per tree with TreeModel's fields (model_id,
    model_type, model, var_importance, oob_errors, oob_tests, tree — the
    tree with TreeArrays' fields), ``bins`` objects with BinInfo's. The
    forest walks its trees on ``device`` (None: the CUDA device, or a
    RuntimeError when there is none)."""
    dev = resolve_device(device)
    port_bins = _bins_from_numpy(bins)
    models = [TreeModel(int(t.model_id), str(t.model_type), t.model,
                        np.array(t.var_importance), int(t.oob_errors),
                        int(t.oob_tests), _tree_from_numpy(t.tree), port_bins)
              for t in trees]
    return TrainedForest(models, bool(classification), int(n_classes),
                         port_bins, list(attrs), dev)


def gbt_from_numpy(trees, intercept, shrinkage: float, classes, bins,
                   device: DeviceLike = None) -> TrainedGBT:
    """The port's TrainedGBT from another package's numpy fields: ``trees``
    per round, per class tree (objects with TreeArrays' fields), the
    intercept (kept float64), shrinkage, class vocabulary and bins. Walks
    on ``device`` (None: the CUDA device, or a RuntimeError when there is
    none)."""
    return TrainedGBT(
        [[_tree_from_numpy(t) for t in round_trees] for round_trees in trees],
        np.array(intercept, np.float64), float(shrinkage),  # graftcheck: disable=G003 (the intercept stays float64, as the reference's)
        np.array(classes), _bins_from_numpy(bins), resolve_device(device))
