"""Tree model export formats — the port's copy of
`hivemall_tpu/models/trees/export.py`: the same text, byte for byte, for the
same TreeArrays and bins.

The reference exports trees three ways (ref: smile/classification/DecisionTree.java):
- **opscode** — the StackMachine script (`opCodegen`, :300-341)
- **serialization** — compressed Java-serialized Node graph (`predictSerCodegen`, :927)
- **javascript** — nested if/else source

We export:
- the same opscode format (verbatim grammar: `push x[f]; push v; ifle L; ...;
  call end`), evaluable by vm.StackMachine and by the reference's own VM;
- a portable JSON node-graph (the serialization analog — Java object streams
  make no sense off-JVM);
- javascript source (nested ternaries) for parity.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from .binning import BinInfo, threshold_of
from .grow import TreeArrays

# Numeric model-type ids, matching the reference enum (ref: smile/ModelType.java:20-27):
# positive = uncompressed, negative = compressed variant. Our "json" plays the
# serialization role off-JVM.
MODEL_TYPE_IDS = {
    "opscode": 1,
    "javascript": 2,
    "json": 3,  # serialization analog
    "opscode_compressed": -1,
    "javascript_compressed": -2,
    "json_compressed": -3,
}


def model_type_id(name: str, compressed: bool = False) -> int:
    key = f"{name}_compressed" if compressed else name
    return MODEL_TYPE_IDS[key]


def _op_codegen(tree: TreeArrays, bins: List[BinInfo], node: int,
                scripts: List[str], depth: int) -> int:
    """Mirror of DecisionTree.Node.opCodegen (ref: DecisionTree.java:300-341):
    true branch falls through, false branch target patched into the if op."""
    self_depth = 0
    f = int(tree.feature[node])
    if f < 0:
        scripts.append(f"push {_leaf_output(tree, node)}")
        scripts.append("goto last")
        return 2
    v = threshold_of(bins, f, int(tree.threshold_bin[node]))
    scripts.append(f"push x[{f}]")
    scripts.append(f"push {v}")
    op = "ifeq" if tree.nominal[node] else "ifle"
    scripts.append(f"{op} ")
    depth += 3
    self_depth += 3
    true_depth = _op_codegen(tree, bins, int(tree.left[node]), scripts, depth)
    self_depth += true_depth
    scripts[depth - 1] = f"{op} {depth + true_depth}"
    false_depth = _op_codegen(tree, bins, int(tree.right[node]), scripts,
                              depth + true_depth)
    return self_depth + false_depth


def _leaf_output(tree: TreeArrays, node: int):
    if tree.leaf_dist is not None:
        return int(tree.leaf_value[node])
    return float(tree.leaf_value[node])


def to_opscode(tree: TreeArrays, bins: List[BinInfo]) -> str:
    scripts: List[str] = []
    _op_codegen(tree, bins, 0, scripts, 0)
    scripts.append("call end")
    return "; ".join(scripts)


def to_json(tree: TreeArrays, bins: List[BinInfo]) -> str:
    """Portable node-graph export (serialization-format analog)."""

    def node_dict(i: int):
        f = int(tree.feature[i])
        if f < 0:
            d = {"leaf": _leaf_output(tree, i)}
            if tree.leaf_dist is not None:
                total = float(tree.leaf_dist[i].sum())
                if total > 0:
                    d["posteriori"] = (tree.leaf_dist[i] / total).tolist()
            return d
        return {
            "feature": f,
            "value": threshold_of(bins, f, int(tree.threshold_bin[i])),
            "nominal": bool(tree.nominal[i]),
            "left": node_dict(int(tree.left[i])),
            "right": node_dict(int(tree.right[i])),
        }

    return json.dumps(node_dict(0))


def to_javascript(tree: TreeArrays, bins: List[BinInfo]) -> str:
    """Nested if/else source (ref: DecisionTree jsCodegen export)."""

    def gen(i: int, indent: str) -> str:
        f = int(tree.feature[i])
        if f < 0:
            return f"{indent}{_leaf_output(tree, i)};"
        v = threshold_of(bins, f, int(tree.threshold_bin[i]))
        cmp = "==" if tree.nominal[i] else "<="
        return (f"{indent}if (x[{f}] {cmp} {v}) {{\n"
                + gen(int(tree.left[i]), indent + "  ")
                + f"\n{indent}}} else {{\n"
                + gen(int(tree.right[i]), indent + "  ")
                + f"\n{indent}}}")

    return gen(0, "")


def eval_json_tree(model: str, x) -> float:
    """Evaluate a to_json tree on raw features."""
    node = json.loads(model) if isinstance(model, str) else model
    while "leaf" not in node:
        f, v = node["feature"], node["value"]
        go_left = (x[f] == v) if node["nominal"] else (x[f] <= v)
        node = node["left"] if go_left else node["right"]
    return node["leaf"]
