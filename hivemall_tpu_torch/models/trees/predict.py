"""The port's copy of `hivemall_tpu/models/trees/predict.py`:
`tree_predict` + `guess_attrs` (ref: smile/tools/TreePredictUDF.java:143-326,
smile/tools/GuessAttributesUDF.java)."""

from __future__ import annotations

import json
from typing import List, Sequence, Union

import numpy as np

import re

from .export import eval_json_tree
from .vm import StackMachine

_JS_TOKEN = re.compile(
    r"\s*(if|else|x\[(\d+)\]|<=|==|[(){};]|-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)")


def compile_js_tree(source: str):
    """Compile the javascript tree export (to_javascript's nested
    `if (x[F] <=|== V) { ... } else { ... }` with numeric-literal leaf
    statements) into a features -> float evaluator — the reference's third
    evaluator, which feeds the same source to Rhino
    (ref: smile/tools/TreePredictUDF.java:326). The emitted grammar is a
    closed expression subset, so a recursive-descent parser replaces the JS
    engine off-JVM; anything outside the grammar is a loud ValueError."""
    tokens: List = []
    pos = 0
    while pos < len(source):
        m = _JS_TOKEN.match(source, pos)
        if not m:
            if source[pos:].strip() == "":
                break
            raise ValueError(
                f"javascript tree: unexpected input at {pos}: {source[pos:pos+20]!r}")
        tokens.append(m.group(1) if m.group(2) is None else ("x", int(m.group(2))))
        pos = m.end()

    idx = [0]

    def peek():
        return tokens[idx[0]] if idx[0] < len(tokens) else None

    def eat(want=None):
        t = peek()
        if t is None or (want is not None and t != want):
            raise ValueError(f"javascript tree: expected {want!r}, got {t!r}")
        idx[0] += 1
        return t

    def eat_number():
        t = eat()
        try:
            return float(t)
        except (TypeError, ValueError):
            raise ValueError(f"javascript tree: expected a number, got {t!r}")

    def parse_stmt():
        t = peek()
        if t == "if":
            eat("if")
            eat("(")
            feat = eat()
            if not (isinstance(feat, tuple) and feat[0] == "x"):
                raise ValueError(f"javascript tree: expected x[i], got {feat!r}")
            op = eat()
            if op not in ("<=", "=="):
                raise ValueError(f"javascript tree: bad comparator {op!r}")
            thresh = eat_number()
            eat(")")
            eat("{")
            left = parse_stmt()
            eat("}")
            eat("else")
            eat("{")
            right = parse_stmt()
            eat("}")
            f = feat[1]
            if op == "<=":
                return lambda x: left(x) if x[f] <= thresh else right(x)
            return lambda x: left(x) if x[f] == thresh else right(x)
        # leaf: numeric literal followed by ';'
        val = eat_number()
        eat(";")
        return lambda x: val

    fn = parse_stmt()
    if peek() is not None:
        raise ValueError(f"javascript tree: trailing tokens {tokens[idx[0]:][:5]}")
    return fn


def compile_tree(model_type: str, model: str):
    """Parse/compile one exported tree program ONCE; returns a
    features -> float evaluator. The single model-type dispatch table —
    tree_predict and the merged-row ensemble both go through it."""
    mt = model_type.lower()
    if mt in ("opscode", "vm"):
        sm = StackMachine()
        sm.compile(model)

        def run_vm(features):
            result = sm.eval(features)
            if result is None:
                raise ValueError("opscode evaluation returned no result")
            return result

        return run_vm
    if mt in ("json", "serialization", "ser"):
        node = json.loads(model) if isinstance(model, str) else model
        return lambda features: eval_json_tree(node, list(features))
    if mt in ("javascript", "js"):
        return compile_js_tree(model)
    raise ValueError(f"unsupported model type: {model_type}")


def tree_predict(model_type: str, model: str, features: Sequence[float],
                 classification: bool = False) -> Union[int, float]:
    """Evaluate an exported tree on one raw feature vector. Evaluators:
    opscode -> StackMachine (ref: TreePredictUDF.java:257), json -> node-graph
    walk (the serialization-evaluator analog, :205), javascript -> the
    expression-subset compiler compile_js_tree (the Rhino-evaluator analog,
    :326). `classification` defaults false like the reference
    (TreePredictUDF.java:104), so regression forests scored via the 3-arg
    form keep float leaf values instead of silently int-truncating."""
    out = compile_tree(model_type, model)(features)
    return int(out) if classification else float(out)


def guess_attrs(row: Sequence) -> str:
    """Guess Q/C attribute types from a sample row — strings/bools are
    categorical, numbers quantitative (ref: GuessAttributesUDF.java)."""
    attrs: List[str] = []
    for v in row:
        if isinstance(v, bool) or isinstance(v, str):
            attrs.append("C")
        elif isinstance(v, (int, np.integer)):
            # integers could be either; the reference guesses from the Hive
            # column type — int columns are quantitative
            attrs.append("Q")
        else:
            attrs.append("Q")
    return ",".join(attrs)
