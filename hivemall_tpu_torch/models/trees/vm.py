"""The port's copy of `hivemall_tpu/models/trees/vm.py`.

StackMachine — opcode-script evaluator, operation-compatible with the
reference VM (ref: smile/vm/StackMachine.java:30-280, smile/vm/Operation.java:37):
push / pop / goto / ifeq / ifeq2 / ifge / ifgt / ifle / iflt / call end.

Comparison ops pop (lower, upper) in that order and fall through when the
comparison holds (e.g. ifle: continue when upper <= lower, else jump)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class VMRuntimeError(RuntimeError):
    pass


# numeric op encoding shared with the native bulk evaluator
# (native/hivemall_native.cpp hm_forest_eval)
OP_PUSH_FEATURE = 0
OP_PUSH_CONST = 1
OP_POP = 2
OP_GOTO = 3
OP_IFEQ = 4
OP_IFGE = 5
OP_IFGT = 6
OP_IFLE = 7
OP_IFLT = 8
OP_CALL_END = 9

_IF_OPS = {"ifeq": OP_IFEQ, "ifeq2": OP_IFEQ, "ifge": OP_IFGE,
           "ifgt": OP_IFGT, "ifle": OP_IFLE, "iflt": OP_IFLT}


def compile_script_arrays(script):
    """Lower a StackMachine script to flat (ops int8, argi int32, argf float64)
    arrays for the native bulk evaluator. Same semantics as StackMachine.eval;
    'last' jump targets resolve to the final op, 'end' pushes -1.0."""
    import numpy as np

    lines = script.split(StackMachine.SEP) if isinstance(script, str) \
        else list(script)
    n = len(lines)
    ops = np.zeros(n, np.int8)
    argi = np.zeros(n, np.int32)
    argf = np.zeros(n, np.float64)

    def target(operand: str) -> int:
        if operand == "last":
            return n - 1
        return int(operand)

    for k, line in enumerate(lines):
        parts = line.split(" ")
        op = parts[0].lower()
        operand = parts[1] if len(parts) > 1 and parts[1] != "" else None
        if op == "push":
            if operand.startswith("x[") and operand.endswith("]"):
                ops[k] = OP_PUSH_FEATURE
                argi[k] = int(operand[2:-1])
            elif operand == "end":
                ops[k] = OP_PUSH_CONST
                argf[k] = -1.0
            else:
                ops[k] = OP_PUSH_CONST
                argf[k] = float(operand)
        elif op == "pop":
            ops[k] = OP_POP
        elif op == "goto":
            ops[k] = OP_GOTO
            argi[k] = target(operand)
        elif op in _IF_OPS:
            ops[k] = _IF_OPS[op]
            argi[k] = target(operand)
        elif op == "call":
            if operand != "end":
                raise VMRuntimeError(f"unknown function {operand}")
            ops[k] = OP_CALL_END
        else:
            raise VMRuntimeError(f"unknown op {op}")
    return ops, argi, argf


class StackMachine:
    SEP = "; "

    def __init__(self) -> None:
        self.code: List[tuple] = []
        self.result: Optional[float] = None

    def compile(self, script) -> None:
        ops = script.split(self.SEP) if isinstance(script, str) else list(script)
        self.code = []
        for line in ops:
            parts = line.split(" ")
            op = parts[0].lower()
            operand = parts[1] if len(parts) > 1 and parts[1] != "" else None
            self.code.append((op, operand))

    def run(self, script, features: Sequence[float]) -> Optional[float]:
        self.compile(script)
        return self.eval(features)

    def eval(self, features: Sequence[float]) -> Optional[float]:
        values: Dict[str, float] = {f"x[{i}]": float(v) for i, v in enumerate(features)}
        values["end"] = -1.0
        jump = {"last": len(self.code) - 1}
        stack: List[float] = []
        done = [False] * len(self.code)
        self.result = None
        ip = 0

        def target(operand: str) -> int:
            try:
                return int(operand)
            except (TypeError, ValueError):
                return jump[operand]

        while ip < len(self.code):
            if done[ip]:
                raise VMRuntimeError("There is an infinite loop in the machine code.")
            done[ip] = True
            op, operand = self.code[ip]
            if op == "push":
                if operand in values:
                    stack.append(values[operand])
                else:
                    stack.append(float(operand))
                ip += 1
            elif op == "pop":
                self.result = stack.pop()
                ip += 1
            elif op == "goto":
                ip = target(operand)
            elif op in ("ifeq", "ifeq2"):
                a = stack.pop()
                b = stack.pop()
                ip = ip + 1 if a == b else target(operand)
            elif op in ("ifge", "ifgt", "ifle", "iflt"):
                lower = stack.pop()
                upper = stack.pop()
                ok = {"ifge": upper >= lower, "ifgt": upper > lower,
                      "ifle": upper <= lower, "iflt": upper < lower}[op]
                ip = ip + 1 if ok else target(operand)
            elif op == "call":
                if operand == "end":
                    self.result = stack.pop()
                    return self.result
                raise VMRuntimeError(f"unknown function {operand}")
            else:
                raise VMRuntimeError(f"unknown op {op}")
        return self.result
