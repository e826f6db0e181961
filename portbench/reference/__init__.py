"""The plain reference: a learner's closed form per rule
(`reference/<rule>.py`, one function `coefficients`) and training with it
row by row (`linear.py`).

Plain numpy only: nothing here imports the port, and nothing takes a
table, a plan or a scale that the port made.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


def rule(name: str) -> ModuleType:
    """`reference/<name>.py`, the closed form of the port's rule `name`."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reference for rule {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.reference.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class ScalarOps:
    """A closed form's operations on Python floats."""

    sqrt = staticmethod(math.sqrt)
    maximum = staticmethod(max)

    @staticmethod
    def where(cond, a, b):
        return a if cond else b

    @staticmethod
    def safe_div(num, den):
        return 0.0 if den == 0.0 else num / den

    @staticmethod
    def logical_and(a, b):
        return a and b
