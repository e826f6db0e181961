"""Dtype & weak-type flow: the abstract interpreter behind G017-G021.

The port keeps its weight tables f32 (bf16 above 2^24 dims, models/base.py)
and serves int8 / bf16 quantized artifacts; a stray ``.float()``, a float64
numpy value handed to ``torch.as_tensor`` or a bf16 scatter-add undoes that
silently. This module makes precision discipline provable at lint time: a
dtype lattice propagated through ``torch.*`` and ``np.*`` constructors,
casts, torch's and NumPy's promotion rules, scatter-accumulate calls, and
depth-bounded call-return summaries over the whole-program model
(analysis/program.py) — stdlib-only like every other graftcheck layer.

Abstract values (``DT``):

- concrete dtypes: ``bool_``, ``int8..int64``/``uint8..uint64``,
  ``bfloat16``, ``float16``, ``float32``, ``float64``, each with the
  library that holds it (``lib``: ``"torch"`` a tensor, ``"np"`` a numpy
  array or scalar, ``""`` not known) and whether it is a numpy scalar or
  a 0-dim tensor (``scalar``: True, False, or None where an index may or
  may not have dropped the last dimension; a numpy array is never a
  scalar, 0-d or not);
- **weak** Python scalars (``weak=True``), as in the reference;
- ``None`` = unknown (parameters, unresolvable calls). Everything built on
  this model flags only what it can prove; unknown is trusted.

Where the port departs from the reference's model (JAX and NumPy):

- **Dtype names** are ``torch.*`` and ``np.*`` attributes and numpy's
  string names; under ``torch``, ``float`` is float32, ``int`` int32,
  ``long`` int64, ``half`` float16, ``double`` float64. No ``jnp`` and no
  ``ml_dtypes``.
- **Promotion** follows the library of the operation (``promote``): a
  ``torch.*`` call, a tensor method, or an operator with a tensor operand
  uses torch's table — the float category wins whatever its width
  (``int32 + float16`` stays float16, NumPy gives float64), ``bfloat16 +
  float16`` gives float32, and operands rank in three groups: dimensioned
  tensors, 0-dim tensors, and wrapped numbers
  (Python and numpy scalars). A lower group changes the result only when
  its category is higher: a Python float or a numpy float64 against an
  f16 tensor stays f16 and against an int tensor gives the default float
  (float32), a 0-dim float64 tensor against an f32 tensor stays f32 and
  against an int32 tensor gives float64. A ``np.*`` call, or an operator
  on numpy values and Python scalars, uses NumPy's (NEP 50: Python
  scalars weak, numpy scalars strong, a Python float against an int array
  gives float64). An operator on a tensor and a numpy *array* (0-d
  included) is numpy's: torch hands it over, numpy promotes both as
  strong arrays, and the result comes back as a tensor (a bf16 tensor
  raises). An operator whose operands' library is unknown takes the
  provable intersection of the two, as the reference does for NumPy and
  JAX. True division of integers gives torch's default float (float32)
  and NumPy's float64.
- **Constructors**: ``torch.zeros/ones/empty/rand/randn/linspace`` and a
  float-valued ``torch.full/arange/tensor`` give the default dtype,
  float32; an int-valued one gives int64; ``new_*`` / ``*_like`` follow
  their receiver / argument. ``torch.as_tensor`` / ``from_numpy`` /
  ``tensor`` / ``asarray`` of a numpy value keep its dtype — the channel by
  which a numpy float64 reaches the card (G018).
- **Casts** (G019's sites): ``.to(dtype)``, ``.to(device, dtype)``,
  ``.to(dtype=)``, ``.to(other)``, ``.type(torch.X)``, ``.float()`` /
  ``.half()`` / ``.bfloat16()`` / ``.double()`` / ``.int()`` / ``.long()``
  and the rest of torch's named casts, and numpy's ``astype``.
  ``.to(device)`` keeps the dtype and is no cast.
- **Reductions** (G021): ``sum`` / ``nansum`` / ``mean`` / ``nanmean`` /
  ``cumsum`` / ``prod`` / ``cumprod`` / ``torch.segment_reduce``. Integer
  and bool sums and products widen to int64 (NumPy: uint64 for unsigned).
  torch's kernels for some of them keep a 16-bit float's running sum in
  float32 and round once at the result write; on an H100 those are
  ``TORCH_WIDE_ACCUMULATORS`` (measured by scripts/torch_accum_probe.py),
  and such a site counts as widened. The CPU's kernels differ (prod,
  segment_reduce and index_put_ accumulate 16-bit there; scatter_add_ and
  scatter_reduce_ do not): the rules follow the card, where the port runs.
- **Scatter-accumulate**: ``index_add_`` / ``index_add``,
  ``scatter_add_`` / ``scatter_add``, ``index_put_(..., accumulate=True)``
  and ``scatter_reduce_(..., "sum")`` replace ``.at[...].add``. A
  ``scatter_reduce`` with ``"amax"`` / ``"amin"`` accumulates nothing.

Per function, ``DtypeFlow.facts`` runs a flow-sensitive statement walk
(loop bodies twice, If branches joined) and records the event classes the
rules consume: promotions (G017), casts (G019), reductions and scatter
updates (G021), and host-to-tensor conversions without a dtype (G018).
"""

from __future__ import annotations

import ast
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from .modmodel import _FN_TYPES, ModuleModel, dotted_name, enclosing_loop
from .program import ProgramModel

MAX_SUMMARY_DEPTH = 4


class DT(NamedTuple):
    """One abstract dtype: lattice point, weak (Python-scalar) flag, and
    the library and rank class of the value that holds it."""

    name: str       # "float32", "bfloat16", "int8", ... (numpy dtype name)
    category: str   # "b" bool, "i" int, "u" uint, "f" float
    bits: int
    weak: bool = False
    lib: str = ""                    # "torch", "np", "" unknown
    scalar: Optional[bool] = False   # numpy scalar / 0-dim tensor

    @property
    def reduced_float(self) -> bool:
        return self.category == "f" and self.bits < 32 and not self.weak

    @property
    def wide_float(self) -> bool:
        return self.category == "f" and self.bits >= 32 and not self.weak


_CONCRETE: Dict[str, DT] = {}
for _name, _cat, _bits in (
    ("bool_", "b", 8), ("int8", "i", 8), ("int16", "i", 16),
    ("int32", "i", 32), ("int64", "i", 64), ("uint8", "u", 8),
    ("uint16", "u", 16), ("uint32", "u", 32), ("uint64", "u", 64),
    ("bfloat16", "f", 16), ("float16", "f", 16), ("float32", "f", 32),
    ("float64", "f", 64),
):
    _CONCRETE[_name] = DT(_name, _cat, _bits)

WEAK_FLOAT = DT("float64", "f", 64, weak=True)   # a bare Python float
WEAK_INT = DT("int64", "i", 64, weak=True)       # a bare Python int

# the dtypes torch promotes among (its uint16..uint64 have no promotion)
TORCH_DTYPES = ("bool_", "int8", "int16", "int32", "int64", "uint8",
                "bfloat16", "float16", "float32", "float64")
# torch.get_default_dtype() and the dtype of a Python int in torch
_TORCH_DEFAULT_FLOAT = _CONCRETE["float32"]
_TORCH_DEFAULT_INT = _CONCRETE["int64"]

# spelling aliases of numpy's names and strings: np.double, dtype="half"
_ALIASES = {
    "double": "float64", "float_": "float64", "single": "float32",
    "half": "float16", "bool": "bool_", "int": "int64", "float": "float64",
    "intc": "int32", "byte": "int8", "ubyte": "uint8",
}
# torch's own aliases: torch.float is float32 and torch.int int32
_TORCH_ALIASES = {
    "float": "float32", "double": "float64", "half": "float16",
    "long": "int64", "int": "int32", "short": "int16", "bool": "bool_",
}
_NP_ROOTS = ("np", "numpy")
_TORCH_ROOTS = ("torch",)
_DTYPE_ROOTS = _NP_ROOTS + _TORCH_ROOTS
_TORCH_MODULES = _TORCH_ROOTS + ("torch.nn.functional", "F")
_MODULE_ROOTS = _NP_ROOTS + _TORCH_MODULES

# array/tensor methods whose result keeps the receiver's dtype
_PRESERVING_METHODS = (
    "copy", "reshape", "ravel", "flatten", "transpose", "squeeze", "clip",
    "round", "conj", "take", "repeat", "swapaxes", "clone", "contiguous",
    "view", "permute", "unsqueeze", "expand", "expand_as", "narrow",
    "index_select", "gather", "masked_fill", "clamp", "clamp_", "detach",
    "cpu", "cuda", "pin_memory", "flip", "roll", "neg", "abs", "t",
    "fill_", "zero_", "copy_", "share_memory_", "requires_grad_",
)
# elementwise np/torch calls whose result keeps the (promoted) operand dtype
_ELEMENTWISE_CALLS = (
    "exp", "log", "log1p", "expm1", "sqrt", "abs", "absolute", "tanh",
    "sign", "negative", "square", "maximum", "minimum", "add", "subtract",
    "multiply", "divide", "power", "where", "concatenate", "stack", "tile",
    "pad", "roll", "flip", "dot", "matmul", "mul", "sub", "div",
    "pow", "cat", "concat", "clamp", "neg", "sigmoid", "rsqrt", "mm", "bmm",
    "true_divide",
)
# binary calls checked for silent promotion alongside BinOp (G017); on a
# tensor receiver (``a.mul(b)``) too
_BINARY_PROMOTING_CALLS = (
    "maximum", "minimum", "add", "subtract", "multiply", "divide", "power",
    "dot", "matmul", "mul", "sub", "div", "pow", "mm", "bmm",
)
_TRUE_DIVIDE_CALLS = ("divide", "div", "true_divide")
# torch's products take one dtype and raise on two: no silent promotion
_SAME_DTYPE_CALLS = ("dot", "matmul", "mm", "bmm")
# accumulating reductions whose accumulator defaults to the operand dtype
# (the G021 class); matmul/dot are excluded — the tensor cores accumulate
# f32 whatever the stored dtype
REDUCTION_TAILS = ("sum", "nansum", "mean", "nanmean", "cumsum", "prod",
                   "cumprod", "segment_reduce")
_INT_WIDENING_REDUCTIONS = ("sum", "nansum", "cumsum", "prod", "cumprod")
_FULL_REDUCTIONS = ("sum", "nansum", "mean", "nanmean", "prod")
# torch calls whose kernel on an H100 keeps a bf16/f16 running sum in
# float32 and rounds once at the result write (scripts/torch_accum_probe.py:
# at most one unit in the last place from the float64 sum of 16384 inputs).
# cumprod, index_add_, scatter_add_ and scatter_reduce_ accumulate in the
# operand's own dtype there and stay G021 sites.
TORCH_WIDE_ACCUMULATORS = frozenset({
    "sum", "nansum", "mean", "cumsum", "prod", "segment_reduce",
    "index_put_",
})
# torch's named casts: x.float() ...
_NAMED_CASTS = {
    "float": "float32", "double": "float64", "half": "float16",
    "bfloat16": "bfloat16", "int": "int32", "long": "int64",
    "short": "int16", "char": "int8", "byte": "uint8", "bool": "bool_",
}
# torch calls that turn host data into a tensor (G018's and G020's channel)
TENSOR_FROM_HOST = ("as_tensor", "from_numpy", "tensor", "asarray")
# scatter-accumulate calls, in place and not (index_put only accumulates
# with ``accumulate=True``, scatter_reduce only with "sum" / "mean")
_SCATTER_CALLS = ("index_add_", "index_add", "scatter_add_", "scatter_add",
                  "index_put_", "index_put", "scatter_reduce_",
                  "scatter_reduce")
_ACCUMULATING_REDUCE = ("sum", "mean")


# -- promotion ----------------------------------------------------------------

def join(a: Optional[DT], b: Optional[DT]) -> Optional[DT]:
    """Lattice join for control-flow merges: equal or unknown (a library
    or rank class the two branches disagree on is forgotten)."""
    if a is None or b is None:
        return None
    if a == b:
        return a
    if (a.name, a.weak) != (b.name, b.weak):
        return None
    return a._replace(lib=a.lib if a.lib == b.lib else "",
                      scalar=a.scalar if a.scalar == b.scalar else None)


def _larger(a: DT, b: DT) -> DT:
    return a if a.bits >= b.bits else b


def _np_types(a: DT, b: DT) -> Optional[DT]:
    """``np.promote_types`` on two concrete dtypes (bfloat16 as ml_dtypes
    promotes it among floats)."""
    if a.name == b.name:
        return _CONCRETE[a.name]
    if a.category == "b" or b.category == "b":
        return _CONCRETE[(b if a.category == "b" else a).name]
    if a.category == "f" and b.category == "f":
        if {a.name, b.name} == {"bfloat16", "float16"}:
            return _CONCRETE["float32"]
        return _CONCRETE[_larger(a, b).name]
    if "f" in (a.category, b.category):
        fl, it = (a, b) if a.category == "f" else (b, a)
        if fl.name == "bfloat16":
            return None
        need = {8: 16, 16: 32}.get(it.bits, 64)  # the float that holds it
        return _CONCRETE[fl.name] if fl.bits >= need \
            else _CONCRETE[f"float{need}"]
    if a.category == b.category:
        return _CONCRETE[_larger(a, b).name]
    s, u = (a, b) if a.category == "i" else (b, a)
    if s.bits > u.bits:
        return _CONCRETE[s.name]
    return _CONCRETE[f"int{2 * u.bits}"] if u.bits < 64 \
        else _CONCRETE["float64"]


def _torch_types(a: DT, b: DT) -> Optional[DT]:
    """``torch.promote_types``: the higher category wins whatever its
    width; bf16 with f16 is f32; uint8 with int8 is int16."""
    if a.name not in TORCH_DTYPES or b.name not in TORCH_DTYPES:
        return None
    if a.name == b.name:
        return _CONCRETE[a.name]
    order = {"b": 0, "u": 1, "i": 1, "f": 2}
    if order[a.category] != order[b.category]:
        return _CONCRETE[(a if order[a.category] > order[b.category]
                          else b).name]
    if a.category == "f":
        if {a.name, b.name} == {"bfloat16", "float16"}:
            return _CONCRETE["float32"]
        return _CONCRETE[_larger(a, b).name]
    if a.category == b.category:
        return _CONCRETE[_larger(a, b).name]
    s = a if a.category == "i" else b
    return _CONCRETE[s.name] if s.bits > 8 else _CONCRETE["int16"]


def _python(a: DT, b: DT) -> DT:
    """Two Python scalars: float wins."""
    return a if a.category == "f" or b.category != "f" else b


def _torch_group(d: DT) -> int:
    """0 a dimensioned tensor or array, 1 a 0-dim tensor, 2 a wrapped
    number (Python or numpy scalar)."""
    if d.weak or (d.scalar and d.lib == "np"):
        return 2
    return 1 if d.scalar else 0


def _torch_promote(a: DT, b: DT) -> Optional[DT]:
    """torch's result type of one operation on ``a`` and ``b``."""
    if a.scalar is None or b.scalar is None:
        outs = {_torch_promote(x, y)
                for x in _ranks(a) for y in _ranks(b)}
        names = {(o.name, o.weak) if o else None for o in outs}
        if len(names) != 1 or None in names:
            return None
        out = next(iter(outs))
        return out._replace(scalar=out.scalar if len(outs) == 1 else None)
    ga, gb = _torch_group(a), _torch_group(b)
    if ga == gb == 2:
        return _np_promote(a, b)  # no tensor: Python's / numpy's own op
    da, db = (_wrapped(d) if g == 2 else d for d, g in ((a, ga), (b, gb)))
    if ga == gb:
        out = _torch_types(da, db)
    else:
        hi, lo = (da, db) if ga < gb else (db, da)
        if hi.category == "f":
            out = _CONCRETE[hi.name]
        elif hi.category == "b" or lo.category == "f":
            out = _torch_types(hi, lo)
        else:
            out = _CONCRETE[hi.name]
    if out is None:
        return None
    return out._replace(lib="torch", scalar=min(ga, gb) == 1)


def _ranks(d: DT):
    return (d._replace(scalar=False), d._replace(scalar=True)) \
        if d.scalar is None else (d,)


def _wrapped(d: DT) -> DT:
    """A wrapped number as torch's result-type state counts it: floats as
    the default dtype, ints as int64."""
    if d.category == "f":
        return _TORCH_DEFAULT_FLOAT
    return _TORCH_DEFAULT_INT if d.category in ("i", "u") \
        else _CONCRETE["bool_"]


def _np_promote(a: DT, b: DT) -> Optional[DT]:
    """NumPy's result type (NEP 50): Python scalars weak, numpy scalars
    and arrays strong."""
    if a.weak and b.weak:
        return _python(a, b)
    if a.weak or b.weak:
        weak, conc = (a, b) if a.weak else (b, a)
        if weak.category == "f" and conc.category in ("i", "u", "b"):
            out = _CONCRETE["float64"]
        elif weak.category == "i" and conc.category == "b":
            out = _CONCRETE["int64"]
        else:
            out = _CONCRETE[conc.name]
        return out._replace(lib="np", scalar=conc.scalar)
    out = _np_types(a, b)
    if out is None:
        return None
    both = a.scalar and b.scalar if None not in (a.scalar, b.scalar) \
        else None
    return out._replace(lib="np", scalar=both)


def _mixed(a: DT, b: DT) -> Optional[DT]:
    """A tensor and a numpy array in one operator (``t * arr``): torch
    hands the operation to numpy, which computes it on the tensor's array
    — a 0-dim tensor as a strong 0-d array — and the result comes back as
    a tensor. A bf16 tensor has no array and raises."""
    if "bfloat16" in (a.name, b.name):
        return None
    out = _np_types(a, b)
    return out._replace(lib="torch") if out is not None else None


def _op_lib(a: DT, b: DT) -> Optional[str]:
    """The table an operator on ``a`` and ``b`` follows: torch's where a
    tensor takes part — but "mixed" for a tensor and a numpy array, and
    unknown where the numpy value's rank is — NumPy's where only numpy
    values and Python scalars do, else unknown."""
    libs = {a.lib, b.lib}
    if libs == {"torch", "np"}:
        arr = a if a.lib == "np" else b
        return "torch" if arr.scalar else \
            "mixed" if arr.scalar is False else None
    if "torch" in libs:
        return "torch"
    if all(d.lib == "np" or d.weak for d in (a, b)) and "np" in libs:
        return "np"
    if a.weak and b.weak:
        return "np"
    return None


def promote(a: Optional[DT], b: Optional[DT],
            lib: Optional[str] = None) -> Optional[DT]:
    """Result dtype of mixing two abstract values under ``lib``'s table
    ("torch" or "np"); with no ``lib``, the operands' library decides,
    and where that is unknown, the result only where torch and NumPy
    agree. None where an input is unknown."""
    if a is None or b is None:
        return None
    lib = lib or _op_lib(a, b)
    if lib == "torch":
        return _torch_promote(a, b)
    if lib == "np":
        return _np_promote(a, b)
    if lib == "mixed":
        return _mixed(a, b)
    t, n = _torch_promote(a, b), _np_promote(a, b)
    if t is None or n is None or (t.name, t.weak) != (n.name, n.weak):
        return None
    return t._replace(lib="", scalar=t.scalar if t.scalar == n.scalar
                      else None)


def true_divide(a: Optional[DT], b: Optional[DT],
                lib: Optional[str] = None) -> Optional[DT]:
    """``a / b``: the promoted dtype, with integers going to torch's
    default float (float32) or NumPy's float64."""
    if a is None or b is None:
        return None
    lib = lib or _op_lib(a, b)
    if lib is None:
        t, n = true_divide(a, b, "torch"), true_divide(a, b, "np")
        if t is None or n is None or (t.name, t.weak) != (n.name, n.weak):
            return None
        return t._replace(lib="")
    out = promote(a, b, lib)
    if out is None or out.category == "f":
        return out
    if out.weak:
        return WEAK_FLOAT
    wide = _TORCH_DEFAULT_FLOAT if lib == "torch" else _CONCRETE["float64"]
    return wide._replace(lib=out.lib, scalar=out.scalar)


def product(a: Optional[DT], b: Optional[DT],
            lib: Optional[str] = None) -> Optional[DT]:
    """``a @ b`` / ``dot`` / ``mm``: torch raises on two dtypes, so only
    equal dtypes — or NumPy's table — give a result."""
    lib = lib or (_op_lib(a, b) if a is not None and b is not None
                  else None)
    if lib != "np" and (a is None or b is None or a.name != b.name):
        return None
    return promote(a, b, lib)


def parse_dtype_name(name: str, torch_names: bool = False) -> Optional[DT]:
    """A dtype spelled as a numpy name / string, or (``torch_names``) as a
    ``torch`` attribute, where ``float`` means float32."""
    aliases = _TORCH_ALIASES if torch_names else _ALIASES
    return _CONCRETE.get(aliases.get(name, name))


def _on(dt: Optional[DT], lib: str, scalar: Optional[bool] = False
        ) -> Optional[DT]:
    """``dt`` held by ``lib`` as an array/tensor (or a scalar)."""
    if dt is None:
        return None
    return dt._replace(weak=False, lib=lib, scalar=scalar)


# -- events -----------------------------------------------------------------

class CastSite(NamedTuple):
    node: ast.Call
    receiver_dt: Optional[DT]
    target_dt: Optional[DT]
    loop: Optional[ast.AST]          # enclosing For/While, if any
    loop_invariant: bool             # receiver not rebound inside that loop


class PromotionSite(NamedTuple):
    node: ast.AST
    left_dt: DT
    right_dt: DT
    out_dt: DT


class ReductionSite(NamedTuple):
    node: ast.Call
    tail: str
    operand_dt: Optional[DT]
    widened: bool                    # the accumulator is wider: an explicit
    # dtype=, or a torch kernel in TORCH_WIDE_ACCUMULATORS


class ScatterSite(NamedTuple):
    node: ast.Call
    method: str                      # index_add_ / scatter_add_ / ...
    table_dt: Optional[DT]
    widened: bool                    # in TORCH_WIDE_ACCUMULATORS


class HostSource(NamedTuple):
    """A ``torch.as_tensor`` / ``from_numpy`` / ``tensor`` / ``asarray``
    call with no dtype and no cast after it (G018)."""
    node: ast.Call
    source_dt: Optional[DT]


class FnFacts:
    """Everything the dtype rules need to know about one function."""

    __slots__ = ("promotions", "casts", "reductions", "scatters",
                 "host_sources", "return_dt", "_returned")

    def __init__(self):
        self.promotions: List[PromotionSite] = []
        self.casts: List[CastSite] = []
        self.reductions: List[ReductionSite] = []
        self.scatters: List[ScatterSite] = []
        self.host_sources: List[HostSource] = []
        self.return_dt: Optional[DT] = None
        self._returned = False


def _kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _arg(call: ast.Call, args: List[ast.expr], pos: int, name: str
         ) -> Optional[ast.expr]:
    """Argument ``name`` of ``call``, by keyword or at ``pos`` of
    ``args`` (the call's positionals with any table argument dropped)."""
    node = _kwarg(call, name)
    if node is None and len(args) > pos:
        node = args[pos]
    return node


def _str_value(node: Optional[ast.expr]) -> Optional[str]:
    return node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else None


def _spread(call: ast.Call) -> bool:
    """``*args`` / ``**kwargs`` may carry the dtype: trusted."""
    return any(isinstance(a, ast.Starred) for a in call.args) \
        or any(kw.arg is None for kw in call.keywords)


def _is_device_expr(expr: ast.expr) -> bool:
    """A ``.to()`` argument that names a device: a string, a
    ``torch.device(...)`` call, or a name that says it is one."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str)
    if isinstance(expr, ast.Call):
        return (dotted_name(expr.func) or "").endswith("device")
    name = dotted_name(expr) or ""
    return "dev" in name.rsplit(".", 1)[-1].lower()


def cast_after(call: ast.Call) -> bool:
    """True when the value of ``call`` goes straight into a cast that names
    a dtype: ``torch.from_numpy(z[k]).to(torch.float32)``, ``.float()``."""
    parent = getattr(call, "graftcheck_parent", None)
    if not isinstance(parent, ast.Attribute):
        return False
    outer = getattr(parent, "graftcheck_parent", None)
    if not isinstance(outer, ast.Call) or outer.func is not parent:
        return False
    if parent.attr in _NAMED_CASTS or parent.attr == "astype":
        return True
    if parent.attr == "type":
        return bool(outer.args)
    if parent.attr == "to":
        return _kwarg(outer, "dtype") is not None or any(
            not _is_device_expr(a) for a in outer.args)
    return False


class DtypeFlow:
    def __init__(self, program: ProgramModel):
        self.program = program
        self._facts: Dict[Tuple[str, int], FnFacts] = {}
        self._returns: Dict[Tuple[str, int, tuple], Optional[DT]] = {}

    # -- public ------------------------------------------------------------

    def facts(self, path: str, fn: ast.AST) -> FnFacts:
        key = (path, id(fn))
        cached = self._facts.get(key)
        if cached is None:
            cached = self._analyze(path, fn, {}, collect=True,
                                   depth=0, stack=set())
            self._facts[key] = cached
        return cached

    # -- dtype-expression parsing ------------------------------------------

    def dtype_of_dtype_expr(self, path: str, expr: ast.expr,
                            env: Dict[str, Optional[DT]]) -> Optional[DT]:
        """A dtype-position expression (astype / .to arg, dtype= kwarg)."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return parse_dtype_name(expr.value)
        name = dotted_name(expr)
        if name is not None:
            root, _, tail = name.rpartition(".")
            if root in _DTYPE_ROOTS:
                return parse_dtype_name(tail, root in _TORCH_ROOTS)
            if root == "" and name in env:
                return env[name]  # dt = torch.bfloat16; x.to(dt)
            if root == "" and name == "float":
                return _CONCRETE["float64"]  # astype(float) IS f64
            if tail == "dtype" and isinstance(expr, ast.Attribute):
                # .to(y.dtype): follow y
                return self._eval(path, expr.value, env, None, 0, set())
        if isinstance(expr, ast.Call):
            # np.dtype("bfloat16") / np.dtype(np.float32)
            callee = dotted_name(expr.func) or ""
            if callee.rsplit(".", 1)[-1] == "dtype" and expr.args:
                return self.dtype_of_dtype_expr(path, expr.args[0], env)
        return None

    # -- call-return summaries ---------------------------------------------

    def _return_dtype(self, path: str, fn: ast.AST,
                      arg_dts: Dict[str, Optional[DT]], depth: int,
                      stack: Set[Tuple[str, int]]) -> Optional[DT]:
        key = (path, id(fn),
               tuple(sorted((k, v) for k, v in arg_dts.items()
                            if v is not None)))
        if key in self._returns:
            return self._returns[key]
        if (path, id(fn)) in stack or depth > MAX_SUMMARY_DEPTH:
            return None
        stack = stack | {(path, id(fn))}
        facts = self._analyze(path, fn, arg_dts, collect=False,
                              depth=depth, stack=stack)
        self._returns[key] = facts.return_dt
        return facts.return_dt

    # -- the statement walk -------------------------------------------------

    def _analyze(self, path: str, fn: ast.AST,
                 param_dts: Dict[str, Optional[DT]], collect: bool,
                 depth: int, stack: Set[Tuple[str, int]]) -> FnFacts:
        facts = FnFacts()
        env: Dict[str, Optional[DT]] = {}
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            env[p.arg] = param_dts.get(p.arg)
        sink = facts if collect else None
        self._walk_stmts(path, fn.body, env, sink, facts, depth, stack)
        return facts

    def _walk_stmts(self, path, stmts, env, sink, facts, depth, stack):
        for stmt in stmts:
            if isinstance(stmt, _FN_TYPES + (ast.ClassDef,)):
                continue  # nested scopes get their own facts
            if isinstance(stmt, ast.Assign):
                dt = self._eval(path, stmt.value, env, sink, depth, stack)
                for tgt in stmt.targets:
                    self._bind(tgt, dt, env)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                dt = self._eval(path, stmt.value, env, sink, depth, stack)
                self._bind(stmt.target, dt, env)
            elif isinstance(stmt, ast.AugAssign):
                cur = self._eval(path, stmt.target, env, sink, depth, stack)
                val = self._eval(path, stmt.value, env, sink, depth, stack)
                if cur is not None and cur.lib and not cur.scalar:
                    dt = cur  # in place: a tensor / array keeps its dtype
                elif isinstance(stmt.op, ast.Div):
                    dt = true_divide(cur, val)
                else:
                    dt = promote(cur, val)
                self._bind(stmt.target, dt, env)
            elif isinstance(stmt, ast.Return):
                dt = self._eval(path, stmt.value, env, sink, depth, stack) \
                    if stmt.value is not None else None
                facts.return_dt = dt if not facts._returned \
                    else join(facts.return_dt, dt)
                facts._returned = True
            elif isinstance(stmt, ast.For):
                it = self._eval(path, stmt.iter, env, sink, depth, stack)
                # iterating keeps the dtype (rows of a 1-D tensor are 0-dim)
                self._bind(stmt.target, it._replace(scalar=None)
                           if it is not None and not it.weak else it, env)
                for _ in range(2):  # loop-carried dtypes converge
                    self._walk_stmts(path, stmt.body, env, sink, facts,
                                     depth, stack)
                self._walk_stmts(path, stmt.orelse, env, sink, facts,
                                 depth, stack)
            elif isinstance(stmt, ast.While):
                self._eval(path, stmt.test, env, sink, depth, stack)
                for _ in range(2):
                    self._walk_stmts(path, stmt.body, env, sink, facts,
                                     depth, stack)
                self._walk_stmts(path, stmt.orelse, env, sink, facts,
                                 depth, stack)
            elif isinstance(stmt, ast.If):
                self._eval(path, stmt.test, env, sink, depth, stack)
                e1, e2 = dict(env), dict(env)
                self._walk_stmts(path, stmt.body, e1, sink, facts, depth,
                                 stack)
                self._walk_stmts(path, stmt.orelse, e2, sink, facts, depth,
                                 stack)
                for k in set(e1) | set(e2):  # branch join
                    env[k] = join(e1.get(k), e2.get(k)) \
                        if k in e1 and k in e2 else None
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    dt = self._eval(path, item.context_expr, env, sink,
                                    depth, stack)
                    if item.optional_vars is not None:
                        self._bind(item.optional_vars, dt, env)
                self._walk_stmts(path, stmt.body, env, sink, facts, depth,
                                 stack)
            elif isinstance(stmt, ast.Try):
                for block in (stmt.body, stmt.orelse, stmt.finalbody):
                    self._walk_stmts(path, block, env, sink, facts, depth,
                                     stack)
                for h in stmt.handlers:
                    self._walk_stmts(path, h.body, env, sink, facts, depth,
                                     stack)
            elif isinstance(stmt, ast.Expr):
                self._eval(path, stmt.value, env, sink, depth, stack)

    def _bind(self, tgt: ast.expr, dt: Optional[DT], env) -> None:
        name = dotted_name(tgt)
        if name is not None:
            env[name] = dt
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._bind(elt, None, env)

    # -- expression evaluation ----------------------------------------------

    def _eval(self, path: str, expr: ast.expr, env, sink: Optional[FnFacts],
              depth: int, stack) -> Optional[DT]:
        if isinstance(expr, ast.Constant):
            v = expr.value
            if isinstance(v, bool):
                return _CONCRETE["bool_"]
            if isinstance(v, float):
                return WEAK_FLOAT
            if isinstance(v, int):
                return WEAK_INT
            return None
        if isinstance(expr, ast.Name):
            return env.get(expr.id)
        if isinstance(expr, ast.Attribute):
            name = dotted_name(expr)
            if name is not None:
                root, _, tail = name.rpartition(".")
                if root in _DTYPE_ROOTS:
                    return parse_dtype_name(tail, root in _TORCH_ROOTS)
                if name in env:
                    return env[name]  # self.intercept = ... bindings
            if expr.attr in ("T", "mT", "real", "data", "dtype"):
                return self._eval(path, expr.value, env, sink, depth, stack)
            return None
        if isinstance(expr, ast.Subscript):
            dt = self._eval(path, expr.value, env, sink, depth, stack)
            return self._index(path, dt, expr.slice, env, depth, stack)
        if isinstance(expr, ast.UnaryOp):
            if isinstance(expr.op, ast.Not):
                self._eval(path, expr.operand, env, sink, depth, stack)
                return _CONCRETE["bool_"]
            return self._eval(path, expr.operand, env, sink, depth, stack)
        if isinstance(expr, ast.BinOp):
            left = self._eval(path, expr.left, env, sink, depth, stack)
            right = self._eval(path, expr.right, env, sink, depth, stack)
            if isinstance(expr.op, ast.Div):
                out = true_divide(left, right)
            elif isinstance(expr.op, ast.MatMult):
                out = product(left, right)
            else:
                out = promote(left, right)
            self._note_promotion(sink, expr, left, right, out)
            return out
        if isinstance(expr, ast.Compare):
            dts = [self._eval(path, e, env, sink, depth, stack)
                   for e in [expr.left] + expr.comparators]
            libs = {d.lib for d in dts if d is not None}
            return _CONCRETE["bool_"]._replace(
                lib="torch" if "torch" in libs else "")
        if isinstance(expr, ast.BoolOp):
            out: Optional[DT] = None
            for v in expr.values:
                out = join(out, self._eval(path, v, env, sink, depth,
                                           stack)) if out is not None \
                    else self._eval(path, v, env, sink, depth, stack)
            return out
        if isinstance(expr, ast.IfExp):
            self._eval(path, expr.test, env, sink, depth, stack)
            return join(self._eval(path, expr.body, env, sink, depth, stack),
                        self._eval(path, expr.orelse, env, sink, depth,
                                   stack))
        if isinstance(expr, ast.Call):
            return self._eval_call(path, expr, env, sink, depth, stack)
        return None

    def _index(self, path, dt: Optional[DT], index: ast.expr, env, depth,
               stack) -> Optional[DT]:
        """``x[index]``: the dtype stays; slices keep the rank class, an
        index tensor gives a dimensioned one, anything else may drop the
        last dimension (a 0-dim tensor under torch) — unknown rank."""
        if dt is None or dt.weak:
            return dt
        parts = index.elts if isinstance(index, ast.Tuple) else [index]
        if all(isinstance(p, ast.Slice) for p in parts):
            return dt
        idx = [self._eval(path, p, env, None, depth, stack)
               for p in parts if not isinstance(p, ast.Slice)]
        if any(d is not None and not d.weak and d.scalar is False
               for d in idx):
            return dt._replace(scalar=False)
        return dt._replace(scalar=None)

    def _note_promotion(self, sink: Optional[FnFacts], node: ast.AST,
                        left: Optional[DT], right: Optional[DT],
                        out: Optional[DT]) -> None:
        """Record a provably-widening mix of a reduced array with a wide
        float (the dequant-free violation G017 reports in hot scopes)."""
        if sink is None or left is None or right is None or out is None:
            return
        if not out.wide_float:
            return
        reduced = [d for d in (left, right)
                   if d.reduced_float
                   or (d.category in ("i", "u") and d.bits <= 8
                       and not d.weak)]
        if reduced and any(d.wide_float for d in (left, right)):
            sink.promotions.append(PromotionSite(node, left, right, out))

    # -- call evaluation ----------------------------------------------------

    def _explicit_dtype(self, path, call, env, positional: Optional[int]
                        ) -> Tuple[bool, Optional[DT]]:
        """(given, dtype) for a call that takes dtype= (or a positional)."""
        kw = _kwarg(call, "dtype")
        if kw is not None:
            return True, self.dtype_of_dtype_expr(path, kw, env)
        if positional is not None and len(call.args) > positional:
            dt = self.dtype_of_dtype_expr(path, call.args[positional], env)
            if dt is not None:
                return True, dt
        return False, None

    def _eval_call(self, path, call: ast.Call, env, sink, depth, stack
                   ) -> Optional[DT]:
        for arg in call.args:
            if not isinstance(arg, ast.Starred):
                self._eval(path, arg, env, sink, depth, stack)
        for kw in call.keywords:
            self._eval(path, kw.value, env, sink, depth, stack)

        callee = dotted_name(call.func)
        if isinstance(call.func, ast.Attribute):
            tail = call.func.attr
            root = callee.rpartition(".")[0] if callee else None
        elif callee is not None:
            root, tail = "", callee
        else:
            return None
        module_call = root in _MODULE_ROOTS
        lib = "torch" if root in _TORCH_MODULES else \
            "np" if root in _NP_ROOTS else ""
        # a method's receiver; events are recorded only at dotted callees,
        # as the reference records them (x[w].float() is a window widen)
        recv = call.func.value if isinstance(call.func, ast.Attribute) \
            and not module_call else None
        rsink = sink if callee is not None else None

        def ev(node, s=None):
            return self._eval(path, node, env, s, depth, stack)

        recv_dt = ev(recv, sink) if recv is not None else None

        if tail in _SCATTER_CALLS and (recv is not None or lib == "torch"):
            return self._scatter(path, call, tail, recv, recv_dt, lib, ev,
                                 rsink)

        # numpy dtype constructors used as casts: np.float32(x)
        if lib == "np":
            dt = parse_dtype_name(tail)
            if dt is not None:
                inner = ev(call.args[0]) if call.args else None
                return _on(dt, "np", inner is None or inner.weak
                           or bool(inner.scalar))

        cast = self._cast(path, call, tail, recv, recv_dt, env)
        if cast is not None:
            given, target, out_lib = cast
            if rsink is not None and given:
                loop = enclosing_loop(call)
                rsink.casts.append(CastSite(
                    call, recv_dt, target, loop,
                    self._loop_invariant(recv, loop)))
            return _on(target, recv_dt.lib if recv_dt and recv_dt.lib
                       else out_lib,
                       recv_dt.scalar if recv_dt else False)

        if module_call and tail in TENSOR_FROM_HOST + (
                "asarray", "array", "ascontiguousarray"):
            return self._from_host(path, call, tail, lib, env, ev, rsink)

        if module_call and tail in ("zeros", "ones", "empty", "full", "rand",
                                    "randn", "randint", "randperm", "arange",
                                    "linspace", "logspace", "eye"):
            return self._constructor(path, call, tail, lib, env, ev)

        if tail in ("new_zeros", "new_ones", "new_empty", "new_full",
                    "new_tensor") and recv is not None:
            given, dt = self._explicit_dtype(path, call, env, None)
            return _on(dt, "torch") if given else _on(recv_dt, "torch")

        if tail in ("zeros_like", "ones_like", "empty_like", "full_like",
                    "rand_like", "randn_like"):
            given, dt = self._explicit_dtype(path, call, env, None)
            if given:
                return _on(dt, lib)
            return ev(call.args[0]) if call.args else None

        if tail in ("float", "int") and root == "":
            return WEAK_FLOAT if tail == "float" else WEAK_INT

        if tail == "item" and recv is not None:
            if recv_dt is None:
                return None
            return WEAK_FLOAT if recv_dt.category == "f" else WEAK_INT

        if tail == "numpy" and recv is not None:
            return _on(recv_dt, "np", recv_dt.scalar if recv_dt else False)

        if tail in REDUCTION_TAILS and (recv is not None or lib):
            return self._reduction(path, call, tail, recv, recv_dt, lib,
                                   env, ev, rsink)

        if tail in _PRESERVING_METHODS and recv is not None:
            return recv_dt

        if tail in _ELEMENTWISE_CALLS and (lib or recv is not None
                                           and tail != "where"):
            args = [a for a in call.args if not isinstance(a, ast.Starred)]
            if recv is not None:
                args = [recv] + args
                lib = recv_dt.lib if recv_dt else ""
            if tail == "where":
                args = args[1:]
            dts = [ev(a) for a in args]
            combine = true_divide if tail in _TRUE_DIVIDE_CALLS else \
                product if tail in _SAME_DTYPE_CALLS else promote
            out: Optional[DT] = dts[0] if dts else None
            for d in dts[1:]:
                out = combine(out, d, lib or None)
            if tail in _BINARY_PROMOTING_CALLS and len(dts) >= 2:
                self._note_promotion(rsink, call, dts[0], dts[1], out)
            return out

        # calls to resolvable defs: bind argument dtypes, join return exprs
        if callee is not None and "." not in callee:
            got = self.program.resolve_fn(path, callee, call)
            if got is not None:
                t_path, t_fn = got
                arg_dts = self._arg_dtypes(path, call, t_fn, env, depth,
                                           stack)
                return self._return_dtype(t_path, t_fn, arg_dts, depth + 1,
                                          stack)
        return None

    def _scatter(self, path, call, tail, recv, recv_dt, lib, ev, sink
                 ) -> Optional[DT]:
        """``table.index_add_(dim, idx, src)`` and its kin (or the
        ``torch.index_add(table, ...)`` form): the table's dtype, and a
        scatter event where the call accumulates."""
        args = list(call.args)
        if recv is None:  # torch.index_add(table, dim, idx, src)
            if not args:
                return None
            recv_dt, args = ev(args[0]), args[1:]
        accumulate = True
        if tail.startswith("index_put"):
            flag = _arg(call, args, 2, "accumulate")
            accumulate = isinstance(flag, ast.Constant) and flag.value is True
        elif tail.startswith("scatter_reduce"):
            accumulate = _str_value(_arg(call, args, 3, "reduce")) in \
                _ACCUMULATING_REDUCE
        if sink is not None and accumulate:
            sink.scatters.append(ScatterSite(
                call, tail, recv_dt,
                recv_dt is not None and recv_dt.lib == "torch"
                and tail in TORCH_WIDE_ACCUMULATORS))
        return _on(recv_dt, "torch")

    def _cast(self, path, call, tail, recv, recv_dt, env
              ) -> Optional[Tuple[bool, Optional[DT], str]]:
        """(target given, target dtype, library) of a cast method, or None
        when ``call`` is no cast. ``.to(device)`` alone is no cast."""
        if recv is None:
            return None
        if tail == "astype":
            if call.args:
                return True, self.dtype_of_dtype_expr(path, call.args[0],
                                                      env), "np"
            given, dt = self._explicit_dtype(path, call, env, None)
            return given, dt, "np"
        if tail in _NAMED_CASTS and not call.args and not call.keywords:
            return True, _CONCRETE[_NAMED_CASTS[tail]], "torch"
        if tail == "type" and (call.args or call.keywords):
            given, dt = self._explicit_dtype(path, call, env, 0)
            return True, dt, "torch"
        if tail == "to":
            given, dt = self._explicit_dtype(path, call, env, None)
            if given:
                return True, dt, "torch"
            rest = [a for a in call.args if not _is_device_expr(a)]
            if not rest:
                return False, recv_dt, "torch"  # a device move keeps dtype
            dt = self.dtype_of_dtype_expr(path, rest[0], env)
            return dt is not None, dt, "torch"
        return None

    def _from_host(self, path, call, tail, lib, env, ev, sink
                   ) -> Optional[DT]:
        """``np.asarray(x)`` / ``torch.as_tensor(x)`` and their kin: the
        explicit dtype, else the data's, with Python scalars made concrete
        the library's way (NumPy: float64 / int64; torch: float32 / int64
        and a 0-dim tensor)."""
        if _spread(call):
            return None
        data = call.args[0] if call.args else None
        inner = self._data_dtype(data, ev) if data is not None else None
        # torch.tensor(2.0) / torch.as_tensor(np.float64(x)) are 0-dim
        zero = lib == "torch" and inner is not None and (
            inner.weak and not isinstance(data, (ast.List, ast.Tuple))
            or inner.scalar)
        pos = 1 if tail in ("as_tensor", "asarray", "array",
                            "ascontiguousarray") else None
        given, dt = self._explicit_dtype(path, call, env, pos)
        if given:
            return _on(dt, lib, zero)
        if lib == "torch" and sink is not None and not cast_after(call):
            sink.host_sources.append(HostSource(call, inner))
        if inner is None:
            return None
        if lib == "np":
            return _on(inner, "np")  # an ndarray, 0-d or not
        if inner.weak:
            inner = _TORCH_DEFAULT_FLOAT if inner.category == "f" \
                else _TORCH_DEFAULT_INT
        return _on(inner, "torch", zero)

    @staticmethod
    def _data_dtype(data: ast.expr, ev) -> Optional[DT]:
        """The dtype of a constructor's data argument; a list / tuple
        literal of Python scalars is the widest of them (still weak)."""
        if isinstance(data, (ast.List, ast.Tuple)):
            dts = [ev(e) for e in data.elts]
            if not dts or any(d is None or not d.weak for d in dts):
                return None
            out = dts[0]
            for d in dts[1:]:
                out = _python(out, d)
            return out
        return ev(data)

    def _constructor(self, path, call, tail, lib, env, ev) -> Optional[DT]:
        """``zeros/ones/empty/full/arange/...``: the explicit dtype, else
        NumPy's float64 / torch's float32 default, or the fill's / the
        range's own category."""
        if _spread(call):
            return None
        if lib == "np":
            pos = {"full": 2, "arange": None, "linspace": None,
                   "eye": None}.get(tail, 1)
        else:
            pos = None  # torch takes dtype= only as a keyword
        given, dt = self._explicit_dtype(path, call, env, pos)
        if given:
            return _on(dt, lib)
        if tail in ("randint", "randperm"):
            return _on(_CONCRETE["int64"], lib)
        if tail in ("full", "arange"):
            if tail == "full":
                fill = _kwarg(call, "fill_value")
                vals = [fill if fill is not None else
                        (call.args[1] if len(call.args) > 1 else None)]
            else:
                vals = [a for a in call.args if not isinstance(a,
                                                               ast.Starred)]
            dts = [ev(v) if v is not None else None for v in vals]
            if not dts or any(d is None for d in dts):
                return None
            out = dts[0]
            for d in dts[1:]:
                out = _python(out, d) if out.weak and d.weak else None
                if out is None:
                    return None
            if lib == "np":
                return _on(out, "np")
            if out.weak:
                return _on(_TORCH_DEFAULT_FLOAT if out.category == "f"
                           else _TORCH_DEFAULT_INT, "torch")
            return _on(out, "torch") if out.category == "b" \
                else _on(_wrapped(out), "torch")
        return _on(_CONCRETE["float64"] if lib == "np"
                   else _TORCH_DEFAULT_FLOAT, lib)

    def _reduction(self, path, call, tail, recv, recv_dt, lib, env, ev,
                   sink) -> Optional[DT]:
        """``x.sum()`` / ``torch.sum(x)`` / ``torch.segment_reduce(x,
        "sum", ...)``: a reduction event, and the result dtype — the
        explicit accumulator, else the operand's, with integer sums
        widened to int64."""
        if recv is not None:
            operand, rest = recv_dt, call.args
        elif call.args:
            # args were already evaluated (events recorded) — re-evaluate
            # without the sink to avoid duplicates
            operand, rest = ev(call.args[0]), call.args[1:]
        else:
            return None
        op_lib = lib or (operand.lib if operand else "")
        if tail == "segment_reduce" and _str_value(
                _arg(call, rest, 0, "reduce")) not in _ACCUMULATING_REDUCE:
            return _on(operand, "torch")
        given, acc_dt = self._explicit_dtype(path, call, env, None)
        # an explicit dtype= that does not RESOLVE (a threaded parameter)
        # is trusted like every unknown — only an explicit accumulator
        # provably equal to a reduced operand stays flaggable
        widened = given and (
            acc_dt is None or operand is None
            or acc_dt.bits > operand.bits
            or acc_dt.category != operand.category)
        if not given and operand is not None and operand.lib == "torch" \
                and tail in TORCH_WIDE_ACCUMULATORS:
            widened = True
        if sink is not None:
            sink.reductions.append(ReductionSite(call, tail, operand,
                                                 widened))
        full = tail in _FULL_REDUCTIONS and not rest and not any(
            kw.arg in ("dim", "axis") for kw in call.keywords)
        if given:
            return _on(acc_dt, op_lib, full)
        if operand is None:
            return None
        if operand.category in ("b", "i", "u"):
            if tail in _INT_WIDENING_REDUCTIONS:
                wide = "uint64" if op_lib == "np" and \
                    operand.category == "u" else "int64"
                return _on(_CONCRETE[wide], op_lib, full)
            if tail in ("mean", "nanmean") and op_lib == "np":
                return _on(_CONCRETE["float64"], "np", full)
            return None
        return _on(operand, op_lib, full)

    def _arg_dtypes(self, path, call, callee_fn, env, depth, stack
                    ) -> Dict[str, Optional[DT]]:
        a = callee_fn.args
        params = [p.arg for p in a.posonlyargs + a.args]
        offset = 1 if params[:1] == ["self"] else 0
        out: Dict[str, Optional[DT]] = {}
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            j = i + offset
            if j < len(params):
                out[params[j]] = self._eval(path, arg, env, None, depth,
                                            stack)
        for kw in call.keywords:
            if kw.arg is not None:
                out[kw.arg] = self._eval(path, kw.value, env, None, depth,
                                         stack)
        return out

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _loop_invariant(recv: ast.expr, loop: Optional[ast.AST]) -> bool:
        """True when the cast receiver is a Name that no statement inside
        the enclosing loop rebinds — the cast re-materializes the same
        tensor every iteration."""
        if loop is None or not isinstance(recv, ast.Name):
            return False
        name = recv.id
        for node in ast.walk(loop):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if any(isinstance(n, ast.Name) and n.id == name
                           for n in ast.walk(tgt)):
                        return False
            elif isinstance(node, ast.AugAssign):
                if any(isinstance(n, ast.Name) and n.id == name
                       for n in ast.walk(node.target)):
                    return False
            elif isinstance(node, ast.For):
                if any(isinstance(n, ast.Name) and n.id == name
                       for n in ast.walk(node.target)):
                    return False
        return True


def get_model(program: ProgramModel) -> DtypeFlow:
    """One DtypeFlow per ProgramModel (all the dtype rules share it)."""
    model = getattr(program, "_graftcheck_dtypeflow", None)
    if model is None:
        model = DtypeFlow(program)
        program._graftcheck_dtypeflow = model
    return model


def in_hot_scope(path: str, model: Optional[ModuleModel],
                 fn: Optional[ast.AST] = None) -> bool:
    """Hot-path scoping for G017/G019: the kernel/op packages and the
    serving score path always; elsewhere in the dtype-sensitive packages
    only traced or step-shaped functions (their math runs per step)."""
    from . import config

    if path.startswith(config.DTYPEFLOW_HOT_PREFIXES) \
            or path in config.DTYPEFLOW_HOT_MODULES:
        return True
    if model is not None and config.HOT_MARKER in model.source:
        return True
    if fn is not None and model is not None \
            and path.startswith(config.DTYPE_MODULE_PREFIXES):
        if model.is_traced(fn) or config.HOT_FN_RE.match(
                getattr(fn, "name", "")):
            return True
    return False
