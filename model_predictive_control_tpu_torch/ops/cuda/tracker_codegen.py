"""K3 for any row function: a tracer, a C++ emitter and the build at first use.

The fused tracker's kernel (``csrc/ilqr_factory_ext.cu``) is templated on a
model functor and a constraint-row functor. The hand-written functors cover
the models the paths use; any other row function the twin takes reaches the
card through this module:

1. :func:`trace` runs the row function ``(xr, ur[, pr])`` once on symbolic
   scalars (:class:`Sym`) and records every operation in the function's own
   order (a :class:`Trace`, SSA). The symbols take exactly the operations
   the twin's :class:`~.ilqr_factory.Dual` takes: ``+ − × ÷`` and unary
   ``−``, the four comparisons that feed ``where``, and ``sin``, ``cos``,
   ``tan``, ``sqrt``, ``atan``, ``tanh``, ``abs``, ``clamp`` and ``where``.
   Anything else raises the twin's ``NotImplementedError`` while tracing.
2. :func:`emit_model` / :func:`emit_rows` write the trace as a C++ functor of
   the hand functors' shape (``template <class S> rows(x, u, p, mc, f)``,
   ``NX``/``NU``/``NP``; for constraint rows ``NEXTRA``, ``NE`` and ``dep``)
   on the kernel's ``d*`` helpers, one SSA line per operation.
3. :func:`generated_library` writes one translation unit per solve shape
   (the functors and one ``Problem`` instantiation of the generalized
   solver) under ``build/gen/`` and builds it with the K3 flags, keyed by a
   hash of the source and the flags, at first use.

The generated code is the twin's float program, bit for bit on the card:

- a Python number is rounded to float32 where it first meets a traced value
  (torch's rule for a scalar operand), arithmetic between Python numbers
  stays in Python, and constants are emitted as exact hex-float literals;
- ``t / c`` with a Python number ``c`` is ``t`` times the float32 reciprocal
  of ``c`` (torch's CUDA division by a scalar), ``c / t`` the reciprocal of
  ``t`` times ``c`` (``Tensor.__rtruediv__``: ``rdiv``);
- ``abs``'s tangent at 0 and ``clamp``'s tie weight come from the helpers
  the hand functors share.

Limits, as the twin's: the row function is traced once, so control flow on
traced values raises (``where`` takes its place); tensors captured by the
function are refused (pass Python numbers or parameter rows).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import numbers

import numpy as np
import torch

from ._build import BUILD_DIR, PKG, load_library

# kinds of a traced value: through x or u (S: the functor's scalar type,
# float or a dual), a runtime float (parameter rows, the additive mode's
# exogenous rows), a condition
S, F, B = "S", "F", "B"
_UNARY = {torch.sin: "sin", torch.cos: "cos", torch.tan: "tan", torch.sqrt: "sqrt",
          torch.atan: "atan", torch.tanh: "tanh", torch.abs: "abs"}
_TABLE = sorted([*(f.__name__ for f in _UNARY), "clamp", "where", "add", "sub", "mul", "div"])


def _refuse(what: str):
    raise NotImplementedError(
        f"{what} has no dual-number rule: the tracker twin differentiates only {_TABLE} "
        "(with + - * / and unary -, and < <= > >= feeding where)")


@dataclasses.dataclass(frozen=True)
class Const:
    """A Python number where it meets a traced value (torch computes with
    its float32 rounding: :func:`literal`)."""

    value: float


@dataclasses.dataclass(frozen=True)
class Node:
    op: str  # x, u, p | add, sub, mul, div, neg | lt, le, gt, ge, and, or, not | fn | clamp | where
    args: tuple  # Sym indices (int) or Const
    kind: str
    fn: str = ""  # the unary function's name (op "fn")


class Trace:
    """The recorded operations (``nodes``, SSA) and the outputs (node
    indices or :class:`Const`)."""

    def __init__(self):
        self.nodes: list[Node] = []
        self.outputs: tuple = ()

    def add(self, op, args, kind, fn="") -> "Sym":
        self.nodes.append(Node(op, tuple(args), kind, fn))
        return Sym(self, len(self.nodes) - 1)


def _operand(trace, o):
    """A Sym's index or a Const; anything else is refused."""
    if isinstance(o, Sym):
        if o.trace is not trace:
            raise ValueError("values of two traces meet")
        return o.idx
    if isinstance(o, numbers.Real) and not isinstance(o, torch.Tensor):
        return Const(float(o))
    if isinstance(o, torch.Tensor):
        raise NotImplementedError(
            "a tensor captured by the row function cannot be compiled into the kernel: pass "
            "Python numbers or parameter rows")
    return None


class Sym:
    """A traced scalar: a node of a :class:`Trace`."""

    __slots__ = ("trace", "idx")

    def __init__(self, trace, idx):
        self.trace = trace
        self.idx = idx

    @property
    def kind(self) -> str:
        return self.trace.nodes[self.idx].kind

    def _bin(self, op, a, b):
        ia, ib = _operand(self.trace, a), _operand(self.trace, b)
        if ia is None or ib is None:
            return NotImplemented
        kinds = [self.trace.nodes[i].kind for i in (ia, ib) if isinstance(i, int)]
        if B in kinds:
            _refuse(f"arithmetic on a condition ({op})")
        return self.trace.add(op, (ia, ib), S if S in kinds else F)

    def __add__(self, o):
        return self._bin("add", self, o)

    def __radd__(self, o):
        return self._bin("add", o, self)

    def __sub__(self, o):
        return self._bin("sub", self, o)

    def __rsub__(self, o):
        return self._bin("sub", o, self)

    def __mul__(self, o):
        return self._bin("mul", self, o)

    def __rmul__(self, o):
        return self._bin("mul", o, self)

    def __truediv__(self, o):
        return self._bin("div", self, o)

    def __rtruediv__(self, o):
        return self._bin("div", o, self)

    def __neg__(self):
        if self.kind == B:
            _refuse("negation of a condition")
        return self.trace.add("neg", (self.idx,), self.kind)

    def _cmp(self, op, o):
        io = _operand(self.trace, o)
        if io is None:
            return NotImplemented
        if self.kind == B or (isinstance(io, int) and self.trace.nodes[io].kind == B):
            _refuse(f"comparison of a condition ({op})")
        return self.trace.add(op, (self.idx, io), B)

    def __lt__(self, o):
        return self._cmp("lt", o)

    def __le__(self, o):
        return self._cmp("le", o)

    def __gt__(self, o):
        return self._cmp("gt", o)

    def __ge__(self, o):
        return self._cmp("ge", o)

    def _logic(self, op, o):
        io = _operand(self.trace, o)
        if self.kind != B or not isinstance(io, int) or self.trace.nodes[io].kind != B:
            _refuse(f"{op} of values that are not conditions")
        return self.trace.add(op, (self.idx, io), B)

    def __and__(self, o):
        return self._logic("and", o)

    def __or__(self, o):
        return self._logic("or", o)

    def __invert__(self):
        if self.kind != B:
            _refuse("~ of a value that is not a condition")
        return self.trace.add("not", (self.idx,), B)

    def __eq__(self, o):
        _refuse("==")

    def __ne__(self, o):
        _refuse("!=")

    __hash__ = None

    def __pow__(self, o):
        _refuse("**")

    def __rpow__(self, o):
        _refuse("**")

    def __abs__(self):
        _refuse("abs() (use torch.abs)")

    def __pos__(self):
        _refuse("unary +")

    def __mod__(self, o):
        _refuse("%")

    def __floordiv__(self, o):
        _refuse("//")

    def __bool__(self):
        raise NotImplementedError(
            "control flow on a traced value cannot be compiled into the kernel: use torch.where")

    def __float__(self):
        raise NotImplementedError("a traced value cannot be converted to a Python number")

    __int__ = __index__ = __float__

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        _refuse(f"Tensor.{name}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _UNARY:
            (a,) = args
            return a.trace.add("fn", (a.idx,), a.kind, _UNARY[func])
        if func is torch.clamp:
            return _clamp(*args, **kwargs)
        if func is torch.where:
            return _where(*args, **kwargs)
        _refuse(str(func))


def _clamp(a, min=None, max=None):
    if not isinstance(a, Sym) or a.kind == B:
        _refuse("clamp of a value that is not traced")
    bounds = [_operand(a.trace, c) for c in (min, max)]
    if any(isinstance(b, int) and a.trace.nodes[b].kind == S for b in bounds):
        _refuse("clamp against a traced bound")
    if (min is None) == (max is None) and a.kind == S:
        raise NotImplementedError("the dual clamp takes one constant bound")
    if min is None and max is None:
        raise ValueError("clamp needs a bound")
    return a.trace.add("clamp", (a.idx, *bounds), a.kind)


def _where(cond, a, b):
    if not isinstance(cond, Sym) or cond.kind != B:
        _refuse("where on a condition that is not traced")
    ia, ib = _operand(cond.trace, a), _operand(cond.trace, b)
    kinds = [cond.trace.nodes[i].kind for i in (ia, ib) if isinstance(i, int)]
    if B in kinds:
        _refuse("where between conditions")
    return cond.trace.add("where", (cond.idx, ia, ib), S if S in kinds else F)


def trace(fn, n_x: int, n_u: int, n_p: int = 0, *, u_kind: str = S, n_out: int | None = None
          ) -> Trace:
    """Run ``fn(xr, ur[, pr])`` on symbols: ``n_x`` state rows and ``n_u``
    input rows of kind ``u_kind`` (``F`` for the additive mode's exogenous
    rows), ``n_p`` parameter rows (passed when ``n_p > 0``). The outputs
    must number ``n_out`` where it is given."""
    tr = Trace()
    xr = tuple(tr.add("x", (i,), S) for i in range(n_x))
    ur = tuple(tr.add("u", (j,), u_kind) for j in range(n_u))
    pr = tuple(tr.add("p", (k,), F) for k in range(n_p))
    out = fn(xr, ur, pr) if n_p else fn(xr, ur)
    out = tuple(out)
    if n_out is not None and len(out) != n_out:
        raise ValueError(f"the row function gave {len(out)} rows, not {n_out}")
    res = []
    for o in out:
        io = _operand(tr, o)
        if io is None or (isinstance(io, int) and tr.nodes[io].kind == B):
            raise TypeError(f"a row must be a number or a traced value, not {type(o).__name__}")
        res.append(io)
    tr.outputs = tuple(res)
    return tr


def replay(tr: Trace, xr, ur, pr=()):
    """The trace's operations in torch (tensors or :class:`Dual` numbers),
    as the row function did them: the same operators with the same operand
    order and the Python numbers as given."""
    vals = []
    get = lambda a: a.value if isinstance(a, Const) else vals[a]
    ins = {"x": xr, "u": ur, "p": pr}
    bins = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
            "div": lambda a, b: a / b, "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
            "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
            "and": lambda a, b: a & b, "or": lambda a, b: a | b}
    fns = {v: k for k, v in _UNARY.items()}
    for n in tr.nodes:
        if n.op in ins:
            v = ins[n.op][n.args[0]]
        elif n.op in bins:
            v = bins[n.op](get(n.args[0]), get(n.args[1]))
        elif n.op == "neg":
            v = -get(n.args[0])
        elif n.op == "not":
            v = ~get(n.args[0])
        elif n.op == "fn":
            v = fns[n.fn](get(n.args[0]))
        elif n.op == "clamp":
            lo, hi = (None if a is None else get(a) for a in n.args[1:])
            v = torch.clamp(get(n.args[0]), min=lo, max=hi)
        else:  # where
            v = torch.where(*(get(a) for a in n.args))
        vals.append(v)
    return tuple(get(o) for o in tr.outputs)


# ---------------------------------------------------------------------------
# the C++ emitter
# ---------------------------------------------------------------------------


def literal(v: float) -> str:
    """The float32 value of ``v`` as an exact C++ float literal."""
    f = float(np.float32(v))
    if math.isnan(f):
        return "NAN"
    if math.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    mant, exp = f.hex().split("p")
    return f"{mant.rstrip('0').rstrip('.')}p{exp}f"


_CTYPE = {S: "S", F: "float", B: "bool"}
_OPS = {"add": "+", "sub": "-", "mul": "*", "lt": "<", "le": "<=", "gt": ">", "ge": ">=",
        "and": "&&", "or": "||"}


def _body(tr: Trace, out: str, names: dict) -> list[str]:
    """SSA lines computing the trace into ``out[i]`` (of type S)."""
    lines = []
    ref = lambda a: literal(a.value) if isinstance(a, Const) else f"v{a}"
    cmpref = lambda a: literal(a.value) if isinstance(a, Const) else f"val(v{a})"
    kind = lambda a: None if isinstance(a, Const) else tr.nodes[a].kind

    def as_s(a):
        return ref(a) if kind(a) == S else f"lift<S>({ref(a)})"

    for i, n in enumerate(tr.nodes):
        a = n.args
        if n.op in names:
            e = f"{names[n.op]}[{a[0]}]"
        elif n.op == "div" and isinstance(a[1], Const):
            # torch divides by a scalar as the product with its float32 reciprocal
            e = f"{ref(a[0])} * {literal(np.float32(1.0) / np.float32(a[1].value))}"
        elif n.op == "div" and isinstance(a[0], Const):
            e = f"rdiv({ref(a[0])}, {ref(a[1])})"
        elif n.op == "div":
            e = f"{ref(a[0])} / {ref(a[1])}"
        elif n.op in ("add", "sub", "mul", "and", "or"):
            e = f"{ref(a[0])} {_OPS[n.op]} {ref(a[1])}"
        elif n.op in ("lt", "le", "gt", "ge"):
            e = f"{cmpref(a[0])} {_OPS[n.op]} {cmpref(a[1])}"
        elif n.op == "neg":
            e = f"-{ref(a[0])}"
        elif n.op == "not":
            e = f"!{ref(a[0])}"
        elif n.op == "fn":
            e = f"d{n.fn}({ref(a[0])})"
        elif n.op == "clamp":
            e = ref(a[0])
            if a[1] is not None:
                e = f"dclamp_min({e}, {ref(a[1])})"
            if a[2] is not None:
                e = f"dclamp_max({e}, {ref(a[2])})"
        else:  # where
            if n.kind == S:
                e = f"dwhere({ref(a[0])}, {as_s(a[1])}, {as_s(a[2])})"
            else:
                e = f"({ref(a[0])} ? {ref(a[1])} : {ref(a[2])})"
        lines.append(f"    const {_CTYPE[n.kind]} v{i} = {e};")
    for k, o in enumerate(tr.outputs):
        lines.append(f"    {out}[{k}] = {as_s(o)};")
    return lines


def emit_model(tr: Trace, name: str, *, nx: int, nu: int, n_p: int, additive: bool = False,
               n_exo: int = 0) -> str:
    """The model functor: ``rows(x, u, p, mc, f)``; in the additive mode the
    second argument is the stage's exogenous rows (floats) and ``NU = NX``."""
    u_type = "float" if additive else "S"
    head = [
        f"struct {name} {{",
        f"  static constexpr int NX = {nx}, NU = {nx if additive else nu}, NP = {n_p};",
        f"  static constexpr bool ADD = {'true' if additive else 'false'};",
        f"  static constexpr int NEXO = {n_exo if additive else 0};",
        "  template <class S>",
        f"  __device__ __forceinline__ static void rows(const S* x, const {u_type}* u, "
        "const float* p, const float* mc, S* f) {",
    ]
    return "\n".join(head + _body(tr, "f", {"x": "x", "u": "u", "p": "p"}) + ["  }", "};", ""])


def emit_rows(tr: Trace, name: str, deps: tuple) -> str:
    """The constraint-row functor: ``NEXTRA`` rows on the dependency
    columns ``deps`` (z = x rows, then u rows)."""
    chain = " : ".join(f"k == {k} ? {d}" for k, d in enumerate(deps))
    head = [
        f"struct {name} {{",
        f"  static constexpr int NEXTRA = {len(tr.outputs)}, NE = {len(deps)};",
        "  __host__ __device__ static constexpr int dep(int k) { return "
        f"{chain + ' : ' if deps else ''}-1; }}",
        "  template <class S>",
        "  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p, "
        "const float* ec, S* f) {",
    ]
    return "\n".join(head + _body(tr, "f", {"x": "x", "u": "u", "p": "p"}) + ["  }", "};", ""])


# ---------------------------------------------------------------------------
# one solve's instantiation
# ---------------------------------------------------------------------------

EXT_SOURCE = PKG / "csrc" / "ilqr_factory_ext.cu"
GEN_DIR = BUILD_DIR / "gen"
ENTRY = "tracker_generated_launch"


@dataclasses.dataclass(frozen=True)
class Instantiation:
    """What one generated translation unit compiles: the functors' source
    and the solve's compile-time properties."""

    model: str  # the model functor's source (struct GenModel)
    rows: str  # the constraint functor's source (struct GenRows), or ""
    rk4: bool
    ubox: bool
    order: int  # the user rows' derivative order (0 without rows)
    wrt: bool
    tbox: bool
    rw: bool

    def source(self) -> str:
        extra = "GenRows" if self.rows else "NoRows"
        b = lambda v: "true" if v else "false"
        return "\n".join([
            "// Generated from a row function by "
            "model_predictive_control_tpu_torch/ops/cuda/tracker_codegen.py:",
            "// one instantiation of the generalized fused tracker.",
            "#define TRACKER_GENERATED",
            '#include "ilqr_factory_ext.cu"',
            "",
            self.model,
            self.rows,
            f"using GenProblem = Problem<GenModel, {b(self.ubox)}, {extra}, {self.order}, "
            f"{b(self.wrt)}, {b(self.tbox)}, {b(self.rw)}>;",
            f"FIXED_ENTRY({ENTRY}, GenProblem, {b(self.rk4)})",
            "",
        ])

    @property
    def key(self) -> str:
        """``gen_`` and the first 12 hex digits of the source's hash: the
        name of its launch count (``LAUNCHES_BY_KERNEL``)."""
        return "gen_" + hashlib.sha256(self.source().encode()).hexdigest()[:12]


def instantiation_of(ode_rows, extra_constraints=None, *, nx: int, nu: int, n_params: int = 0,
                     n_extra: int = 0, extra_deps: tuple = (), extra_order: int = 2,
                     integrator: str = "rk4", ubox: bool = True, wrt: bool = False,
                     tbox: bool = False, rw: bool = False, additive: bool = False,
                     n_exo: int = 0) -> Instantiation:
    """Trace the model (and the constraint rows) and name the solve's
    instantiation. ``extra_deps`` is the resolved tuple of z columns."""
    m = trace(ode_rows, nx, n_exo if additive else nu, n_params, u_kind=F if additive else S,
              n_out=nx)
    model = emit_model(m, "GenModel", nx=nx, nu=nu, n_p=n_params, additive=additive,
                       n_exo=n_exo)
    rows = ""
    if extra_constraints is not None:
        r = trace(extra_constraints, nx, nu, n_params, n_out=n_extra)
        rows = emit_rows(r, "GenRows", tuple(extra_deps))
    return Instantiation(model=model, rows=rows, rk4=integrator == "rk4", ubox=ubox,
                         order=extra_order if rows else 0, wrt=wrt, tbox=tbox, rw=rw)


def library_name(inst: Instantiation, group: int) -> str:
    stem = "ilqr_factory_" + inst.key
    return stem if group == 1 else f"{stem}_g{group}"


def generated_library(inst: Instantiation, group: int, configure, flags: tuple) -> ctypes.CDLL:
    """Build (at first use: the source written under ``build/gen/``, nvcc
    with ``flags``) and load the library of ``inst`` for ``group`` threads
    per lane. A build that fails raises with nvcc's log."""
    name = library_name(inst, group)
    src = GEN_DIR / f"{name}.cu"
    text = inst.source()
    if not src.exists() or src.read_text() != text:
        GEN_DIR.mkdir(parents=True, exist_ok=True)
        tmp = src.with_suffix(".tmp")
        tmp.write_text(text)
        tmp.replace(src)
    return load_library(name, [src], configure,
                        extra_flags=(*flags, f"-DTRACKER_GROUP={group}", f"-I{EXT_SOURCE.parent}"),
                        depends=[EXT_SOURCE])
