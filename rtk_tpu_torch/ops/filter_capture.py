"""Capture a filter predicate once and emit it as C++ for the CUDA kernel.

rtk_tpu's packet kernel inlines a jax-traceable filter callable into its
leaf phase by tracing it (pallas_trace.py:1003-1018).  CUDA C++ cannot call
Python, so the port traces the callable the same way: `jit_filter(fn)`
calls `fn` once on a symbolic HitCandidate whose six fields are
expression nodes.  Their Python operators record an expression tree, which
is emitted as `rtk_filter_pred`, a C++ predicate that csrc/packet_trace.cu
compiles into its filter build (-DRTK_FILTER).  Each distinct predicate
is its own build, keyed on the hash of its C++ text.

The captured set, with torch's semantics on the plain version's dtypes
(t, u, v float32; mesh_index, triangle_index, ray_index int32):

  * + - * on int or float operands (int32 wraps); / is true division
    (int / int gives float32); // and % floor (% takes the divisor's sign);
  * comparisons < <= > >= == != (NaN compares false, except !=);
  * & | ^ ~ on bool (logical) or int32 (bitwise) operands;
  * unary -, abs(), torch.abs and torch.where;
  * Python int, float and bool constants (ints within int32).

Mixed operands promote as torch promotes them: int32 with a float operand
or float constant becomes float32; bool with int32 becomes int32.  The
predicate must return a bool expression (or a Python bool).  Anything
else -- `and`/`or`/`if` on a candidate field, other torch or numpy calls,
attribute access, arithmetic on bools -- raises TypeError from jit_filter.
Such a callable runs on the stack engine (trace/stack.py), which calls it
on real tensors; the Tracer routes unmarked callables there.
"""
from __future__ import annotations

import hashlib
import math
import operator

import numpy as np
import torch

from rtk_tpu_torch.types import HitCandidate

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_RANK = {"bool": 0, "int": 1, "float": 2}
_CTYPE = {"bool": "bool", "int": "int", "float": "float"}
FIELDS = (("t", "float"), ("u", "float"), ("v", "float"),
          ("mesh_index", "int"), ("triangle_index", "int"),
          ("ray_index", "int"))

_STACK_HINT = ("; run such a predicate on the stack engine (pass it "
               "unmarked to Tracer.closest/any, or to trace_closest/"
               "trace_any)")


class FilterCaptureError(TypeError):
    """A filter callable used something jit_filter cannot capture."""


def _refuse(what: str):
    raise FilterCaptureError(f"jit_filter cannot capture {what}"
                             + _STACK_HINT)


class Expr:
    """One node of a captured predicate: a field, a constant or an
    operation, with its torch dtype class (bool, int32 or float32)."""

    __slots__ = ("op", "dtype", "args", "value")
    __array_ufunc__ = None  # numpy functions on a field: TypeError

    def __init__(self, op, dtype, args=(), value=None):
        self.op, self.dtype, self.args, self.value = op, dtype, args, value

    def __bool__(self):
        _refuse("Python control flow on a candidate field (`if`, `and`, "
                "`or`, `not`, bool())")

    __hash__ = None

    def __getattr__(self, name):
        if name.startswith("__"):  # protocol probes (copy, numpy, ...)
            raise AttributeError(name)
        _refuse(f"the attribute or method {name!r} of a candidate field")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if not kwargs:
            if func is torch.where and len(args) == 3:
                return _where(*args)
            if func is torch.abs and len(args) == 1:
                return abs(args[0])
        _refuse(f"the torch call {getattr(func, '__name__', func)}")

    # arithmetic
    def __add__(self, o): return _arith("+", self, o)
    def __radd__(self, o): return _arith("+", o, self)
    def __sub__(self, o): return _arith("-", self, o)
    def __rsub__(self, o): return _arith("-", o, self)
    def __mul__(self, o): return _arith("*", self, o)
    def __rmul__(self, o): return _arith("*", o, self)
    def __truediv__(self, o): return _arith("/", self, o)
    def __rtruediv__(self, o): return _arith("/", o, self)
    def __floordiv__(self, o): return _arith("//", self, o)
    def __rfloordiv__(self, o): return _arith("//", o, self)
    def __mod__(self, o): return _arith("%", self, o)
    def __rmod__(self, o): return _arith("%", o, self)

    # comparisons
    def __lt__(self, o): return _compare("<", self, o)
    def __le__(self, o): return _compare("<=", self, o)
    def __gt__(self, o): return _compare(">", self, o)
    def __ge__(self, o): return _compare(">=", self, o)
    def __eq__(self, o): return _compare("==", self, o)
    def __ne__(self, o): return _compare("!=", self, o)

    # logical / bitwise
    def __and__(self, o): return _bitwise("&", self, o)
    def __rand__(self, o): return _bitwise("&", o, self)
    def __or__(self, o): return _bitwise("|", self, o)
    def __ror__(self, o): return _bitwise("|", o, self)
    def __xor__(self, o): return _bitwise("^", self, o)
    def __rxor__(self, o): return _bitwise("^", o, self)

    def __invert__(self):
        if self.dtype == "float":
            _refuse("~ on a float value")
        return Expr("~", self.dtype, (self,))

    def __neg__(self):
        if self.dtype == "bool":
            _refuse("unary - on a bool value")
        return Expr("neg", self.dtype, (self,))

    def __pos__(self):
        if self.dtype == "bool":
            _refuse("unary + on a bool value")
        return self

    def __abs__(self):
        if self.dtype == "bool":
            _refuse("abs() on a bool value")
        return Expr("abs", self.dtype, (self,))


def _const(x) -> Expr:
    """A Python constant as a node, typed as torch types a scalar."""
    if isinstance(x, bool):
        return Expr("const", "bool", value=x)
    if isinstance(x, int):
        return Expr("const", "int", value=x)
    if isinstance(x, float):
        return Expr("const", "float", value=x)
    _refuse(f"a value of type {type(x).__name__} (only candidate fields "
            "and Python int, float and bool constants)")


def _promote(a, b) -> str:
    """torch's result type of a binary operation on a and b (Expr or
    Python constants): constants only raise the category."""
    ea, eb = isinstance(a, Expr), isinstance(b, Expr)
    if not (ea or eb):
        _refuse("an operation between two constants")
    a = a if ea else _const(a)
    b = b if eb else _const(b)
    if ea and eb:
        return max(a.dtype, b.dtype, key=_RANK.get)
    tensor, const = (a, b) if ea else (b, a)
    if _RANK[const.dtype] > _RANK[tensor.dtype]:
        if tensor.dtype == "bool":
            # torch gives int64 for bool tensor with an int constant
            _refuse("a bool value combined with a numeric constant")
        return const.dtype
    return tensor.dtype


def _wrap(x, dtype) -> Expr:
    """x as a node of `dtype`: constants are checked and typed, nodes of
    another dtype are cast (int -> float, bool -> int)."""
    if not isinstance(x, Expr):
        x = _const(x)
    if x.op == "const":
        v = x.value
        if dtype == "int":
            if isinstance(v, float):
                _refuse("a float constant in int32 arithmetic")
            if not _I32_MIN <= int(v) <= _I32_MAX:
                _refuse(f"the int constant {v}, outside int32")
            return Expr("const", "int", value=int(v))
        if dtype == "float":
            return Expr("const", "float", value=float(np.float32(v)))
        return Expr("const", "bool", value=bool(v))
    if x.dtype == dtype:
        return x
    return Expr("cast", dtype, (x,))


def _arith(op, a, b) -> Expr:
    dt = _promote(a, b)
    if dt == "bool":
        _refuse(f"{op} on bool values")
    if op == "/":
        dt = "float"  # true division
    return Expr(op, dt, (_wrap(a, dt), _wrap(b, dt)))


def _compare(op, a, b) -> Expr:
    dt = _promote(a, b)
    if dt == "bool" and op not in ("==", "!="):
        _refuse(f"{op} on bool values")
    return Expr(op, "bool", (_wrap(a, dt), _wrap(b, dt)))


def _bitwise(op, a, b) -> Expr:
    dt = _promote(a, b)
    if dt == "float":
        _refuse(f"{op} on float values")
    return Expr(op, dt, (_wrap(a, dt), _wrap(b, dt)))


def _where(cond, a, b) -> Expr:
    if not isinstance(cond, Expr) or cond.dtype != "bool":
        _refuse("torch.where with a condition that is not a bool field "
                "expression")
    if not (isinstance(a, Expr) or isinstance(b, Expr)):
        _refuse("torch.where between two constants")
    dt = _promote(a, b)
    return Expr("where", dt, (cond, _wrap(a, dt), _wrap(b, dt)))


# ---------------------------------------------------------------- emitter

def _literal(node: Expr) -> str:
    v = node.value
    if node.dtype == "bool":
        return "true" if v else "false"
    if node.dtype == "int":
        return "(-2147483647 - 1)" if v == _I32_MIN else f"({v})"
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return f"{float(np.float32(v)).hex()}f"


def _emit_op(node: Expr, a: list[str]) -> str:
    op, dt = node.op, node.dtype
    if op == "cast":
        return f"({_CTYPE[dt]})({a[0]})"
    if op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if op == "neg":
        return f"rtk_ineg({a[0]})" if dt == "int" else f"(-{a[0]})"
    if op == "abs":
        return f"rtk_iabs({a[0]})" if dt == "int" else f"fabsf({a[0]})"
    if op == "~":
        return f"(!{a[0]})" if dt == "bool" else f"(~{a[0]})"
    x, y = a
    if op in ("<", "<=", ">", ">=", "==", "!="):
        return f"({x} {op} {y})"
    if dt == "bool":  # logical & | ^
        return {"&": f"({x} && {y})", "|": f"({x} || {y})",
                "^": f"({x} != {y})"}[op]
    if op in ("&", "|", "^"):
        return f"({x} {op} {y})"
    if dt == "int":
        fn = {"+": "rtk_iadd", "-": "rtk_isub", "*": "rtk_imul",
              "//": "rtk_ifloordiv", "%": "rtk_imod"}[op]
        return f"{fn}({x}, {y})"
    if op == "//":
        return f"rtk_ffloordiv({x}, {y})"
    if op == "%":
        return f"rtk_fmod({x}, {y})"
    return f"({x} {op} {y})"  # float + - * /


def emit_predicate(root: Expr) -> str:
    """The C++ header that defines rtk_filter_pred for `root`."""
    lines, names = [], {}

    def visit(node):
        key = id(node)
        if key in names:
            return names[key]
        if node.op == "field":
            names[key] = node.value
        elif node.op == "const":
            names[key] = _literal(node)
        else:
            args = [visit(x) for x in node.args]
            name = f"e{len(lines)}"
            lines.append(f"  const {_CTYPE[node.dtype]} {name} = "
                         f"{_emit_op(node, args)};")
            names[key] = name
        return names[key]

    result = visit(root)
    params = ", ".join(f"{_CTYPE[dt]} {name}" for name, dt in FIELDS)
    return "\n".join([
        "// rtk_filter_pred: a filter predicate captured by",
        "// rtk_tpu_torch/ops/filter_capture.py::jit_filter.",
        "#pragma once",
        "#define RTK_FILTER_DEFINED 1",
        '#include "filter_ops.h"',
        "",
        f"RTK_HD bool rtk_filter_pred({params}) {{",
        *(f"  (void){name};" for name, _ in FIELDS),
        *lines,
        f"  return {result};",
        "}",
        ""])


class JitFilter:
    """A filter callable with its captured predicate.  Calling it calls
    the original callable (the stack engine and the plain version do);
    the kernel compiles `source`."""

    jittable = True

    def __init__(self, fn, expr: Expr, source: str):
        self.fn = fn
        self.expr = expr
        self.source = source
        self.key = hashlib.sha256(source.encode()).hexdigest()[:16]

    def __call__(self, cand):
        return self.fn(cand)

    def __repr__(self):
        return f"JitFilter({self.fn!r}, key={self.key})"


def symbolic_candidate() -> HitCandidate:
    return HitCandidate(**{name: Expr("field", dt, value=name)
                           for name, dt in FIELDS})


def jit_filter(fn) -> JitFilter:
    """Capture `fn` (HitCandidate -> bool mask) for the CUDA kernel's
    filter variant (rtk_filter_fn intent, rtk.h:117,130).  Raises
    TypeError if `fn` uses anything outside the captured set (module
    docstring); such callables run on the stack engine unmarked."""
    if isinstance(fn, JitFilter):
        return fn
    if not callable(fn):
        raise TypeError("filter_fn must be callable")
    try:
        out = fn(symbolic_candidate())
    except FilterCaptureError:
        raise
    except Exception as e:  # anything fn does with the symbolic fields
        raise FilterCaptureError(
            f"jit_filter could not capture {fn!r}: {type(e).__name__}: {e}"
            + _STACK_HINT) from e
    if isinstance(out, bool):
        out = _const(out)
    if not isinstance(out, Expr) or out.dtype != "bool":
        what = (out.dtype if isinstance(out, Expr)
                else type(out).__name__)
        _refuse(f"a predicate that returns {what}, not a bool mask")
    return JitFilter(fn, out, emit_predicate(out))


# ------------------------------------------------------- stored predicates

_TORCH_OPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
    "<": operator.lt, "<=": operator.le, ">": operator.gt,
    ">=": operator.ge, "==": operator.eq, "!=": operator.ne,
    "&": operator.and_, "|": operator.or_, "^": operator.xor,
    "~": operator.invert, "neg": operator.neg, "abs": abs,
    "where": torch.where,
}
_TORCH_DTYPES = {"bool": torch.bool, "int": torch.int32,
                 "float": torch.float32}


def predicate_nodes(root: Expr) -> list:
    """A captured predicate as JSON-ready data: its nodes in an order where
    each comes after its arguments, each [op, dtype, value, [argument
    positions]], the root last.  A node the predicate uses twice is stored
    once, so predicate_from_nodes emits the same C++ text (and key)."""
    nodes, pos = [], {}

    def visit(node):
        if id(node) not in pos:
            args = [visit(a) for a in node.args]
            nodes.append([node.op, node.dtype, node.value, args])
            pos[id(node)] = len(nodes) - 1
        return pos[id(node)]

    visit(root)
    return nodes


def _evaluate(root: Expr, cand) -> torch.Tensor:
    """The predicate on a HitCandidate of tensors, with torch's own
    operators (the captured casts made explicit)."""
    memo = {}

    def ev(node):
        if id(node) not in memo:
            if node.op == "field":
                out = getattr(cand, node.value)
            elif node.op == "const":
                out = node.value
            elif node.op == "cast":
                out = ev(node.args[0]).to(_TORCH_DTYPES[node.dtype])
            else:
                out = _TORCH_OPS[node.op](*map(ev, node.args))
            memo[id(node)] = out
        return memo[id(node)]

    return ev(root)


def predicate_from_nodes(nodes) -> JitFilter:
    """The JitFilter of predicate_nodes' output: the kernel's filter build
    compiles its C++ text, and calling it evaluates the predicate on
    tensors (the plain version's filter) without the original callable."""
    built = []
    for op, dtype, value, args in nodes:
        if op not in ("field", "const", "cast") and op not in _TORCH_OPS:
            raise ValueError(f"unknown predicate operation {op!r}")
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"unknown predicate dtype {dtype!r}")
        if op == "field" and value not in dict(FIELDS):
            raise ValueError(f"unknown candidate field {value!r}")
        built.append(Expr(op, dtype, tuple(built[a] for a in args), value))
    root = built[-1]
    return JitFilter(lambda cand: _evaluate(root, cand), root,
                     emit_predicate(root))
