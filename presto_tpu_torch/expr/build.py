"""Typed RowExpression builders.

The reference builds RowExpressions in SqlToRowExpressionTranslator
(presto-main/.../sql/relational/SqlToRowExpressionTranslator.java:122),
resolving overloads against the FunctionRegistry and inserting coercions.
These helpers do the same for planner/test code.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr.ir import Call, Constant, InputRef, RowExpression, SpecialForm


def ref(index: int, typ: T.Type) -> InputRef:
    return InputRef(index, typ)


def const(value: Any, typ: T.Type) -> Constant:
    """Literal from a *Python-domain* value (converted to storage domain)."""
    if value is None:
        return Constant(None, typ)
    if typ.is_dictionary:
        return Constant(str(value), typ)
    return Constant(typ.from_python(value), typ)


def null(typ: T.Type) -> Constant:
    return Constant(None, typ)


def call(name: str, *args: RowExpression) -> Call:
    fn = F.resolve_scalar(name, [a.type for a in args])
    return Call(name, tuple(args), fn.result_type, fn)


def cast(expr: RowExpression, to: T.Type) -> RowExpression:
    if expr.type == to:
        return expr
    fn = F.resolve_cast(expr.type, to)
    return Call("cast", (expr,), to, fn)


def round_digits(expr: RowExpression, digits: int) -> Call:
    fn = F.resolve_round(expr.type, digits)
    return Call("round", (expr,), fn.result_type, fn)


def and_(*exprs: RowExpression) -> RowExpression:
    exprs = tuple(e for e in exprs if e is not None)
    if not exprs:
        return const(True, T.BOOLEAN)
    out = exprs[0]
    for e in exprs[1:]:
        out = SpecialForm("AND", (out, e), T.BOOLEAN)
    return out


def or_(*exprs: RowExpression) -> RowExpression:
    out = exprs[0]
    for e in exprs[1:]:
        out = SpecialForm("OR", (out, e), T.BOOLEAN)
    return out


def not_(expr: RowExpression) -> Call:
    return call("not", expr)


def if_(cond: RowExpression, then: RowExpression,
        other: Optional[RowExpression] = None) -> SpecialForm:
    if other is None:
        other = null(then.type)
    t = T.common_super_type(then.type, other.type) or then.type
    return SpecialForm("IF", (cond, cast(then, t), cast(other, t)), t)


def coalesce(*exprs: RowExpression) -> SpecialForm:
    t = exprs[0].type
    for e in exprs[1:]:
        t = T.common_super_type(t, e.type) or t
    return SpecialForm("COALESCE", tuple(cast(e, t) for e in exprs), t)


def in_(value: RowExpression, items: Sequence[RowExpression]) -> SpecialForm:
    if not T.is_string(value.type):
        t = value.type
        for i in items:
            t = T.common_super_type(t, i.type) or t
        value = cast(value, t)
        items = [cast(i, t) for i in items]
    return SpecialForm("IN", (value, *items), T.BOOLEAN)


def between(value: RowExpression, lo: RowExpression,
            hi: RowExpression) -> RowExpression:
    return and_(call("ge", value, lo), call("le", value, hi))


def comparison(op: str, left: RowExpression, right: RowExpression) -> Call:
    name = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
            ">": "gt", ">=": "ge"}[op]
    # an untyped NULL side takes the other side's type (the analyzer's
    # unknown-coercion rule); the comparison then yields NULL rows
    if left.type == T.UNKNOWN and right.type != T.UNKNOWN:
        left = cast(left, right.type)
    elif right.type == T.UNKNOWN and left.type != T.UNKNOWN:
        right = cast(right, left.type)
    return call(name, left, right)


def case_when(pairs, default: Optional[RowExpression],
              result_type: Optional[T.Type] = None) -> SpecialForm:
    """pairs: [(cond, value), ...]; searched CASE."""
    t = result_type
    if t is None:
        t = pairs[0][1].type
        for _, v in pairs[1:]:
            t = T.common_super_type(t, v.type) or t
        if default is not None:
            t = T.common_super_type(t, default.type) or t
    default = cast(default, t) if default is not None else null(t)
    args = [default]
    for cond, v in pairs:
        args.append(cond)
        args.append(cast(v, t))
    return SpecialForm("SWITCH", tuple(args), t)
