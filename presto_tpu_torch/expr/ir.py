"""RowExpression IR.

The reference lowers analyzed AST expressions into a small post-analysis IR
(presto-main/.../sql/relational/RowExpression.java:18 — CallExpression,
InputReferenceExpression, ConstantExpression, SpecialForm,
LambdaDefinitionExpression) which the codegen tier consumes.  This is the
same shape: a tiny, typed, channel-indexed expression tree that the
dual-backend compiler (compile.py) consumes.

Special forms exist exactly where evaluation/null semantics differ from
plain function application (short-circuit AND/OR Kleene logic, conditional
CASE/IF/COALESCE, IN's three-valued membership) — mirroring the reference's
SpecialForm.Form list.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from presto_tpu_torch import types as T


class RowExpression:
    type: T.Type


@dataclasses.dataclass(frozen=True)
class InputRef(RowExpression):
    """Reference to input channel ``index`` (InputReferenceExpression)."""

    index: int
    type: T.Type

    def __str__(self):
        return f"#{self.index}:{self.type.display()}"


@dataclasses.dataclass(frozen=True)
class Constant(RowExpression):
    """A literal in *storage domain* (e.g. decimal as scaled int, date as
    days, varchar as the python string — strings stay host-side)."""

    value: Any  # None == NULL
    type: T.Type

    def __str__(self):
        return f"{self.value!r}:{self.type.display()}"


@dataclasses.dataclass(frozen=True)
class Call(RowExpression):
    """Resolved scalar function application.  ``name`` is the canonical
    function name in the registry; resolution happened already (the
    analyzer/translator picks the overload; fn carries the bound impl)."""

    name: str
    args: Tuple[RowExpression, ...]
    type: T.Type
    fn: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class SpecialForm(RowExpression):
    """AND / OR / IF / SWITCH / COALESCE / IN.

    - AND, OR: Kleene three-valued logic.
    - IF(cond, a, b): lazy per-position selection.
    - SWITCH(default, (cond1, v1), (cond2, v2), ...): CASE WHEN; args laid
      out [default, cond1, v1, cond2, v2, ...].
    - COALESCE(a, b, ...): first non-null.
    - IN(value, c1, c2, ...): three-valued membership.
    """

    form: str
    args: Tuple[RowExpression, ...]
    type: T.Type

    def __str__(self):
        return f"{self.form}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class VarRef(RowExpression):
    """Reference to a lambda parameter (VariableReferenceExpression)."""

    name: str
    type: T.Type

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class LambdaExpr(RowExpression):
    """``(x, y) -> body`` (LambdaDefinitionExpression).

    ``type`` is the body's result type; evaluation happens over the
    flattened element domain of the enclosing array/map function.
    """

    params: Tuple[str, ...]
    param_types: Tuple[T.Type, ...]
    body: RowExpression
    type: T.Type

    def __str__(self):
        return f"({', '.join(self.params)}) -> {self.body}"


def walk(expr: RowExpression):
    """Pre-order traversal."""
    yield expr
    for a in getattr(expr, "args", ()):  # type: ignore[attr-defined]
        yield from walk(a)
    body = getattr(expr, "body", None)
    if body is not None:
        yield from walk(body)


def max_input_channel(expr: RowExpression) -> int:
    mx = -1
    for e in walk(expr):
        if isinstance(e, InputRef):
            mx = max(mx, e.index)
    return mx


def input_channels(expr: RowExpression) -> Tuple[int, ...]:
    seen = []
    for e in walk(expr):
        if isinstance(e, InputRef) and e.index not in seen:
            seen.append(e.index)
    return tuple(sorted(seen))
