"""Analyzer + logical planner: AST -> PlanNode tree.

Combines the roles of the reference's StatementAnalyzer (scopes, name
resolution, type checking — presto-main/.../sql/analyzer/StatementAnalyzer
.java:243), SqlToRowExpressionTranslator (sql/relational/
SqlToRowExpressionTranslator.java:122) and LogicalPlanner/QueryPlanner/
SubqueryPlanner (sql/planner/LogicalPlanner.java:176, QueryPlanner.java:97,
SubqueryPlanner.java:71) into one bottom-up pass.  Subquery handling
mirrors the reference's decorrelation rules: uncorrelated IN -> semi join,
correlated EXISTS -> semi/anti join on the correlation equalities (residual
kept on the join), correlated scalar aggregate -> group-by on the
correlation keys + inner join (TransformCorrelated* rules).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.api import Connector, ConnectorRegistry
from presto_tpu_torch.expr import build as B
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr.functions import (
    FunctionError, resolve_aggregate, resolve_scalar,
)
from presto_tpu_torch.expr.ir import Call, Constant, InputRef, RowExpression, SpecialForm
from presto_tpu_torch.sql import tree as t
from presto_tpu_torch.sql.plan import (
    AggregationNode, EnforceSingleRowNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanAggregate, PlanNode, PlanWindowFunction, ProjectNode,
    SemiJoinNode, SortNode, TableScanNode, UnionNode, UnnestNode, ValuesNode,
    WindowNode, unnest_output_types,
)

AGG_NAMES = {"count", "sum", "avg", "min", "max", "stddev", "stddev_samp",
             "stddev_pop", "variance", "var_samp", "var_pop", "any_value",
             "arbitrary", "bool_and", "bool_or", "every", "count_if",
             "array_agg", "map_agg", "min_by", "max_by", "approx_distinct",
             "approx_percentile", "corr", "covar_samp", "covar_pop",
             "regr_slope", "regr_intercept", "geometric_mean", "checksum",
             "learn_classifier", "learn_regressor"}


class SqlAnalysisError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    qualifier: Optional[str]
    type: T.Type


class Scope:
    def __init__(self, fields: Sequence[Field],
                 parent: Optional["Scope"] = None):
        self.fields = list(fields)
        self.parent = parent

    def try_resolve(self, parts: Tuple[str, ...]) -> Optional[int]:
        """Channel index in THIS scope only (no parent chain)."""
        if len(parts) == 1:
            hits = [i for i, f in enumerate(self.fields)
                    if f.name == parts[0]]
        elif len(parts) == 2:
            hits = [i for i, f in enumerate(self.fields)
                    if f.name == parts[1] and f.qualifier == parts[0]]
        else:
            return None
        if len(hits) > 1:
            raise SqlAnalysisError(f"column {'.'.join(parts)} is ambiguous")
        return hits[0] if hits else None

    def resolves_locally(self, expr: t.Expression) -> Optional[bool]:
        """True if every identifier in expr resolves here, False if every
        one resolves only in the parent chain, None if mixed/unresolved."""
        local = outer = 0
        for ident in _identifiers(expr):
            if self.try_resolve(ident.parts) is not None:
                local += 1
            elif self.parent is not None and _chain_resolves(self.parent,
                                                            ident.parts):
                outer += 1
            else:
                raise SqlAnalysisError(
                    f"column {ident} cannot be resolved")
        if outer == 0:
            return True
        if local == 0:
            return False
        return None


def _chain_resolves(scope: Scope, parts) -> bool:
    s: Optional[Scope] = scope
    while s is not None:
        if s.try_resolve(parts) is not None:
            return True
        s = s.parent
    return False


def _identifiers(expr: t.Node):
    """All Identifier leaves (not descending into subqueries)."""
    if isinstance(expr, t.Identifier):
        yield expr
        return
    if isinstance(expr, (t.InSubquery, t.Exists, t.ScalarSubquery)):
        if isinstance(expr, t.InSubquery):
            yield from _identifiers(expr.expr)
        return
    for f in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, f)
        if isinstance(v, t.Node):
            yield from _identifiers(v)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, t.Node):
                    yield from _identifiers(item)
                elif (isinstance(item, tuple) and len(item) == 2
                        and isinstance(item[0], t.Node)):
                    yield from _identifiers(item[0])
                    yield from _identifiers(item[1])


def _rewrite_identifiers(expr, fn):
    """Structurally rewrite Identifier leaves via ``fn`` (not descending
    into subqueries, whose identifiers live in their own scopes)."""
    if isinstance(expr, t.Identifier):
        return fn(expr)
    if isinstance(expr, (t.InSubquery, t.Exists, t.ScalarSubquery)) \
            or not hasattr(expr, "__dataclass_fields__"):
        return expr
    changes = {}
    for f in expr.__dataclass_fields__:
        v = getattr(expr, f)
        if isinstance(v, t.Node):
            nv = _rewrite_identifiers(v, fn)
            if nv is not v:
                changes[f] = nv
        elif isinstance(v, tuple):
            items = []
            changed = False
            for item in v:
                if isinstance(item, t.Node):
                    ni = _rewrite_identifiers(item, fn)
                    changed |= ni is not item
                    items.append(ni)
                elif isinstance(item, tuple):
                    ni = tuple(_rewrite_identifiers(s, fn)
                               if isinstance(s, t.Node) else s
                               for s in item)
                    changed |= ni != item
                    items.append(ni)
                else:
                    items.append(item)
            if changed:
                changes[f] = tuple(items)
    return dataclasses.replace(expr, **changes) if changes else expr


def _substitute_select_aliases(expr: t.Expression, q: t.Query):
    """Replace single-part identifiers naming a select-list alias with
    that item's expression (one shot, no re-substitution) — the
    StatementAnalyzer ORDER-BY-scope rule that makes aliases usable
    inside ORDER BY expressions."""
    aliases = {item.alias: item.expr for item in q.select
               if item.alias is not None
               and not isinstance(item.expr, t.Star)}

    def fn(ident: t.Identifier):
        if len(ident.parts) == 1 and ident.parts[0] in aliases:
            return aliases[ident.parts[0]]
        return ident

    return _rewrite_identifiers(expr, fn)


def _contains_subquery(expr: t.Node) -> bool:
    if isinstance(expr, (t.InSubquery, t.Exists, t.ScalarSubquery)):
        return True
    for f in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, f)
        if isinstance(v, t.Node) and _contains_subquery(v):
            return True
        if isinstance(v, tuple):
            for item in v:
                if isinstance(item, t.Node) and _contains_subquery(item):
                    return True
                if isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, t.Node) and _contains_subquery(sub):
                            return True
    return False


def _contains_aggregate(expr: t.Node) -> bool:
    if (isinstance(expr, t.FunctionCall) and expr.name in AGG_NAMES
            and expr.window is None):
        return True
    if isinstance(expr, (t.InSubquery, t.Exists, t.ScalarSubquery)):
        return False
    for f in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, f)
        if isinstance(v, t.Node) and _contains_aggregate(v):
            return True
        if isinstance(v, tuple):
            for item in v:
                if isinstance(item, t.Node) and _contains_aggregate(item):
                    return True
                if isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, t.Node) and _contains_aggregate(sub):
                            return True
    return False


def split_conjuncts(expr: Optional[t.Expression]) -> List[t.Expression]:
    if expr is None:
        return []
    if isinstance(expr, t.LogicalBinary) and expr.op == "and":
        return split_conjuncts(expr.left) + split_conjuncts(expr.right)
    return [expr]


def _split_disjuncts(expr: t.Expression) -> List[t.Expression]:
    if isinstance(expr, t.LogicalBinary) and expr.op == "or":
        return _split_disjuncts(expr.left) + _split_disjuncts(expr.right)
    return [expr]


def _and_asts(parts: List[t.Expression]) -> t.Expression:
    out = parts[0]
    for p in parts[1:]:
        out = t.LogicalBinary("and", out, p)
    return out


def _or_asts(parts: List[t.Expression]) -> t.Expression:
    out = parts[0]
    for p in parts[1:]:
        out = t.LogicalBinary("or", out, p)
    return out


def factor_common_disjunct_conjuncts(expr: t.Expression) -> t.Expression:
    """(A AND X) OR (A AND Y) -> A AND (X OR Y): conjuncts shared (by AST
    equality) between every disjunct hoist to the top AND level — the
    ExtractCommonPredicatesExpressionRewriter role
    (presto-main/.../sql/planner/iterative/rule/
    ExtractCommonPredicatesExpressionRewriter.java).  TPC-DS q41's
    correlation is only extractable after this factoring."""
    disjuncts = _split_disjuncts(expr)
    if len(disjuncts) < 2:
        return expr
    per = [split_conjuncts(d) for d in disjuncts]
    # dedupe: (A AND A AND X) repeats A in per[0]; keeping both would
    # double-remove below (historically a ValueError on rest.remove)
    common: List[t.Expression] = []
    for c in per[0]:
        if any(c == seen for seen in common):
            continue
        if all(any(c == o for o in others) for others in per[1:]):
            common.append(c)
    if not common:
        return expr
    rests = []
    for conj in per:
        # drop EVERY occurrence of each common conjunct (A AND A == A)
        rest = [c for c in conj
                if not any(c == h for h in common)]
        if not rest:        # a disjunct reduced to TRUE: OR collapses
            return _and_asts(common)
        rests.append(_and_asts(rest))
    return _and_asts(common + [_or_asts(rests)])


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------

class Metadata:
    """Catalog facade (Metadata.java:66 role)."""

    def __init__(self, registry: ConnectorRegistry, default_catalog: str):
        self.registry = registry
        self.default_catalog = default_catalog

    def split_name(self, parts: Tuple[str, ...]) -> Tuple[str, str]:
        if len(parts) == 1:
            return self.default_catalog, parts[0]
        if len(parts) == 2:
            return parts[0], parts[1]
        return parts[0], parts[-1]  # catalog.schema.table

    def resolve_table(self, parts: Tuple[str, ...]):
        catalog, table = self.split_name(parts)
        conn = self.registry.get(catalog)
        handle = conn.get_table(table)
        if handle is None:
            raise SqlAnalysisError(f"table {'.'.join(parts)} does not exist")
        schema = conn.table_schema(handle)
        return catalog, table, conn, schema

    # -- views (ConnectorMetadata.getView / StatementAnalyzer view
    #    expansion role) ----------------------------------------------------
    def get_view(self, parts: Tuple[str, ...]) -> Optional[str]:
        return self.registry.views.get(self.split_name(parts))

    def create_view(self, parts: Tuple[str, ...], sql: str,
                    replace: bool) -> None:
        key = self.split_name(parts)
        if not replace and key in self.registry.views:
            raise SqlAnalysisError(f"view {'.'.join(key)} already exists")
        self.registry.views[key] = sql

    def drop_view(self, parts: Tuple[str, ...], if_exists: bool) -> None:
        key = self.split_name(parts)
        if key not in self.registry.views:
            if if_exists:
                return
            raise SqlAnalysisError(f"view {'.'.join(key)} does not exist")
        del self.registry.views[key]


# ---------------------------------------------------------------------------
# Expression translation
# ---------------------------------------------------------------------------

class Translator:
    """AST expression -> RowExpression over a scope's channels."""

    def __init__(self, scope: Scope,
                 grouped: Optional["GroupingContext"] = None,
                 windows: Optional[Dict[t.Expression, RowExpression]] = None,
                 subquery_refs: Optional[Dict[int, RowExpression]] = None):
        self.scope = scope
        self.grouped = grouped
        self.windows = windows
        # id(AST subquery node) -> hoisted RowExpression: subqueries the
        # planner has already attached as channels (apply/decorrelation)
        self.subquery_refs = subquery_refs
        self.lambda_env: Dict[str, T.Type] = {}  # lambda params in scope

    def translate(self, expr: t.Expression) -> RowExpression:
        if self.subquery_refs is not None:
            hit = self.subquery_refs.get(id(expr))
            if hit is not None:
                return hit
        if self.windows is not None:
            hit = self.windows.get(expr)
            if hit is not None:
                return hit
        if isinstance(expr, t.FunctionCall) and expr.window is not None:
            raise SqlAnalysisError(
                f"window function {expr.name} in an unsupported position")
        if self.grouped is not None:
            hit = self.grouped.lookup(expr)
            if hit is not None:
                return hit
            if isinstance(expr, t.FunctionCall) \
                    and expr.name == "grouping":
                return self._translate_grouping(expr)
            if isinstance(expr, t.FunctionCall) and expr.name in AGG_NAMES:
                raise SqlAnalysisError(
                    f"aggregate {expr.name} not found in grouping context")
        return self._translate(expr)

    def _translate_grouping(self, expr: t.FunctionCall) -> RowExpression:
        """grouping(c1, ..) -> bitmask (1 = aggregated away), from the
        grouping-sets $grouping_id channel (GroupIdOperator's groupId)."""
        positions = []
        for arg in expr.args:
            pos = None
            for i, g in enumerate(self.grouped.group_asts):
                if g == arg:
                    pos = i
                    break
            if pos is None:
                raise SqlAnalysisError(
                    "grouping() argument must be a grouping column")
            positions.append(pos)
        gch = self.grouped.grouping_id_channel
        if gch is None:
            return B.const(0, T.BIGINT)   # plain GROUP BY: all grouped
        gid = B.ref(gch, T.BIGINT)
        n = len(positions)
        out: RowExpression = B.const(0, T.BIGINT)
        for j, pos in enumerate(positions):
            bit = B.call("mod",
                         B.call("divide", gid,
                                B.const(1 << pos, T.BIGINT)),
                         B.const(2, T.BIGINT))
            term = (bit if n - 1 - j == 0 else
                    B.call("multiply", bit,
                           B.const(1 << (n - 1 - j), T.BIGINT)))
            out = B.call("add", out, term)
        return out

    def _translate(self, e: t.Expression) -> RowExpression:
        if isinstance(e, t.Identifier):
            if len(e.parts) == 1 and e.parts[0] in self.lambda_env:
                from presto_tpu_torch.expr.ir import VarRef

                return VarRef(e.parts[0], self.lambda_env[e.parts[0]])
            if len(e.parts) == 1 and e.parts[0] in (
                    "current_date", "current_timestamp", "localtimestamp"):
                # fixed at query (translation) start, Presto semantics
                import time as _time

                now_us = int(_time.time() * 1e6)
                if e.parts[0] == "current_date":
                    return B.const(now_us // 86_400_000_000, T.DATE)
                return B.const(now_us, T.TIMESTAMP)
            idx = self.scope.try_resolve(e.parts)
            if idx is None:
                # row-field access spelled as a qualified name: resolve the
                # longest prefix as a column, the rest as ROW fields
                rf = self._try_row_fields(e.parts)
                if rf is not None:
                    return rf
                if self.grouped is not None:
                    raise SqlAnalysisError(
                        f"column {e} must appear in GROUP BY or inside an "
                        "aggregate")
                raise SqlAnalysisError(f"column {e} cannot be resolved")
            return B.ref(idx, self.scope.fields[idx].type)
        if isinstance(e, t.NumberLiteral):
            return _number_literal(e.text)
        if isinstance(e, t.StringLiteral):
            return B.const(e.value, T.VARCHAR)
        if isinstance(e, t.BooleanLiteral):
            return B.const(e.value, T.BOOLEAN)
        if isinstance(e, t.NullLiteral):
            return B.null(T.UNKNOWN)
        if isinstance(e, t.TypedLiteral):
            if e.type_name == "decimal":
                # DECIMAL '1.2': precision/scale inferred from the text
                # (DecimalParseResult role)
                txt = e.value.strip().lstrip("+-")
                digits = txt.replace(".", "")
                scale = len(txt.split(".")[1]) if "." in txt else 0
                typ: T.Type = T.DecimalType(
                    "decimal", precision=max(len(digits), 1), scale=scale)
            else:
                typ = T.parse_type(e.type_name)
            return B.const(e.value, typ)
        if isinstance(e, t.IntervalLiteral):
            raise SqlAnalysisError(
                "interval literal outside +/- date arithmetic")
        if isinstance(e, t.ArithmeticBinary):
            return self._arithmetic(e)
        if isinstance(e, t.ArithmeticUnary):
            arg = self.translate(e.expr)
            if isinstance(arg, Constant) and arg.value is not None:
                return B.const(-arg.value, arg.type)
            return B.call("negate", arg)
        if isinstance(e, t.Comparison):
            return B.comparison(e.op, self.translate(e.left),
                                self.translate(e.right))
        if isinstance(e, t.Between):
            v = self.translate(e.expr)
            out = B.between(v, self.translate(e.low), self.translate(e.high))
            return B.not_(out) if e.negated else out
        if isinstance(e, t.InList):
            v = self.translate(e.expr)
            out = B.in_(v, [self.translate(i) for i in e.items])
            return B.not_(out) if e.negated else out
        if isinstance(e, t.Like):
            v = self.translate(e.expr)
            pat = self.translate(e.pattern)
            args = (v, pat)
            if e.escape is not None:
                args = args + (self.translate(e.escape),)
            out = B.call("like", *args)
            return B.not_(out) if e.negated else out
        if isinstance(e, t.IsNull):
            v = self.translate(e.expr)
            name = "is_not_null" if e.negated else "is_null"
            return B.call(name, v)
        if isinstance(e, t.Not):
            return B.not_(self.translate(e.expr))
        if isinstance(e, t.LogicalBinary):
            fn = B.and_ if e.op == "and" else B.or_
            return fn(self.translate(e.left), self.translate(e.right))
        if isinstance(e, t.Case):
            whens = []
            for cond, val in e.whens:
                if e.operand is not None:
                    c = B.comparison("=", self.translate(e.operand),
                                     self.translate(cond))
                else:
                    c = self.translate(cond)
                whens.append((c, self.translate(val)))
            default = (self.translate(e.default)
                       if e.default is not None else None)
            # unify result types (numeric widening)
            rtype = _common_type(
                [v.type for _, v in whens]
                + ([default.type] if default is not None else []))
            whens = [(c, _coerce(v, rtype)) for c, v in whens]
            if default is not None:
                default = _coerce(default, rtype)
            return B.case_when(whens, default, rtype)
        if isinstance(e, t.Coalesce):
            args = [self.translate(a) for a in e.args]
            rtype = _common_type([a.type for a in args])
            return B.coalesce(*[_coerce(a, rtype) for a in args])
        if isinstance(e, t.NullIf):
            first = self.translate(e.first)
            second = self.translate(e.second)
            cond = B.comparison("=", first, second)
            return B.case_when([(cond, B.null(first.type))], first,
                               first.type)
        if isinstance(e, t.Cast):
            return B.cast(self.translate(e.expr), T.parse_type(e.type_name))
        if isinstance(e, t.TryCast):
            arg = self.translate(e.expr)
            to = T.parse_type(e.type_name)
            if arg.type == to or isinstance(arg.type, T.UnknownType):
                return B.cast(arg, to)
            fn = F.resolve_try_cast(arg.type, to)
            return Call("try_cast", (arg,), to, fn)
        if isinstance(e, t.Extract):
            return B.call(f"extract_{e.field.lower()}",
                          self.translate(e.expr))
        if isinstance(e, t.FunctionCall):
            if e.name in AGG_NAMES:
                raise SqlAnalysisError(
                    f"aggregate {e.name} used outside aggregation context")
            return self._function_call(e)
        if isinstance(e, t.ArrayConstructor):
            items = [self.translate(i) for i in e.items]
            et = _common_type([i.type for i in items]) if items else T.UNKNOWN
            items = [_coerce(i, et) for i in items]
            rt = T.ArrayType("array", element=et)
            fn = F.resolve_array_constructor(rt, len(items))
            return Call("$array", tuple(items), rt, fn)
        if isinstance(e, t.Subscript):
            base = self.translate(e.base)
            if isinstance(base.type, T.RowType):
                idx = self.translate(e.index)
                if not isinstance(idx, Constant):
                    raise SqlAnalysisError("row subscript must be constant")
                i = int(idx.value) - 1
                fn = F.resolve_row_field_index(base.type, i)
                return Call("row_field", (base,), fn.result_type, fn)
            idx = self.translate(e.index)
            if isinstance(base.type, T.MapType):
                idx = _coerce(idx, base.type.key)
            fn = F.resolve_scalar("subscript", [base.type, idx.type])
            return Call("subscript", (base, idx), fn.result_type, fn)
        if isinstance(e, t.Deref):
            base = self.translate(e.base)
            if not isinstance(base.type, T.RowType):
                raise SqlAnalysisError(
                    f"cannot dereference {base.type.display()}")
            fn, _ = F.resolve_row_field(base.type, e.field)
            return Call("row_field", (base,), fn.result_type, fn)
        if isinstance(e, t.Lambda):
            raise SqlAnalysisError(
                "lambda expression outside a higher-order function")
        raise SqlAnalysisError(
            f"unsupported expression {type(e).__name__}")

    def _try_row_fields(self, parts) -> Optional[RowExpression]:
        for k in range(len(parts) - 1, 0, -1):
            idx = self.scope.try_resolve(parts[:k])
            if idx is None:
                continue
            expr: RowExpression = B.ref(idx, self.scope.fields[idx].type)
            ok = True
            for field in parts[k:]:
                if not isinstance(expr.type, T.RowType):
                    ok = False
                    break
                try:
                    fn, _ = F.resolve_row_field(expr.type, field)
                except F.FunctionError:
                    ok = False
                    break
                expr = Call("row_field", (expr,), fn.result_type, fn)
            if ok:
                return expr
        return None

    def _translate_lambda(self, lam: t.Lambda,
                          param_types: List[T.Type]):
        from presto_tpu_torch.expr.ir import LambdaExpr

        if len(lam.params) != len(param_types):
            raise SqlAnalysisError(
                f"lambda takes {len(lam.params)} parameters, expected "
                f"{len(param_types)}")
        saved = dict(self.lambda_env)
        self.lambda_env.update(zip(lam.params, param_types))
        try:
            body = self.translate(lam.body)
        finally:
            self.lambda_env = saved
        return LambdaExpr(tuple(lam.params), tuple(param_types), body,
                          body.type)

    _CONST_FNS = {"pi": 3.141592653589793, "e": 2.718281828459045,
                  "nan": float("nan"), "infinity": float("inf")}

    def _function_call(self, e: t.FunctionCall) -> RowExpression:
        name = e.name.lower()
        if any(isinstance(a, t.Lambda) for a in e.args):
            return self._higher_order_call(name, e)
        if name in self._CONST_FNS and not e.args:
            return B.const(self._CONST_FNS[name], T.DOUBLE)
        if name in ("now", "current_timestamp") and not e.args:
            import time as _time

            return B.const(int(_time.time() * 1e6), T.TIMESTAMP)
        if name == "current_date" and not e.args:
            import time as _time

            return B.const(int(_time.time()) // 86_400, T.DATE)
        if name == "typeof" and len(e.args) == 1:
            return B.const(self.translate(e.args[0]).type.display(),
                           T.VARCHAR)
        if name == "if" and len(e.args) in (2, 3):
            cond = self.translate(e.args[0])
            then = self.translate(e.args[1])
            els = self.translate(e.args[2]) if len(e.args) == 3 else None
            rtype = _common_type([then.type]
                                 + ([els.type] if els is not None else []))
            then = _coerce(then, rtype)
            if els is not None:
                els = _coerce(els, rtype)
            return B.case_when([(cond, then)], els, rtype)
        if name == "round" and len(e.args) == 2:
            digits = self.translate(e.args[1])
            if not isinstance(digits, Constant):
                raise SqlAnalysisError("round(x, d) requires constant d")
            return B.round_digits(self.translate(e.args[0]),
                                  int(digits.value))
        if name in ("date_format", "format_datetime") and len(e.args) == 2:
            x = self.translate(e.args[0])
            fmt = self.translate(e.args[1])
            if not (isinstance(fmt, Constant)
                    and isinstance(fmt.value, str)):
                raise SqlAnalysisError(
                    f"{name} format must be a constant string")
            resolver = (F.resolve_date_format if name == "date_format"
                        else F.resolve_format_datetime)
            fn = resolver(x.type, fmt.value)
            return Call(name, (x, fmt), fn.result_type, fn)
        if name in ("date_trunc", "date_add", "date_diff") and e.args:
            unit_rex = self.translate(e.args[0])
            if not (isinstance(unit_rex, Constant)
                    and isinstance(unit_rex.value, str)):
                raise SqlAnalysisError(f"{name} unit must be a constant "
                                       "string")
            unit = unit_rex.value.lower()
            if name == "date_trunc":
                return B.call(f"date_trunc_{unit}",
                              self.translate(e.args[1]))
            if name == "date_diff":
                return B.call(f"date_diff_{unit}",
                              self.translate(e.args[1]),
                              self.translate(e.args[2]))
            # date_add(unit, value, x)
            n = self.translate(e.args[1])
            x = self.translate(e.args[2])
            if unit == "day":
                return B.call("add_days", x, n)
            if unit == "week":
                return B.call("add_days", x,
                              B.call("multiply", n, B.const(7, T.INTEGER)))
            if unit == "month":
                return B.call("add_months", x, n)
            if unit == "quarter":
                return B.call("add_months", x,
                              B.call("multiply", n, B.const(3, T.INTEGER)))
            if unit == "year":
                return B.call("add_months", x,
                              B.call("multiply", n, B.const(12, T.INTEGER)))
            if x.type.name == "timestamp":
                scale = {"hour": 3_600_000_000, "minute": 60_000_000,
                         "second": 1_000_000, "millisecond": 1_000}[unit]
                return B.call("add", x, B.call(
                    "multiply", B.cast(n, T.BIGINT),
                    B.const(scale, T.BIGINT)))
            raise SqlAnalysisError(f"date_add unit {unit!r} on "
                                   f"{x.type.display()}")
        return B.call(name, *[self.translate(a) for a in e.args])

    def _higher_order_call(self, name: str,
                           e: t.FunctionCall) -> RowExpression:
        """Lambda-taking array/map functions (the reference's
        LambdaDefinitionExpression call sites)."""
        from presto_tpu_torch.expr.ir import LambdaExpr

        first = self.translate(e.args[0])
        ft = first.type
        if name in ("transform", "filter", "any_match", "all_match",
                    "none_match"):
            if not isinstance(ft, T.ArrayType):
                raise SqlAnalysisError(f"{name} expects an array")
            lam = self._translate_lambda(e.args[1], [ft.element])
            fn = resolve_scalar(name, [ft, lam.type])
            return Call(name, (first, lam), fn.result_type, fn)
        if name in ("map_filter", "transform_values", "transform_keys"):
            if not isinstance(ft, T.MapType):
                raise SqlAnalysisError(f"{name} expects a map")
            lam = self._translate_lambda(e.args[1], [ft.key, ft.value])
            fn = resolve_scalar(name, [ft, lam.type])
            return Call(name, (first, lam), fn.result_type, fn)
        if name == "zip_with":
            if not isinstance(ft, T.ArrayType) or len(e.args) != 3:
                raise SqlAnalysisError("zip_with(a, b, (x, y) -> ...)")
            second = self.translate(e.args[1])
            if not isinstance(second.type, T.ArrayType):
                raise SqlAnalysisError("zip_with expects two arrays")
            lam = self._translate_lambda(
                e.args[2], [ft.element, second.type.element])
            fn = resolve_scalar("zip_with", [ft, second.type, lam.type])
            return Call("zip_with", (first, second, lam),
                        fn.result_type, fn)
        if name == "reduce":
            if not isinstance(ft, T.ArrayType) or len(e.args) != 4:
                raise SqlAnalysisError(
                    "reduce(array, init, (s, x) -> ..., s -> ...)")
            init = self.translate(e.args[1])
            state_t = init.type
            comb = self._translate_lambda(e.args[2], [state_t, ft.element])
            if comb.type != state_t:
                body = _coerce(comb.body, state_t)
                comb = LambdaExpr(comb.params, comb.param_types, body,
                                  state_t)
            fin = self._translate_lambda(e.args[3], [state_t])
            fn = resolve_scalar(
                "reduce", [ft, state_t, comb.type, fin.type])
            return Call("reduce", (first, init, comb, fin),
                        fn.result_type, fn)
        raise SqlAnalysisError(f"{name} does not take a lambda")

    def _arithmetic(self, e: t.ArithmeticBinary) -> RowExpression:
        # date +/- interval folds into add_days/add_months with constant
        op_name = {"+": "add", "-": "subtract", "*": "multiply",
                   "/": "divide", "%": "modulus"}[e.op]
        if isinstance(e.right, t.IntervalLiteral) and e.op in "+-":
            base = self.translate(e.left)
            return _date_interval(base, e.right, negate=(e.op == "-"))
        if isinstance(e.left, t.IntervalLiteral) and e.op == "+":
            base = self.translate(e.right)
            return _date_interval(base, e.left, negate=False)
        return B.call(op_name, self.translate(e.left),
                      self.translate(e.right))


def _date_interval(base: RowExpression, iv: t.IntervalLiteral,
                   negate: bool) -> RowExpression:
    n = int(iv.value) * iv.sign * (-1 if negate else 1)
    if iv.unit == "year":
        return B.call("add_months", base, B.const(12 * n, T.INTEGER))
    if iv.unit == "month":
        return B.call("add_months", base, B.const(n, T.INTEGER))
    if iv.unit == "day":
        return B.call("add_days", base, B.const(n, T.INTEGER))
    if base.type.name == "timestamp":
        scale = {"hour": 3_600_000_000, "minute": 60_000_000,
                 "second": 1_000_000}[iv.unit]
        return B.call("add", base, B.const(n * scale, T.BIGINT))
    raise SqlAnalysisError(f"interval unit {iv.unit} on {base.type.name}")


def _number_literal(text: str) -> Constant:
    if "." in text or "e" in text.lower():
        return B.const(float(text), T.DOUBLE)
    v = int(text)
    if -(2 ** 31) <= v < 2 ** 31:
        return B.const(v, T.INTEGER)
    return B.const(v, T.BIGINT)


_NUM_ORDER = ["tinyint", "smallint", "integer", "bigint", "real", "double"]


def _common_type(types: List[T.Type]) -> T.Type:
    known = [x for x in types if not isinstance(x, T.UnknownType)]
    if not known:
        return T.UNKNOWN
    out = known[0]
    for x in known[1:]:
        if x == out:
            continue
        if x.name in _NUM_ORDER and out.name in _NUM_ORDER:
            out = x if (_NUM_ORDER.index(x.name)
                        > _NUM_ORDER.index(out.name)) else out
        elif T.is_string(x) and T.is_string(out):
            out = T.VARCHAR
        elif isinstance(x, T.DecimalType) or isinstance(out, T.DecimalType):
            out = T.DOUBLE if (x.name in _NUM_ORDER
                               or out.name in _NUM_ORDER) else out
        else:
            cs = T.common_super_type(out, x)
            if cs is None:
                raise SqlAnalysisError(
                    f"mismatched types {out.display()} vs {x.display()}")
            out = cs
    return out


def _coerce(expr: RowExpression, typ: T.Type) -> RowExpression:
    if expr.type == typ or isinstance(expr.type, T.UnknownType):
        return expr
    return B.cast(expr, typ)


# ---------------------------------------------------------------------------
# Grouping context
# ---------------------------------------------------------------------------

class GroupingContext:
    """Maps group-by ASTs and aggregate-call ASTs to agg-output channels."""

    def __init__(self, group_asts: List[t.Expression],
                 agg_asts: List[t.FunctionCall],
                 out_fields: List[Field],
                 grouping_id_channel: Optional[int] = None):
        self.group_asts = group_asts
        self.agg_asts = agg_asts
        self.out_fields = out_fields
        # GROUPING SETS only: channel of the per-branch grouping-id
        # bitmask (bit i set = key i aggregated away in this row)
        self.grouping_id_channel = grouping_id_channel

    def lookup(self, expr: t.Expression) -> Optional[RowExpression]:
        for i, g in enumerate(self.group_asts):
            if expr == g:
                return B.ref(i, self.out_fields[i].type)
        base = len(self.group_asts)
        for j, a in enumerate(self.agg_asts):
            if expr == a:
                return B.ref(base + j, self.out_fields[base + j].type)
        return None


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RelationPlan:
    node: PlanNode
    scope: Scope


class Planner:
    """One instance per statement (LogicalPlanner.java:176 role)."""

    def __init__(self, metadata: Metadata):
        self.metadata = metadata
        self.ctes: List[Dict[str, t.Query]] = []

    # --- entry -------------------------------------------------------------
    def plan(self, query: t.Query) -> OutputNode:
        rel = self.plan_query(query, None)
        cols = tuple((f.name, f.type) for f in rel.scope.fields)
        return OutputNode(rel.node, cols)

    # --- query -------------------------------------------------------------
    def plan_query(self, q: t.Node, outer: Optional[Scope]) -> RelationPlan:
        if q.with_queries:
            self.ctes.append(dict(q.with_queries))
        try:
            if isinstance(q, t.SetOperation):
                return self._plan_set_operation(q, outer)
            return self._plan_query_body(q, outer)
        finally:
            if q.with_queries:
                self.ctes.pop()

    def _plan_set_operation(self, q: t.SetOperation,
                            outer: Optional[Scope]) -> RelationPlan:
        """UNION [ALL] / INTERSECT / EXCEPT.  Branch outputs are coerced to
        common types; DISTINCT semantics via aggregation over all channels;
        INTERSECT/EXCEPT via (anti-)semijoin over distinct branches —
        the same shapes the reference's SetOperationNodes lower to.
        Like the reference (Presto 328), INTERSECT ALL / EXCEPT ALL are
        not supported."""
        left = self.plan_query(q.left, outer)
        right = self.plan_query(q.right, outer)
        ltypes = [f.type for f in left.scope.fields]
        rtypes = [f.type for f in right.scope.fields]
        if len(ltypes) != len(rtypes):
            raise SqlAnalysisError(
                f"{q.op} branches have {len(ltypes)} vs {len(rtypes)} "
                "columns")
        common = [_common_type([a, b]) for a, b in zip(ltypes, rtypes)]

        def coerced(rel: RelationPlan) -> PlanNode:
            node = rel.node
            exprs = []
            for i, typ in enumerate(common):
                ref = B.ref(i, node.types[i])
                exprs.append(_coerce(ref, typ))
            if all(isinstance(e, InputRef) and e.type == common[i]
                   for i, e in enumerate(exprs)):
                return node
            cols = tuple((left.scope.fields[i].name, typ)
                         for i, typ in enumerate(common))
            return ProjectNode(node, tuple(exprs), cols)

        lnode, rnode = coerced(left), coerced(right)
        out_cols = tuple((f.name, typ)
                         for f, typ in zip(left.scope.fields, common))
        fields = [Field(f.name, None, typ)
                  for f, typ in zip(left.scope.fields, common)]
        all_ch = tuple(range(len(common)))

        if q.op == "union":
            node: PlanNode = UnionNode((lnode, rnode), out_cols)
            if not q.all:
                node = AggregationNode(node, all_ch, (), out_cols)
        elif q.op in ("intersect", "except"):
            if q.all:
                raise SqlAnalysisError(
                    f"{q.op.upper()} ALL is not supported")
            # the reference's SetOperationNodeTranslator shape: union both
            # branches with per-side marker columns, GROUP BY all output
            # channels (NULL keys group together — distinct semantics,
            # unlike join matching), then filter on the side counts
            def marked(node: PlanNode, lv: int, rv: int) -> PlanNode:
                exprs = tuple(
                    [B.ref(i, typ) for i, typ in enumerate(common)]
                    + [B.const(lv, T.BIGINT), B.const(rv, T.BIGINT)])
                cols = out_cols + (("$l", T.BIGINT), ("$r", T.BIGINT))
                return ProjectNode(node, exprs, cols)

            u_cols = out_cols + (("$l", T.BIGINT), ("$r", T.BIGINT))
            u = UnionNode((marked(lnode, 1, 0), marked(rnode, 0, 1)),
                          u_cols)
            nch = len(common)
            aggs = (PlanAggregate(resolve_aggregate("sum", T.BIGINT), nch),
                    PlanAggregate(resolve_aggregate("sum", T.BIGINT),
                                  nch + 1))
            agg_cols = out_cols + (("$lc", T.BIGINT), ("$rc", T.BIGINT))
            agg = AggregationNode(u, all_ch, aggs, agg_cols)
            lc = B.ref(nch, T.BIGINT)
            rc = B.ref(nch + 1, T.BIGINT)
            in_left = B.comparison(">", lc, B.const(0, T.BIGINT))
            in_right = B.comparison(
                ">" if q.op == "intersect" else "=",
                rc, B.const(0, T.BIGINT))
            filt = FilterNode(agg, B.and_(in_left, in_right))
            node = ProjectNode(
                filt,
                tuple(B.ref(i, typ) for i, typ in enumerate(common)),
                out_cols)
        else:
            raise SqlAnalysisError(f"unknown set operation {q.op}")

        out = RelationPlan(node, Scope(fields, outer))
        if q.order_by:
            keys = []
            for item in q.order_by:
                ch = self._set_op_order_channel(item.expr, out.scope)
                keys.append((ch, item.ascending, item.nulls_first))
            out = RelationPlan(SortNode(out.node, tuple(keys)), out.scope)
        if q.limit is not None:
            out = RelationPlan(LimitNode(out.node, q.limit), out.scope)
        return out

    def _set_op_order_channel(self, e: t.Expression, scope: Scope) -> int:
        if isinstance(e, t.NumberLiteral) and e.text.isdigit():
            n = int(e.text)
            if not (1 <= n <= len(scope.fields)):
                raise SqlAnalysisError(f"ORDER BY position {n} out of range")
            return n - 1
        if isinstance(e, t.Identifier) and len(e.parts) == 1:
            idx = scope.try_resolve(e.parts)
            if idx is not None:
                return idx
        raise SqlAnalysisError(
            "set-operation ORDER BY must reference an output column")

    def _plan_query_body(self, q: t.Query,
                         outer: Optional[Scope]) -> RelationPlan:
        # FROM
        if q.relations:
            rel = self.plan_relation(q.relations[0], outer)
            for r in q.relations[1:]:
                right = self.plan_relation(r, outer)
                rel = self._cross_join(rel, right)
        else:
            rel = RelationPlan(ValuesNode((("dummy", T.BIGINT),), ((0,),)),
                               Scope([Field("dummy", None, T.BIGINT)]))
        rel.scope.parent = outer

        # WHERE (incl. subquery conjuncts)
        rel = self._plan_where(rel, q.where)

        has_aggs = (q.group_by
                    or any(_contains_aggregate(i.expr) for i in q.select)
                    or (q.having is not None
                        and _contains_aggregate(q.having)))
        if has_aggs:
            if q.grouping_sets is not None:
                rel, grouping = self._plan_grouping_sets(rel, q)
            else:
                rel, grouping = self._plan_aggregation(rel, q)
            # HAVING: plain conjuncts filter; subquery conjuncts transform
            plain_h: List[t.Expression] = []
            for c in split_conjuncts(q.having):
                if _contains_subquery(c):
                    rel = self._apply_subquery_conjunct(rel, c, grouping)
                else:
                    plain_h.append(c)
            if plain_h:
                htr = Translator(rel.scope, grouping)
                rel = RelationPlan(
                    FilterNode(rel.node,
                               _and_all([htr.translate(c)
                                         for c in plain_h])), rel.scope)
            tr = Translator(rel.scope, grouping)
        else:
            grouping = None
            tr = Translator(rel.scope)
            if q.having is not None:
                raise SqlAnalysisError("HAVING without aggregation")

        # Window functions (planned over the post-aggregation relation,
        # LogicalPlanner window-after-aggregation ordering)
        win_calls: List[t.FunctionCall] = []
        for item in q.select:
            _collect_windows(item.expr, win_calls)
        for s in q.order_by:
            _collect_windows(s.expr, win_calls)
        if win_calls:
            rel, win_map = self._plan_windows(rel, win_calls, grouping)
            tr = Translator(rel.scope, grouping, win_map)

        # scalar subqueries inside SELECT expressions (q09-style CASE
        # over subquery counts): hoist as channels first; Star expansion
        # below must not see the hidden channels
        visible_fields = list(rel.scope.fields)
        sub_refs: Dict[int, RowExpression] = {}
        for item in q.select:
            if not isinstance(item.expr, t.Star) \
                    and _contains_subquery(item.expr):
                rel = self._hoist_subqueries(rel, item.expr, sub_refs,
                                             grouping)
        if sub_refs:
            tr = Translator(rel.scope, grouping,
                            getattr(tr, "windows", None),
                            subquery_refs=sub_refs)

        # SELECT projection
        exprs: List[RowExpression] = []
        fields: List[Field] = []
        item_asts: List[Optional[t.Expression]] = []
        for item in q.select:
            if isinstance(item.expr, t.Star):
                for i, f in enumerate(visible_fields):
                    if (item.expr.qualifier is not None
                            and f.qualifier != item.expr.qualifier[0]):
                        continue
                    if f.name.startswith("$"):
                        continue  # hidden channels ($grouping_id, ...)
                    exprs.append(B.ref(i, f.type))
                    fields.append(Field(f.name, None, f.type))
                    item_asts.append(t.Identifier((f.name,))
                                     if f.qualifier is None else
                                     t.Identifier((f.qualifier, f.name)))
                continue
            rex = tr.translate(item.expr)
            name = item.alias or _derive_name(item.expr, len(fields))
            exprs.append(rex)
            fields.append(Field(name, None, rex.type))
            item_asts.append(item.expr)
        node = ProjectNode(rel.node, tuple(exprs),
                           tuple((f.name, f.type) for f in fields))
        out = RelationPlan(node, Scope(fields, outer))

        if q.distinct:
            cols = out.node.columns
            out = RelationPlan(
                AggregationNode(out.node,
                                tuple(range(len(cols))), (), cols),
                out.scope)

        # ORDER BY over the output scope (alias / ordinal / select-expr);
        # sort keys not in the select list become hidden channels,
        # projected away after the sort (the reference's hidden-symbol
        # ordering scheme in QueryPlanner)
        if q.order_by:
            keys = []
            hidden_exprs: List[RowExpression] = []
            n_visible = len(out.node.columns)
            for item in q.order_by:
                try:
                    ch = self._order_channel(item.expr, q, item_asts,
                                             out.scope)
                except SqlAnalysisError:
                    if q.distinct:
                        raise  # DISTINCT output hides source columns
                    try:
                        rex = tr.translate(item.expr)
                    except SqlAnalysisError:
                        # the expression may use select-list ALIASES
                        # (TPC-DS q36/q70/q86: CASE WHEN lochierarchy=0
                        # ...): substitute each alias with its select
                        # expression and retry over the input scope
                        rex = tr.translate(
                            _substitute_select_aliases(item.expr, q))
                    hidden_exprs.append(rex)
                    ch = n_visible + len(hidden_exprs) - 1
                keys.append((ch, item.ascending, item.nulls_first))
            sort_src = out.node
            if hidden_exprs:
                # re-project visible + hidden channels from the
                # pre-projection relation (out.node is the visible
                # ProjectNode over rel when there is no DISTINCT)
                cols = tuple(out.node.columns) + tuple(
                    (f"$sort{i}", e.type)
                    for i, e in enumerate(hidden_exprs))
                sort_src = ProjectNode(rel.node,
                                       tuple(list(exprs) + hidden_exprs),
                                       cols)
            sorted_node = SortNode(sort_src, tuple(keys))
            if hidden_exprs:
                trim = ProjectNode(
                    sorted_node,
                    tuple(InputRef(i, typ) for i, (_, typ)
                          in enumerate(out.node.columns)),
                    tuple(out.node.columns))
                out = RelationPlan(trim, out.scope)
            else:
                out = RelationPlan(sorted_node, out.scope)
        if q.limit is not None:
            out = RelationPlan(LimitNode(out.node, q.limit), out.scope)
        return out

    def _order_channel(self, e: t.Expression, q: t.Query,
                       item_asts: List[Optional[t.Expression]],
                       out_scope: Scope) -> int:
        if isinstance(e, t.NumberLiteral) and e.text.isdigit():
            n = int(e.text)
            if not (1 <= n <= len(out_scope.fields)):
                raise SqlAnalysisError(f"ORDER BY position {n} out of range")
            return n - 1
        if isinstance(e, t.Identifier) and len(e.parts) == 1:
            idx = out_scope.try_resolve(e.parts)
            if idx is not None:
                return idx
        for i, ast in enumerate(item_asts):
            if ast == e:
                return i
        raise SqlAnalysisError(
            f"ORDER BY expression must appear in the select list: {e}")

    # --- relations ---------------------------------------------------------
    def plan_relation(self, r: t.Relation,
                      outer: Optional[Scope]) -> RelationPlan:
        if isinstance(r, t.InlineValues):
            return self._plan_inline_values(r, outer)
        if isinstance(r, t.Table):
            return self._plan_table(r, outer)
        if isinstance(r, t.SubqueryRelation):
            sub = self.plan_query(r.query, outer)
            fields = []
            for i, f in enumerate(sub.scope.fields):
                name = (r.column_aliases[i] if i < len(r.column_aliases)
                        else f.name)
                fields.append(Field(name, r.alias, f.type))
            return RelationPlan(sub.node, Scope(fields, outer))
        if isinstance(r, t.Join):
            return self._plan_join(r, outer)
        if isinstance(r, t.Unnest):
            return self._plan_unnest(r, None, outer)
        raise SqlAnalysisError(f"unsupported relation {type(r).__name__}")

    def _plan_unnest(self, u: t.Unnest, left: Optional[RelationPlan],
                     outer: Optional[Scope],
                     preserve_outer: bool = False) -> RelationPlan:
        """UNNEST as a relation (standalone or CROSS JOIN UNNEST(...))."""
        if left is None:
            dummy_cols = (("$unnest_row", T.BIGINT),)
            base = RelationPlan(ValuesNode(dummy_cols, ((0,),)),
                                Scope([Field("$unnest_row", None, T.BIGINT)],
                                      outer))
        else:
            base = left
        tr = Translator(base.scope)
        args = [tr.translate(a) for a in u.args]
        for a in args:
            if not isinstance(a.type, (T.ArrayType, T.MapType)):
                raise SqlAnalysisError(
                    f"cannot unnest {a.type.display()}")
        nbase = len(base.node.columns)
        proj_exprs = tuple(
            [B.ref(i, ty) for i, (_, ty) in enumerate(base.node.columns)]
            + args)
        proj_cols = tuple(base.node.columns) + tuple(
            (f"$unnest{j}", a.type) for j, a in enumerate(args))
        proj = ProjectNode(base.node, proj_exprs, proj_cols)

        replicate = tuple(range(nbase)) if left is not None else ()
        unnest_channels = tuple(nbase + j for j in range(len(args)))
        out_cols: List[Tuple[str, T.Type]] = \
            [base.node.columns[i] for i in replicate]
        new_fields: List[Field] = [base.scope.fields[i] for i in replicate]
        produced = []
        for a in args:
            produced.extend(unnest_output_types(a.type))
        names = list(u.column_aliases)
        for k, ty in enumerate(produced):
            name = names[k] if k < len(names) else f"col{k}"
            out_cols.append((name, ty))
            new_fields.append(Field(name, u.alias, ty))
        if u.ordinality:
            k = len(produced)
            name = names[k] if k < len(names) else "ordinality"
            out_cols.append((name, T.BIGINT))
            new_fields.append(Field(name, u.alias, T.BIGINT))
        node = UnnestNode(proj, replicate, unnest_channels, u.ordinality,
                          tuple(out_cols), outer=preserve_outer)
        return RelationPlan(node, Scope(new_fields, outer))

    def _plan_table(self, r: t.Table,
                    outer: Optional[Scope]) -> RelationPlan:
        # CTE reference?
        if len(r.name) == 1:
            for frame in reversed(self.ctes):
                if r.name[0] in frame:
                    sub = self.plan_query(frame[r.name[0]], outer)
                    qualifier = r.alias or r.name[0]
                    fields = [Field(f.name, qualifier, f.type)
                              for f in sub.scope.fields]
                    return RelationPlan(sub.node, Scope(fields, outer))
        view_sql = self.metadata.get_view(r.name)
        if view_sql is not None:
            from presto_tpu_torch.sql.parser import parse_statement

            vkey = self.metadata.split_name(r.name)
            expanding = getattr(self, "_expanding_views", None)
            if expanding is None:
                expanding = self._expanding_views = set()
            if vkey in expanding:
                raise SqlAnalysisError(
                    f"view {'.'.join(vkey)} is recursive")
            vstmt = parse_statement(view_sql)
            if not isinstance(vstmt, (t.Query, t.SetOperation)):
                raise SqlAnalysisError(
                    f"view {'.'.join(r.name)} is not a query")
            expanding.add(vkey)
            try:
                sub = self.plan_query(vstmt, outer)
            finally:
                expanding.discard(vkey)
            qualifier = r.alias or r.name[-1]
            fields = [Field(f.name, qualifier, f.type)
                      for f in sub.scope.fields]
            return RelationPlan(sub.node, Scope(fields, outer))
        catalog, table, conn, schema = self.metadata.resolve_table(r.name)
        names = schema.column_names()
        cols = tuple((n, schema.column_type(n)) for n in names)
        node = TableScanNode(catalog, table, tuple(names), cols)
        qualifier = r.alias or r.name[-1]
        fields = [Field(n, qualifier, typ) for n, typ in cols]
        return RelationPlan(node, Scope(fields, outer))

    def _cross_join(self, left: RelationPlan,
                    right: RelationPlan) -> RelationPlan:
        cols = left.node.columns + right.node.columns
        node = JoinNode("cross", left.node, right.node, (), (), cols)
        return RelationPlan(node,
                            Scope(left.scope.fields + right.scope.fields,
                                  left.scope.parent))

    def _plan_join(self, r: t.Join,
                   outer: Optional[Scope]) -> RelationPlan:
        left = self.plan_relation(r.left, outer)
        if isinstance(r.right, t.Unnest):
            if r.kind not in ("cross", "inner", "left"):
                raise SqlAnalysisError(f"{r.kind} join with UNNEST")
            return self._plan_unnest(r.right, left, outer,
                                     preserve_outer=(r.kind == "left"))
        right = self.plan_relation(r.right, outer)
        combined = RelationPlan(
            None,  # type: ignore[arg-type]
            Scope(left.scope.fields + right.scope.fields, outer))
        if r.kind == "cross" or r.on is None:
            return self._cross_join(left, right)

        nleft = len(left.scope.fields)
        left_keys: List[int] = []
        right_keys: List[int] = []
        residuals: List[t.Expression] = []
        left_only: List[t.Expression] = []
        right_only: List[t.Expression] = []
        lscope = Scope(left.scope.fields, None)
        rscope = Scope(right.scope.fields, None)
        for c in split_conjuncts(r.on):
            side = _conjunct_side(c, lscope, rscope)
            if side == "both" and isinstance(c, t.Comparison) and c.op == "=":
                l_idx = _try_translate_side(c.left, lscope)
                r_idx = _try_translate_side(c.right, rscope)
                if l_idx is None or r_idx is None:
                    l_idx = _try_translate_side(c.right, lscope)
                    r_idx = _try_translate_side(c.left, rscope)
                if l_idx is not None and r_idx is not None:
                    left_keys.append(l_idx)
                    right_keys.append(r_idx)
                    continue
            if side == "left":
                left_only.append(c)
            elif side == "right":
                right_only.append(c)
            else:
                residuals.append(c)

        # single-side conjuncts push into the inputs when that side is
        # NOT preserved (inner both sides; outer joins only the build
        # side).  A conjunct on the PRESERVED side of an outer join only
        # gates matching — those rows split: the passing slice joins,
        # the failing slice flows through null-extended.
        preserved_only: List[t.Expression] = []
        if left_only:
            if r.kind == "inner":
                left = self._filter_rel(left, left_only)
            elif r.kind == "left":
                preserved_only = left_only
            else:
                residuals.extend(left_only)
        if right_only:
            if r.kind in ("inner", "left"):
                # left outer: filtering the build side is ON-clause
                # semantics (non-matching right rows just don't match)
                right = self._filter_rel(right, right_only)
            elif r.kind == "right":
                preserved_only = right_only
            else:
                residuals.extend(right_only)

        cols = left.node.columns + right.node.columns
        residual_rex = None
        if residuals:
            comb_tr = Translator(Scope(left.scope.fields
                                       + right.scope.fields, None))
            residual_rex = _and_all(
                [comb_tr.translate(c) for c in residuals])
        if not left_keys:
            if r.kind != "inner":
                raise SqlAnalysisError(
                    f"{r.kind} join requires at least one equi condition")
            node: PlanNode = JoinNode("cross", left.node, right.node, (), (),
                                      cols)
            if residual_rex is not None:
                node = FilterNode(node, residual_rex)
        elif r.kind == "right":
            # RIGHT JOIN = LEFT JOIN with the sides swapped, projected
            # back to the original [left cols, right cols] layout
            nright = len(right.node.columns)
            swapped_cols = right.node.columns + left.node.columns
            res = None
            if residual_rex is not None:
                from presto_tpu_torch.sql.optimizer import remap as _remap

                mapping = {ch: (ch + nright if ch < nleft
                                else ch - nleft)
                           for ch in range(len(cols))}
                res = _remap(residual_rex, mapping)
            preserved = right.node
            ext = None
            if preserved_only:
                preserved, ext = self._split_preserved(
                    right, preserved_only,
                    lambda fail: ProjectNode(
                        fail,
                        tuple(B.null(ty)
                              for _n, ty in left.node.columns)
                        + tuple(B.ref(i, ty)
                                for i, (_n, ty)
                                in enumerate(right.node.columns)),
                        cols))
            swapped = JoinNode("left", preserved, left.node,
                               tuple(right_keys), tuple(left_keys),
                               swapped_cols, res)
            node = ProjectNode(
                swapped,
                tuple(B.ref(nright + i, ty)
                      for i, (_n, ty) in enumerate(left.node.columns))
                + tuple(B.ref(i, ty)
                        for i, (_n, ty) in enumerate(right.node.columns)),
                cols)
            if ext is not None:
                node = UnionNode((node, ext), cols)
        elif r.kind == "full":
            # FULL JOIN = LEFT JOIN  UNION ALL  (unmatched right rows,
            # null-extended) — the right/full-outer composition over
            # matched_build_mask's role (ops/join.py)
            if residual_rex is not None:
                raise SqlAnalysisError(
                    "full join residuals are not supported")
            left_join = JoinNode("left", left.node, right.node,
                                 tuple(left_keys), tuple(right_keys),
                                 cols)
            anti_b = SemiJoinNode(right.node, left.node,
                                  tuple(right_keys), tuple(left_keys),
                                  negated=True)
            extended = ProjectNode(
                anti_b,
                tuple(B.null(ty) for _n, ty in left.node.columns)
                + tuple(B.ref(i, ty)
                        for i, (_n, ty) in enumerate(right.node.columns)),
                cols)
            node = UnionNode((left_join, extended), cols)
        else:
            preserved = left.node
            ext = None
            if preserved_only and r.kind == "left":
                preserved, ext = self._split_preserved(
                    left, preserved_only,
                    lambda fail: ProjectNode(
                        fail,
                        tuple(B.ref(i, ty)
                              for i, (_n, ty)
                              in enumerate(left.node.columns))
                        + tuple(B.null(ty)
                                for _n, ty in right.node.columns),
                        cols))
            node = JoinNode(r.kind, preserved, right.node,
                            tuple(left_keys), tuple(right_keys), cols,
                            residual_rex)
            if ext is not None:
                node = UnionNode((node, ext), cols)
        return RelationPlan(node, combined.scope)

    def _split_preserved(self, rel: RelationPlan,
                         conjuncts: List[t.Expression], null_extend):
        """Split an outer join's PRESERVED side on its own ON-clause
        conjuncts: the passing slice participates in matching, the
        failing slice (including UNKNOWN) flows through null-extended."""
        tr = Translator(Scope(rel.scope.fields, None))
        pred = B.coalesce(
            _and_all([tr.translate(c) for c in conjuncts]),
            B.const(False, T.BOOLEAN))
        passing = FilterNode(rel.node, pred)
        failing = FilterNode(rel.node, B.not_(pred))
        return passing, null_extend(failing)

    def _filter_rel(self, rel: RelationPlan,
                    conjuncts: List[t.Expression]) -> RelationPlan:
        tr = Translator(Scope(rel.scope.fields, None))
        pred = _and_all([tr.translate(c) for c in conjuncts])
        return RelationPlan(FilterNode(rel.node, pred), rel.scope)

    # --- WHERE & subqueries ------------------------------------------------
    def _plan_where(self, rel: RelationPlan,
                    where: Optional[t.Expression]) -> RelationPlan:
        # plain conjuncts filter FIRST so the optimizer sees the
        # Filter-over-cross-join pattern and can extract equi joins;
        # subquery transforms stack above (AND order is irrelevant)
        plain = [c for c in split_conjuncts(where)
                 if not _contains_subquery(c)]
        if plain:
            tr = Translator(rel.scope)
            rel = RelationPlan(
                FilterNode(rel.node, _and_all([tr.translate(c)
                                               for c in plain])),
                rel.scope)
        for c in split_conjuncts(where):
            if _contains_subquery(c):
                rel = self._apply_subquery_conjunct(rel, c)
        return rel

    def _apply_subquery_conjunct(
            self, rel: RelationPlan, c: t.Expression,
            grouping: Optional[GroupingContext] = None) -> RelationPlan:
        negated = False
        inner = c
        if isinstance(inner, t.Not):
            negated = True
            inner = inner.expr
        if isinstance(inner, t.InSubquery):
            return self._plan_in_subquery(rel, inner,
                                          negated != inner.negated)
        if isinstance(inner, t.Exists):
            return self._plan_exists(rel, inner.query,
                                     negated != inner.negated)
        if isinstance(inner, t.Comparison) and not negated:
            if isinstance(inner.right, t.ScalarSubquery):
                return self._plan_scalar_compare(rel, inner.op, inner.left,
                                                 inner.right.query, grouping)
            if isinstance(inner.left, t.ScalarSubquery):
                flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                           "=": "=", "<>": "<>"}[inner.op]
                return self._plan_scalar_compare(rel, flipped, inner.right,
                                                 inner.left.query, grouping)
        # general positions: EXISTS/IN under OR, scalar subqueries nested
        # in arithmetic/CASE — hoist into channels/markers and filter on
        # the rewritten expression
        return self._plan_general_subquery_filter(rel, c, grouping)

    def _plan_in_subquery(self, rel: RelationPlan, e: t.InSubquery,
                          negated: bool) -> RelationPlan:
        sub = self.plan_query(e.query, rel.scope)
        if len(sub.scope.fields) != 1:
            raise SqlAnalysisError("IN subquery must return one column")
        tr = Translator(rel.scope)
        key = tr.translate(e.expr)
        src, key_ch = _channel_for(rel, key)
        node = SemiJoinNode(src.node, sub.node, (key_ch,), (0,), negated,
                            null_aware=True)
        return RelationPlan(node, src.scope)

    def _plan_exists(self, rel: RelationPlan, q: t.Query,
                     negated: bool) -> RelationPlan:
        sub_from, corr_eq, corr_other = self._plan_correlated_from(rel, q)
        if not corr_eq:
            if corr_other:
                # correlation exists but not as extractable equality
                # conjuncts (e.g. "(a = b AND p) OR q"): constant-key
                # semi join with the WHOLE predicate as residual — the
                # nested-loop-shaped decorrelation the reference reaches
                # via TransformCorrelatedExistsToJoin
                return self._plan_exists_residual_only(
                    rel, sub_from, corr_other, negated)
            raise SqlAnalysisError(
                "uncorrelated EXISTS is not supported (always true/false)")
        outer_keys = []
        sub_keys = []
        tr = Translator(rel.scope)
        src = rel
        for sub_ch, outer_ast in corr_eq:
            key = tr.translate(outer_ast)
            src, ch = _channel_for(src, key)
            tr = Translator(src.scope)
            outer_keys.append(ch)
            sub_keys.append(sub_ch)
        residual = None
        if corr_other:
            comb = Scope(src.scope.fields + sub_from.scope.fields, None)
            ctr = Translator(comb)
            residual = _and_all([ctr.translate(c) for c in corr_other])
        node = SemiJoinNode(src.node, sub_from.node, tuple(outer_keys),
                            tuple(sub_keys), negated, residual)
        return RelationPlan(node, src.scope)

    def _plan_exists_residual_only(
            self, rel: RelationPlan, sub_from: RelationPlan,
            corr_conjuncts: List[t.Expression],
            negated: bool) -> RelationPlan:
        """EXISTS with no extractable equi-correlation: pair every outer
        row with every subquery row via a constant join key and let the
        residual (the full correlated predicate) decide matches.

        This is inherently a nested loop — O(outer x sub) residual
        evaluations, the same complexity the reference pays when its
        correlated-join rewrites bottom out in a nested-loop join;
        prefer conjunct-shaped correlation (a = b AND ...) for the hash
        path."""
        one_t = T.BIGINT

        def with_one(node: PlanNode):
            exprs = tuple(B.ref(i, ty)
                          for i, (_n, ty) in enumerate(node.columns))
            return ProjectNode(node, exprs + (B.const(1, one_t),),
                               tuple(node.columns) + (("$one", one_t),))

        src_node = with_one(rel.node)
        sub_node = with_one(sub_from.node)
        # residual channel layout: [probe cols incl. $one][build cols];
        # the hidden $one field occupies its index slot, never resolved
        comb = Scope(list(rel.scope.fields)
                     + [Field("$one", None, one_t)]
                     + list(sub_from.scope.fields), None)
        ctr = Translator(comb)
        residual = _and_all([ctr.translate(c) for c in corr_conjuncts])
        node = SemiJoinNode(src_node, sub_node,
                            (len(rel.node.columns),),
                            (len(sub_from.node.columns),),
                            negated, residual)
        proj = ProjectNode(
            node,
            tuple(B.ref(i, ty)
                  for i, (_n, ty) in enumerate(rel.node.columns)),
            tuple(rel.node.columns))
        return RelationPlan(proj, rel.scope)

    def _plan_scalar_compare(
            self, rel: RelationPlan, op: str, lhs: t.Expression,
            q: t.Query,
            grouping: Optional[GroupingContext] = None) -> RelationPlan:
        orig_fields = list(rel.scope.fields)
        orig_cols = tuple(rel.node.columns[:len(orig_fields)])
        rel2, val = self._attach_scalar_subquery(rel, q, grouping,
                                                 join_kind="inner")
        tr = Translator(rel2.scope, grouping)
        pred = B.comparison(op, tr.translate(lhs), val)
        filtered = FilterNode(rel2.node, pred)
        proj = ProjectNode(
            filtered,
            tuple(B.ref(i, ty) for i, (_n, ty) in enumerate(orig_cols)),
            orig_cols)
        return RelationPlan(proj, Scope(orig_fields, rel.scope.parent))

    def _try_uncorrelated(self, q: t.Query,
                          rel: RelationPlan) -> Optional[RelationPlan]:
        """Plan q with NO outer scope; None if it references the outer."""
        try:
            return self.plan_query(q, None)
        except SqlAnalysisError:
            return None

    def _plan_correlated_from(self, rel: RelationPlan, q: t.Query):
        """Plan a correlated subquery's FROM + local WHERE; classify
        correlated conjuncts.

        Returns (sub_plan, corr_eq, corr_other) where corr_eq is a list of
        (sub_channel, outer_ast) equality pairs and corr_other the AST
        conjuncts mixing both sides (to become join/semi residuals,
        translated over [outer fields + sub fields])."""
        if q.group_by or q.order_by or q.limit or q.distinct:
            raise SqlAnalysisError(
                "unsupported correlated subquery shape")
        sub = (self.plan_relation(q.relations[0], rel.scope)
               if q.relations else None)
        for r in (q.relations[1:] if q.relations else ()):
            sub = self._cross_join(sub, self.plan_relation(r, rel.scope))
        if sub is None:
            raise SqlAnalysisError("correlated subquery requires FROM")
        sub.scope.parent = rel.scope

        local: List[t.Expression] = []
        corr_eq: List[Tuple[int, t.Expression]] = []
        corr_other: List[t.Expression] = []
        sub_scope_only = Scope(sub.scope.fields, None)
        # factor (A AND X) OR (A AND Y) -> A AND (X OR Y) so shared
        # correlation equalities become extractable conjuncts (q41)
        conjuncts = [c2 for c in split_conjuncts(q.where)
                     for c2 in split_conjuncts(
                         factor_common_disjunct_conjuncts(c))]
        for c in conjuncts:
            if _contains_subquery(c):
                # nested subquery inside a correlated subquery: plan it
                # against the sub scope
                sub = self._apply_subquery_conjunct(sub, c)
                sub_scope_only = Scope(sub.scope.fields, None)
                continue
            locality = Scope(sub.scope.fields,
                             rel.scope).resolves_locally(c)
            if locality is True:
                local.append(c)
                continue
            if (isinstance(c, t.Comparison) and c.op == "="):
                sub_ch = _try_translate_side(c.left, sub_scope_only)
                outer_ast = c.right
                if sub_ch is None:
                    sub_ch = _try_translate_side(c.right, sub_scope_only)
                    outer_ast = c.left
                outer_ok = (Scope([], rel.scope).resolves_locally(outer_ast)
                            is False) if sub_ch is not None else False
                if sub_ch is not None and outer_ok:
                    corr_eq.append((sub_ch, outer_ast))
                    continue
            corr_other.append(c)
        if local:
            tr = Translator(sub_scope_only)
            sub = RelationPlan(
                FilterNode(sub.node,
                           _and_all([tr.translate(c) for c in local])),
                sub.scope)
        return sub, corr_eq, corr_other

    # --- general subquery hoisting (apply/decorrelation) -------------------
    # Subqueries in arbitrary expression positions — scalar subqueries
    # nested in arithmetic or CASE, EXISTS/IN under OR — hoist into
    # channels/markers joined to the relation, then the surrounding
    # expression translates normally (the reference's ApplyNode +
    # TransformCorrelated* / semiJoinOutput-symbol design).

    def _hoist_subqueries(self, rel: RelationPlan, expr: t.Node,
                          refs: Dict[int, RowExpression],
                          grouping=None) -> RelationPlan:
        """Attach every top-level subquery inside ``expr`` as a channel;
        ``refs`` maps id(ast node) -> replacement RowExpression."""
        if isinstance(expr, t.ScalarSubquery):
            rel, rex = self._attach_scalar_subquery(rel, expr.query,
                                                    grouping)
            refs[id(expr)] = rex
            return rel
        if isinstance(expr, t.Exists):
            rel, rex = self._attach_exists_marker(rel, expr.query)
            refs[id(expr)] = B.not_(rex) if expr.negated else rex
            return rel
        if isinstance(expr, t.InSubquery):
            rel, rex = self._attach_in_marker(rel, expr)
            refs[id(expr)] = B.not_(rex) if expr.negated else rex
            return rel
        for f in getattr(expr, "__dataclass_fields__", {}):
            v = getattr(expr, f)
            if isinstance(v, t.Node):
                rel = self._hoist_subqueries(rel, v, refs, grouping)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, t.Node):
                        rel = self._hoist_subqueries(rel, item, refs,
                                                     grouping)
                    elif isinstance(item, tuple):
                        for sub in item:
                            if isinstance(sub, t.Node):
                                rel = self._hoist_subqueries(
                                    rel, sub, refs, grouping)
        return rel

    def _plan_general_subquery_filter(
            self, rel: RelationPlan, c: t.Expression,
            grouping=None) -> RelationPlan:
        """WHERE/HAVING conjunct with subqueries in general positions."""
        orig_fields = list(rel.scope.fields)
        orig_cols = rel.node.columns[:len(orig_fields)]
        refs: Dict[int, RowExpression] = {}
        rel = self._hoist_subqueries(rel, c, refs, grouping)
        tr = Translator(rel.scope, grouping, subquery_refs=refs)
        filtered = FilterNode(rel.node, tr.translate(c))
        proj = ProjectNode(
            filtered,
            tuple(B.ref(i, ty) for i, (_n, ty) in enumerate(orig_cols)),
            tuple(orig_cols))
        return RelationPlan(proj, Scope(orig_fields, rel.scope.parent))

    def _attach_scalar_subquery(self, rel: RelationPlan, q: t.Query,
                                grouping=None, join_kind: str = "left"
                                ) -> Tuple[RelationPlan, RowExpression]:
        """Attach a scalar subquery's single value as a channel: cross
        join + EnforceSingleRow when uncorrelated; group-by-correlation-
        keys + join for correlated aggregates.  ``join_kind`` is "left"
        in expression positions (empty groups yield NULL, SQL scalar-
        subquery semantics); the comparison-FILTER path passes "inner" —
        NULL comparisons are filtered anyway, and inner joins keep the
        optimizer's reorder/flatten paths."""
        probe = self._try_uncorrelated(q, rel)
        if probe is not None:
            nleft = len(rel.scope.fields)
            single = EnforceSingleRowNode(probe.node)
            cols = rel.node.columns + probe.node.columns
            joined = JoinNode("cross", rel.node, single, (), (), cols)
            # "$"-prefixed hidden names: no SQL identifier can spell them,
            # so an attached value named like an outer column (q58's
            # d_week_seq) can never make name resolution ambiguous
            scope = Scope(rel.scope.fields
                          + [Field(f"${f.name}", "$subquery", f.type)
                             for f in probe.scope.fields],
                          rel.scope.parent)
            return (RelationPlan(joined, scope),
                    B.ref(nleft, probe.scope.fields[0].type))
        sub_from, corr_eq, corr_other = self._plan_correlated_from(rel, q)
        if corr_other:
            raise SqlAnalysisError(
                "only equality correlation is supported in scalar "
                "subqueries")
        if not (len(q.select) == 1
                and _contains_aggregate(q.select[0].expr)):
            raise SqlAnalysisError(
                "correlated scalar subquery must be a single aggregate")
        val_proj, value_type, n_keys = self._correlated_agg_value(
            sub_from, corr_eq, q)
        src = rel
        tr = Translator(src.scope)
        outer_keys = []
        for _, outer_ast in corr_eq:
            key = tr.translate(outer_ast)
            src, ch = _channel_for(src, key)
            tr = Translator(src.scope)
            outer_keys.append(ch)
        nleft = len(src.scope.fields)
        cols = src.node.columns + val_proj.columns
        joined = JoinNode(join_kind, src.node, val_proj,
                          tuple(outer_keys), tuple(range(n_keys)), cols)
        jscope = Scope(src.scope.fields
                       + [Field(f"${n}", "$subquery", ty)
                          for n, ty in val_proj.columns],
                       src.scope.parent)
        val: RowExpression = B.ref(nleft + n_keys, value_type)
        # count over an empty group is 0, not NULL: an unmatched outer
        # row must read the count's default (the reference plants the
        # same coalesce after the decorrelating join)
        sel = q.select[0].expr
        if (isinstance(sel, t.FunctionCall)
                and sel.name.lower() in ("count", "count_if")):
            val = B.coalesce(val, B.const(0, value_type))
        return RelationPlan(joined, jscope), val

    def _correlated_agg_value(self, sub_from: RelationPlan, corr_eq,
                              q: t.Query):
        """[keys..., $value] projection of a correlated aggregate
        subquery grouped by its correlation keys."""
        sub_keys = [ch for ch, _ in corr_eq]
        agg_asts: List[t.FunctionCall] = []
        _collect_aggs(q.select[0].expr, agg_asts)
        sub_tr = Translator(sub_from.scope)
        pre_exprs = [B.ref(ch, sub_from.scope.fields[ch].type)
                     for ch in sub_keys]
        aggs: List[PlanAggregate] = []
        agg_inputs: List[RowExpression] = []
        for a in agg_asts:
            if a.is_star or not a.args:
                spec = resolve_aggregate("count", None)
                aggs.append(PlanAggregate(spec, None, a.distinct))
                continue
            arg = sub_tr.translate(a.args[0])
            agg_inputs.append(arg)
            spec = resolve_aggregate(a.name, arg.type)
            aggs.append(PlanAggregate(
                spec, len(pre_exprs) + len(agg_inputs) - 1, a.distinct))
        pre_cols = (tuple((f"k{i}", x.type)
                          for i, x in enumerate(pre_exprs))
                    + tuple((f"a{i}", x.type)
                            for i, x in enumerate(agg_inputs)))
        pre = ProjectNode(sub_from.node, tuple(pre_exprs + agg_inputs),
                          pre_cols)
        agg_cols = (tuple(pre_cols[:len(sub_keys)])
                    + tuple((f"agg{i}", a.spec.result_type)
                            for i, a in enumerate(aggs)))
        agg_node = AggregationNode(pre, tuple(range(len(sub_keys))),
                                   tuple(aggs), agg_cols)
        g_fields = [Field(n, None, ty) for n, ty in agg_cols]
        gctx = GroupingContext([], agg_asts, g_fields)
        gctx.group_asts = [None] * len(sub_keys)  # type: ignore[list-item]
        val_tr = Translator(Scope(g_fields), gctx)
        value = val_tr.translate(q.select[0].expr)
        val_cols = agg_cols[:len(sub_keys)] + (("$value", value.type),)
        val_proj = ProjectNode(
            agg_node,
            tuple(B.ref(i, agg_cols[i][1])
                  for i in range(len(sub_keys))) + (value,),
            val_cols)
        return val_proj, value.type, len(sub_keys)

    def _attach_exists_marker(self, rel: RelationPlan, q: t.Query
                              ) -> Tuple[RelationPlan, RowExpression]:
        """EXISTS as a BOOLEAN channel (semiJoinOutput symbol role)."""
        probe = self._try_uncorrelated(q, rel)
        if probe is not None:
            # global count > 0 cross-joined (always exactly one row)
            cnt_spec = resolve_aggregate("count", None)
            agg = AggregationNode(
                probe.node, (), (PlanAggregate(cnt_spec, None),),
                (("$cnt", T.BIGINT),))
            nleft = len(rel.scope.fields)
            cols = rel.node.columns + agg.columns
            joined = JoinNode("cross", rel.node, agg, (), (), cols)
            scope = Scope(rel.scope.fields
                          + [Field("$cnt", "$subquery", T.BIGINT)],
                          rel.scope.parent)
            marker = B.comparison(">", B.ref(nleft, T.BIGINT),
                                  B.const(0, T.BIGINT))
            return RelationPlan(joined, scope), marker
        sub_from, corr_eq, corr_other = self._plan_correlated_from(rel, q)
        if corr_other or not corr_eq:
            raise SqlAnalysisError(
                "EXISTS in this position supports only equality "
                "correlation")
        sub_keys = [ch for ch, _ in corr_eq]
        pre_exprs = tuple(B.ref(ch, sub_from.scope.fields[ch].type)
                          for ch in sub_keys)
        pre_cols = tuple((f"k{i}", x.type)
                         for i, x in enumerate(pre_exprs))
        pre = ProjectNode(sub_from.node, pre_exprs, pre_cols)
        cnt_spec = resolve_aggregate("count", None)
        agg_cols = pre_cols + (("$cnt", T.BIGINT),)
        agg = AggregationNode(pre, tuple(range(len(sub_keys))),
                              (PlanAggregate(cnt_spec, None),), agg_cols)
        src = rel
        tr = Translator(src.scope)
        outer_keys = []
        for _, outer_ast in corr_eq:
            key = tr.translate(outer_ast)
            src, ch = _channel_for(src, key)
            tr = Translator(src.scope)
            outer_keys.append(ch)
        nleft = len(src.scope.fields)
        cols = src.node.columns + agg_cols
        joined = JoinNode("left", src.node, agg, tuple(outer_keys),
                          tuple(range(len(sub_keys))), cols)
        scope = Scope(src.scope.fields
                      + [Field(n, "$subquery", ty) for n, ty in agg_cols],
                      src.scope.parent)
        marker = B.call("is_not_null",
                        B.ref(nleft + len(sub_keys), T.BIGINT))
        return RelationPlan(joined, scope), marker

    def _attach_in_marker(self, rel: RelationPlan, e: t.InSubquery
                          ) -> Tuple[RelationPlan, RowExpression]:
        """``x IN (subquery)`` as a three-valued BOOLEAN channel
        (semiJoinOutput semantics): LEFT JOIN a DISTINCT build on x;
        TRUE on match, UNKNOWN for NULL x or an unmatched x against a
        build containing NULL, else FALSE — so NOT IN under OR negates
        correctly."""
        sub = self._try_uncorrelated(e.query, rel)
        if sub is None:
            raise SqlAnalysisError(
                "correlated IN subquery in this position")
        if len(sub.scope.fields) != 1:
            raise SqlAnalysisError("IN subquery must return one column")
        k_type = sub.scope.fields[0].type
        distinct = AggregationNode(sub.node, (0,), (),
                                   (("$k", k_type),))
        tr = Translator(rel.scope)
        key = tr.translate(e.expr)
        src, ch = _channel_for(rel, key)
        nleft = len(src.scope.fields)
        cols = src.node.columns + distinct.columns
        joined = JoinNode("left", src.node, distinct, (ch,), (0,), cols)
        scope = Scope(src.scope.fields
                      + [Field("$k", "$subquery", k_type)],
                      src.scope.parent)
        rel2 = RelationPlan(joined, scope)
        # build-side NULL presence (one extra global-agg scan of the
        # subquery, cross-joined as a single row)
        sub2 = self._try_uncorrelated(e.query, rel)
        has_null_src = FilterNode(
            sub2.node, B.call("is_null", B.ref(0, k_type)))
        cnt_spec = resolve_aggregate("count", None)
        bhn_agg = AggregationNode(
            has_null_src, (), (PlanAggregate(cnt_spec, None),),
            (("$bhn", T.BIGINT),))
        nleft2 = len(rel2.scope.fields)
        cols2 = rel2.node.columns + bhn_agg.columns
        joined2 = JoinNode("cross", rel2.node, bhn_agg, (), (), cols2)
        scope2 = Scope(rel2.scope.fields
                       + [Field("$bhn", "$subquery", T.BIGINT)],
                       rel2.scope.parent)
        matched = B.call("is_not_null", B.ref(nleft, k_type))
        build_has_null = B.comparison(
            ">", B.ref(nleft2, T.BIGINT), B.const(0, T.BIGINT))
        key_ref = B.ref(ch, key.type)
        # 3VL: NULL x -> UNKNOWN; match -> TRUE; no match w/ build NULL
        # -> UNKNOWN; else FALSE
        marker = B.if_(
            B.call("is_null", key_ref), B.null(T.BOOLEAN),
            B.if_(matched, B.const(True, T.BOOLEAN),
                  B.if_(build_has_null, B.null(T.BOOLEAN),
                        B.const(False, T.BOOLEAN))))
        return RelationPlan(joined2, scope2), marker

    class _FoldedValue:
        """Plan-time-folded VALUES entry (Python-domain value + type)."""

        __slots__ = ("type", "value")

        def __init__(self, typ: T.Type, value):
            self.type = typ
            self.value = value

    def _plan_inline_values(self, r: t.InlineValues,
                            outer: Optional[Scope]) -> RelationPlan:
        """VALUES rows -> ValuesNode (constant folding at plan time; the
        reference's Values/ValuesOperator path)."""
        tr = Translator(Scope([], outer))
        if not r.rows:
            raise SqlAnalysisError("VALUES requires at least one row")
        width = len(r.rows[0])
        consts: List[List[Constant]] = []
        for row in r.rows:
            if len(row) != width:
                raise SqlAnalysisError("VALUES rows differ in width")
            out_row = []
            for e in row:
                rex = tr.translate(e)
                if not isinstance(rex, Constant):
                    # fold input-free expressions (ARRAY[..], row(..),
                    # map(..), date arithmetic) at plan time
                    from presto_tpu_torch.expr.ir import input_channels

                    if input_channels(rex):
                        raise SqlAnalysisError(
                            "VALUES entries must be constant expressions")
                    from presto_tpu_torch.batch import Batch as _B
                    from presto_tpu_torch.expr.compile import evaluate

                    col = evaluate(rex, _B((), 1))
                    out_row.append(self._FoldedValue(rex.type, col.to_pylist(1)[0]))
                    continue
                out_row.append(rex)
            consts.append(out_row)
        cols = []
        for j in range(width):
            ctype = _common_type([consts[i][j].type
                                  for i in range(len(consts))])
            name = (r.column_aliases[j] if j < len(r.column_aliases)
                    else f"_col{j}")
            cols.append((name, ctype))
        py_rows = []
        for row in consts:
            out_row = []
            for c, (_, ctype) in zip(row, cols):
                v = c.value
                if isinstance(c, self._FoldedValue):  # Python-domain value
                    out_row.append(v)
                    continue
                if v is not None and not c.type.is_dictionary:
                    v = c.type.to_python(v)
                if v is not None and ctype.name in ("double", "real") \
                        and not isinstance(v, float):
                    v = float(v)
                out_row.append(v)
            py_rows.append(tuple(out_row))
        node = ValuesNode(tuple(cols), tuple(py_rows))
        fields = [Field(n, r.alias, typ) for n, typ in cols]
        return RelationPlan(node, Scope(fields, outer))

    # --- aggregation -------------------------------------------------------
    def _plan_aggregation(self, rel: RelationPlan, q: t.Query):
        scope = rel.scope
        tr = Translator(scope)
        # group expressions (support ordinals into the select list)
        group_asts: List[t.Expression] = []
        for g in q.group_by:
            if isinstance(g, t.NumberLiteral) and g.text.isdigit():
                item = q.select[int(g.text) - 1]
                group_asts.append(item.expr)
            else:
                group_asts.append(g)
        group_rex = [tr.translate(g) for g in group_asts]

        agg_asts: List[t.FunctionCall] = []
        for item in q.select:
            _collect_aggs(item.expr, agg_asts)
        if q.having is not None:
            _collect_aggs(q.having, agg_asts)
        for s in q.order_by:
            _collect_aggs(s.expr, agg_asts)

        pre_exprs: List[RowExpression] = list(group_rex)
        aggs: List[PlanAggregate] = []
        for a in agg_asts:
            if a.is_star or not a.args:
                spec = resolve_aggregate("count", None)
                aggs.append(PlanAggregate(spec, None, a.distinct))
                continue
            arg = _agg_input(tr, a)
            spec = resolve_aggregate(a.name, arg.type)
            _patch_agg_spec(tr, a, spec)
            aggs.append(PlanAggregate(spec, len(pre_exprs), a.distinct))
            pre_exprs.append(arg)
        if not pre_exprs:  # bare count(*): keep one channel for row counts
            pre_exprs = [B.ref(0, scope.fields[0].type)]
        pre_cols = tuple((f"c{i}", x.type) for i, x in enumerate(pre_exprs))
        pre = ProjectNode(rel.node, tuple(pre_exprs), pre_cols)
        out_cols = (tuple((f"g{i}", x.type)
                          for i, x in enumerate(group_rex))
                    + tuple((f"agg{i}", a.spec.result_type)
                            for i, a in enumerate(aggs)))
        node = AggregationNode(pre, tuple(range(len(group_rex))),
                               tuple(aggs), out_cols)
        out_fields = [Field(n, None, typ) for n, typ in out_cols]
        grouping = GroupingContext(group_asts, agg_asts, out_fields)
        out = RelationPlan(node, Scope(out_fields, scope.parent))
        # HAVING is handled by the caller (it may contain subqueries); the
        # grouped translator resolves via GroupingContext.lookup, so scope
        # names stay synthetic
        return out, grouping

    def _plan_grouping_sets(self, rel: RelationPlan, q: t.Query):
        """GROUPING SETS / ROLLUP / CUBE: one aggregation per set over the
        shared pre-projection, each projected onto the full key schema
        (absent keys as NULL), unioned — the GroupIdOperator role
        (presto-main/.../operator/GroupIdOperator.java:32) expressed as a
        union of grouped aggregations."""
        scope = rel.scope
        tr = Translator(scope)
        group_asts = list(q.group_by)
        group_rex = [tr.translate(g) for g in group_asts]

        agg_asts: List[t.FunctionCall] = []
        for item in q.select:
            _collect_aggs(item.expr, agg_asts)
        if q.having is not None:
            _collect_aggs(q.having, agg_asts)
        for s in q.order_by:
            _collect_aggs(s.expr, agg_asts)

        pre_exprs: List[RowExpression] = list(group_rex)
        aggs: List[PlanAggregate] = []
        for a in agg_asts:
            if a.is_star or not a.args:
                spec = resolve_aggregate("count", None)
                aggs.append(PlanAggregate(spec, None, a.distinct))
                continue
            arg = _agg_input(tr, a)
            spec = resolve_aggregate(a.name, arg.type)
            _patch_agg_spec(tr, a, spec)
            aggs.append(PlanAggregate(spec, len(pre_exprs), a.distinct))
            pre_exprs.append(arg)
        pre_cols = tuple((f"c{i}", x.type) for i, x in enumerate(pre_exprs))
        pre = ProjectNode(rel.node, tuple(pre_exprs), pre_cols)

        key_types = [x.type for x in group_rex]
        out_cols = (tuple((f"g{i}", typ)
                          for i, typ in enumerate(key_types))
                    + tuple((f"agg{i}", a.spec.result_type)
                            for i, a in enumerate(aggs))
                    + (("$grouping_id", T.BIGINT),))
        branches: List[PlanNode] = []
        for subset in q.grouping_sets:
            branch_aggs = tuple(aggs)
            branch_cols = (tuple((f"g{i}", key_types[i]) for i in subset)
                           + tuple((f"agg{i}", a.spec.result_type)
                                   for i, a in enumerate(aggs)))
            if not subset and not aggs:
                # a zero-column aggregation cannot execute; the grand
                # total branch carries a hidden count(*) the projection
                # ignores
                branch_aggs = (PlanAggregate(
                    resolve_aggregate("count", None), None),)
                branch_cols = (("$cnt", T.BIGINT),)
            agg_node = AggregationNode(pre, tuple(subset), branch_aggs,
                                       branch_cols)
            pos = {ch: k for k, ch in enumerate(subset)}
            exprs: List[RowExpression] = []
            for i, typ in enumerate(key_types):
                if i in pos:
                    exprs.append(B.ref(pos[i], typ))
                else:
                    exprs.append(B.null(typ))
            for j, a in enumerate(aggs):
                exprs.append(B.ref(len(subset) + j, a.spec.result_type))
            # grouping-id bitmask for the grouping() function (GroupId
            # operator's groupId symbol): bit i = key i absent here
            gid = sum(1 << i for i in range(len(key_types))
                      if i not in pos)
            exprs.append(B.const(gid, T.BIGINT))
            branches.append(ProjectNode(agg_node, tuple(exprs), out_cols))
        node: PlanNode = (branches[0] if len(branches) == 1
                          else UnionNode(tuple(branches), out_cols))
        out_fields = [Field(n, None, typ) for n, typ in out_cols]
        grouping = GroupingContext(
            group_asts, agg_asts, out_fields,
            grouping_id_channel=len(key_types) + len(aggs))
        return RelationPlan(node, Scope(out_fields, scope.parent)), grouping

    # --- window functions --------------------------------------------------
    _RANKING = {"row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist", "ntile"}
    _VALUE_FNS = {"lag", "lead", "first_value", "last_value", "nth_value"}
    _WINDOW_AGGS = {"sum", "count", "avg", "min", "max"}

    def _plan_windows(self, rel: RelationPlan,
                      calls: List[t.FunctionCall],
                      grouping: Optional[GroupingContext]):
        """Plan WindowNodes (one per distinct partition/order spec) over
        ``rel`` and return (new rel, {window-call AST -> channel ref}).
        The source's channels are preserved as a prefix; each WindowNode
        appends one channel per function."""
        scope = rel.scope
        tr = Translator(scope, grouping)
        node = rel.node
        n_src = len(node.columns)
        pre_exprs: List[RowExpression] = [
            B.ref(i, typ) for i, (_, typ) in enumerate(node.columns)]

        def chan_of(rex: RowExpression) -> int:
            if isinstance(rex, InputRef):
                return rex.index
            for i, e in enumerate(pre_exprs):
                if e == rex:
                    return i
            pre_exprs.append(rex)
            return len(pre_exprs) - 1

        def const_int(e: t.Expression, what: str) -> int:
            rex = tr.translate(e)
            if not isinstance(rex, Constant) or not isinstance(
                    rex.value, (int, float)):
                raise SqlAnalysisError(f"{what} must be a constant")
            return int(rex.value)

        # resolve each call -> (spec key, PlanWindowFunction parts)
        grouped_specs: Dict[Tuple, List[Tuple[t.FunctionCall, dict]]] = {}
        for call in calls:
            w = call.window
            part_channels = tuple(chan_of(tr.translate(p))
                                  for p in w.partition_by)
            order_keys = tuple(
                (chan_of(tr.translate(s.expr)), s.ascending, s.nulls_first)
                for s in w.order_by)
            fn = self._resolve_window_fn(call, tr, chan_of, const_int)
            key = (part_channels, order_keys)
            grouped_specs.setdefault(key, []).append((call, fn))

        if len(pre_exprs) > n_src:
            cols = tuple(node.columns) + tuple(
                (f"$winarg{i}", e.type)
                for i, e in enumerate(pre_exprs[n_src:]))
            node = ProjectNode(node, tuple(pre_exprs), cols)

        win_map: Dict[t.Expression, RowExpression] = {}
        for (part_channels, order_keys), entries in grouped_specs.items():
            base = len(node.columns)
            funcs = tuple(PlanWindowFunction(**fn) for _, fn in entries)
            cols = tuple(node.columns) + tuple(
                (f"$win{base + i}", f.result_type)
                for i, f in enumerate(funcs))
            node = WindowNode(node, part_channels, order_keys, funcs, cols)
            for i, (call, fn) in enumerate(entries):
                win_map[call] = B.ref(base + i, fn["result_type"])

        # scope keeps the original named fields; window channels are
        # addressable only through win_map
        new_scope = Scope(list(scope.fields), scope.parent)
        return RelationPlan(node, new_scope), win_map

    def _resolve_window_fn(self, call: t.FunctionCall, tr: Translator,
                           chan_of, const_int) -> dict:
        name = call.name
        w = call.window
        has_order = bool(w.order_by)
        fn: dict = dict(name=name, arg_channels=(), result_type=T.BIGINT,
                        frame_unit="range",
                        frame_start="unbounded_preceding",
                        frame_end="current" if has_order
                        else "unbounded_following")
        if name in self._RANKING:
            if not has_order and name != "row_number":
                raise SqlAnalysisError(f"{name} requires window ORDER BY")
            if name in ("percent_rank", "cume_dist"):
                fn["result_type"] = T.DOUBLE
            if name == "ntile":
                if len(call.args) != 1:
                    raise SqlAnalysisError("ntile takes one argument")
                fn["offset"] = const_int(call.args[0], "ntile bucket count")
            return fn
        if name in self._VALUE_FNS:
            if not call.args:
                raise SqlAnalysisError(f"{name} requires an argument")
            arg = tr.translate(call.args[0])
            fn["arg_channels"] = (chan_of(arg),)
            fn["result_type"] = arg.type
            if name in ("lag", "lead"):
                fn["offset"] = (const_int(call.args[1], f"{name} offset")
                                if len(call.args) > 1 else 1)
                if len(call.args) > 2:
                    dflt = _coerce(tr.translate(call.args[2]), arg.type)
                    fn["default_channel"] = chan_of(dflt)
            elif name == "nth_value":
                if len(call.args) != 2:
                    raise SqlAnalysisError("nth_value takes two arguments")
                fn["offset"] = const_int(call.args[1], "nth_value position")
            if w.frame is not None:
                self._apply_frame(fn, w.frame, const_int)
            return fn
        if name in self._WINDOW_AGGS:
            if call.is_star or not call.args:
                if name != "count":
                    raise SqlAnalysisError(f"{name} requires an argument")
                fn["result_type"] = T.BIGINT
            else:
                arg = tr.translate(call.args[0])
                fn["arg_channels"] = (chan_of(arg),)
                if name == "count":
                    fn["result_type"] = T.BIGINT
                elif name in ("min", "max"):
                    fn["result_type"] = arg.type
                elif name == "sum":
                    fn["result_type"] = (
                        T.BIGINT if T.is_integral(arg.type)
                        else arg.type)
                else:  # avg
                    fn["result_type"] = (
                        arg.type if isinstance(arg.type, T.DecimalType)
                        else T.DOUBLE)
            if w.frame is not None:
                self._apply_frame(fn, w.frame, const_int)
            return fn
        raise SqlAnalysisError(f"unknown window function {name}")

    @staticmethod
    def _apply_frame(fn: dict, frame: t.WindowFrame, const_int) -> None:
        fn["frame_unit"] = frame.unit

        def bound(b: t.FrameBound, which: str):
            fn[f"frame_{which}"] = b.kind
            if b.kind in ("preceding", "following"):
                fn[f"frame_{which}_offset"] = const_int(
                    b.value, "frame offset")

        bound(frame.start, "start")
        bound(frame.end, "end")
        if frame.unit == "range" and (
                fn["frame_start"] in ("preceding", "following")
                or fn["frame_end"] in ("preceding", "following")):
            raise SqlAnalysisError(
                "RANGE frames with value offsets are not supported")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _collect_windows(e: t.Node, out: List[t.FunctionCall]):
    """Collect windowed FunctionCalls (not descending into subqueries)."""
    if isinstance(e, t.FunctionCall) and e.window is not None:
        if e not in out:
            out.append(e)
        return
    if isinstance(e, (t.InSubquery, t.Exists, t.ScalarSubquery)):
        return
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, t.Node):
            _collect_windows(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, t.Node):
                    _collect_windows(item, out)
                elif isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, t.Node):
                            _collect_windows(sub, out)


_TWO_ARG_AGGS = {"map_agg", "min_by", "max_by", "corr", "covar_samp",
                 "covar_pop", "regr_slope", "regr_intercept",
                 "learn_classifier", "learn_regressor"}


def _agg_input(tr: Translator, a: t.FunctionCall) -> RowExpression:
    """Aggregate input expression; two-argument aggregates pack their
    arguments into a row(...) channel (the planner-side analogue of the
    reference's multi-channel accumulator inputs)."""
    if a.name.lower() in _TWO_ARG_AGGS:
        if len(a.args) != 2:
            raise SqlAnalysisError(f"{a.name} takes two arguments")
        k = tr.translate(a.args[0])
        v = tr.translate(a.args[1])
        fn = F.resolve_row_constructor([k.type, v.type])
        return Call("row", (k, v), fn.result_type, fn)
    return tr.translate(a.args[0])


def _patch_agg_spec(tr: Translator, a: t.FunctionCall, spec) -> None:
    """Constant-parameter aggregates: bake the parameter into finalize
    (approx_percentile's percentile argument)."""
    if a.name.lower() == "approx_percentile" and len(a.args) == 2:
        p = tr.translate(a.args[1])
        if not isinstance(p, Constant) or p.value is None:
            raise SqlAnalysisError(
                "approx_percentile(x, p) requires constant p")
        spec.finalize = f"approx_percentile:{float(p.value)}"


def _collect_aggs(e: t.Node, out: List[t.FunctionCall]):
    if (isinstance(e, t.FunctionCall) and e.name in AGG_NAMES
            and e.window is None):
        if e not in out:
            out.append(e)
        return
    if isinstance(e, (t.InSubquery, t.Exists, t.ScalarSubquery)):
        return
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, t.Node):
            _collect_aggs(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, t.Node):
                    _collect_aggs(item, out)
                elif isinstance(item, tuple):
                    for sub in item:
                        if isinstance(sub, t.Node):
                            _collect_aggs(sub, out)


def _conjunct_side(c: t.Expression, lscope: Scope, rscope: Scope) -> str:
    sides = set()
    for ident in _identifiers(c):
        if lscope.try_resolve(ident.parts) is not None:
            sides.add("left")
        elif rscope.try_resolve(ident.parts) is not None:
            sides.add("right")
        else:
            raise SqlAnalysisError(f"column {ident} cannot be resolved "
                                   "in join condition")
    if sides == {"left"}:
        return "left"
    if sides == {"right"}:
        return "right"
    return "both"


def _try_translate_side(e: t.Expression, scope: Scope) -> Optional[int]:
    """Channel index if e is a bare column of this scope, else None."""
    if isinstance(e, t.Identifier):
        return scope.try_resolve(e.parts)
    return None


def _channel_for(rel: RelationPlan, key: RowExpression):
    """Ensure ``key`` is available as a bare channel, appending a
    projection when it is computed."""
    if isinstance(key, InputRef):
        return rel, key.index
    n = len(rel.node.columns)
    exprs = tuple(B.ref(i, typ) for i, (_, typ) in
                  enumerate(rel.node.columns)) + (key,)
    cols = rel.node.columns + (("$key", key.type),)
    node = ProjectNode(rel.node, exprs, cols)
    scope = Scope(rel.scope.fields + [Field("$key", None, key.type)],
                  rel.scope.parent)
    return RelationPlan(node, scope), n


def _and_all(exprs: List[RowExpression]) -> RowExpression:
    out = exprs[0]
    for e in exprs[1:]:
        out = B.and_(out, e)
    return out


def _derive_name(e: t.Expression, idx: int) -> str:
    if isinstance(e, t.Identifier):
        return e.parts[-1]
    if isinstance(e, t.FunctionCall):
        return e.name
    return f"_col{idx}"
