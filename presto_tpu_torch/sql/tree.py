"""SQL AST.

Compact dataclass analogue of the reference's ~170 node classes under
presto-parser/src/main/java/io/prestosql/sql/tree/ — one node kind per
grammar production the engine supports.  Positions are (line, col) for
error messages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

D = dataclasses.dataclass


class Node:
    pass


class Expression(Node):
    pass


# --- literals / terms ------------------------------------------------------

@D(frozen=True)
class Identifier(Expression):
    parts: Tuple[str, ...]  # a.b.c; lowercased unless quoted

    def __str__(self):
        return ".".join(self.parts)


@D(frozen=True)
class NumberLiteral(Expression):
    text: str  # original text; analyzer decides integer/decimal/double


@D(frozen=True)
class StringLiteral(Expression):
    value: str


@D(frozen=True)
class BooleanLiteral(Expression):
    value: bool


@D(frozen=True)
class NullLiteral(Expression):
    pass


@D(frozen=True)
class TypedLiteral(Expression):
    """DATE 'x' / TIMESTAMP 'x' / DECIMAL 'x' / CHAR 'x'."""

    type_name: str
    value: str


@D(frozen=True)
class IntervalLiteral(Expression):
    value: str
    unit: str       # year|month|day|hour|minute|second
    sign: int = 1


@D(frozen=True)
class Star(Expression):
    qualifier: Optional[Tuple[str, ...]] = None  # t.* qualifier


@D(frozen=True)
class Parameter(Expression):
    index: int


# --- compound expressions --------------------------------------------------

@D(frozen=True)
class FrameBound(Node):
    """One end of a window frame: kind in {unbounded_preceding, preceding,
    current, following, unbounded_following}; value set for the bounded
    kinds."""

    kind: str
    value: Optional["Expression"] = None


@D(frozen=True)
class WindowFrame(Node):
    unit: str                        # rows | range
    start: FrameBound
    end: FrameBound


@D(frozen=True)
class WindowSpec(Node):
    """OVER (...) clause (Window in SqlBase.g4)."""

    partition_by: Tuple["Expression", ...] = ()
    order_by: Tuple["SortItem", ...] = ()
    frame: Optional[WindowFrame] = None


@D(frozen=True)
class FunctionCall(Expression):
    name: str
    args: Tuple[Expression, ...]
    distinct: bool = False           # count(DISTINCT x)
    is_star: bool = False            # count(*)
    window: Optional[WindowSpec] = None  # fn(...) OVER (...)


@D(frozen=True)
class Cast(Expression):
    expr: Expression
    type_name: str                   # e.g. "double", "decimal(12,2)"


@D(frozen=True)
class TryCast(Expression):
    """TRY_CAST(x AS t): NULL instead of an error on conversion failure."""

    expr: Expression
    type_name: str


@D(frozen=True)
class ArrayConstructor(Expression):
    items: Tuple[Expression, ...]


@D(frozen=True)
class Subscript(Expression):
    base: Expression
    index: Expression


@D(frozen=True)
class Lambda(Expression):
    params: Tuple[str, ...]
    body: Expression


@D(frozen=True)
class Deref(Expression):
    """Row-field access on a non-identifier base: ``expr.field``."""

    base: Expression
    field: str


@D(frozen=True)
class Extract(Expression):
    field: str                       # year|month|day|...
    expr: Expression


@D(frozen=True)
class ArithmeticBinary(Expression):
    op: str                          # + - * / %
    left: Expression
    right: Expression


@D(frozen=True)
class ArithmeticUnary(Expression):
    op: str                          # -
    expr: Expression


@D(frozen=True)
class Comparison(Expression):
    op: str                          # = != <> < <= > >=
    left: Expression
    right: Expression


@D(frozen=True)
class Between(Expression):
    expr: Expression
    low: Expression
    high: Expression
    negated: bool = False


@D(frozen=True)
class InList(Expression):
    expr: Expression
    items: Tuple[Expression, ...]
    negated: bool = False


@D(frozen=True)
class InSubquery(Expression):
    expr: Expression
    query: "Query"
    negated: bool = False


@D(frozen=True)
class Exists(Expression):
    query: "Query"
    negated: bool = False


@D(frozen=True)
class ScalarSubquery(Expression):
    query: "Query"


@D(frozen=True)
class Like(Expression):
    expr: Expression
    pattern: Expression
    escape: Optional[Expression] = None
    negated: bool = False


@D(frozen=True)
class IsNull(Expression):
    expr: Expression
    negated: bool = False


@D(frozen=True)
class Not(Expression):
    expr: Expression


@D(frozen=True)
class LogicalBinary(Expression):
    op: str                          # and|or
    left: Expression
    right: Expression


@D(frozen=True)
class Case(Expression):
    operand: Optional[Expression]    # CASE x WHEN ... vs CASE WHEN ...
    whens: Tuple[Tuple[Expression, Expression], ...]
    default: Optional[Expression]


@D(frozen=True)
class Coalesce(Expression):
    args: Tuple[Expression, ...]


@D(frozen=True)
class NullIf(Expression):
    first: Expression
    second: Expression


# --- relations -------------------------------------------------------------

class Relation(Node):
    pass


@D(frozen=True)
class Table(Relation):
    name: Tuple[str, ...]            # [catalog.][schema.]table
    alias: Optional[str] = None


@D(frozen=True)
class SubqueryRelation(Relation):
    query: "Query"
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()


@D(frozen=True)
class Join(Relation):
    kind: str                        # inner|left|right|full|cross
    left: Relation
    right: Relation
    on: Optional[Expression] = None


@D(frozen=True)
class Unnest(Relation):
    """UNNEST(a1, a2, ...) [WITH ORDINALITY] [alias(col, ...)]."""

    args: Tuple[Expression, ...]
    ordinality: bool = False
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()


# --- query -----------------------------------------------------------------

@D(frozen=True)
class SelectItem(Node):
    expr: Expression
    alias: Optional[str] = None


@D(frozen=True)
class SortItem(Node):
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None


@D(frozen=True)
class Query(Node):
    select: Tuple[SelectItem, ...]
    relations: Tuple[Relation, ...]  # FROM a, b, c (implicit cross joins)
    where: Optional[Expression] = None
    group_by: Tuple[Expression, ...] = ()
    having: Optional[Expression] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    distinct: bool = False
    with_queries: Tuple[Tuple[str, "Query"], ...] = ()
    # GROUPING SETS / ROLLUP / CUBE: when set, ``group_by`` holds the
    # full (deduplicated) grouping column list and each entry here is the
    # subset of indices into it that one grouping set keeps
    grouping_sets: Optional[Tuple[Tuple[int, ...], ...]] = None


@D(frozen=True)
class SetOperation(Node):
    """UNION / INTERSECT / EXCEPT over two query bodies.  ORDER BY and
    LIMIT written after the last branch attach here (they apply to the
    whole operation)."""

    op: str                          # union | intersect | except
    all: bool                        # UNION ALL vs UNION [DISTINCT]
    left: Node                       # Query | SetOperation
    right: Node
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    with_queries: Tuple[Tuple[str, "Query"], ...] = ()


@D(frozen=True)
class InlineValues(Relation):
    """VALUES (e, ...), (e, ...) — in FROM position or as INSERT source."""

    rows: Tuple[Tuple["Expression", ...], ...]
    alias: Optional[str] = None
    column_aliases: Tuple[str, ...] = ()


@D(frozen=True)
class CreateTable(Node):
    table: Tuple[str, ...]
    columns: Tuple[Tuple[str, str], ...]   # (name, type string)
    if_not_exists: bool = False
    # WITH (k = v, ...) table properties (format, partitioned_by, ...)
    properties: Tuple[Tuple[str, Any], ...] = ()


@D(frozen=True)
class CreateTableAs(Node):
    table: Tuple[str, ...]
    query: Node
    if_not_exists: bool = False
    properties: Tuple[Tuple[str, Any], ...] = ()


@D(frozen=True)
class Insert(Node):
    table: Tuple[str, ...]
    columns: Tuple[str, ...]               # () = positional
    source: Node                           # Query | SetOperation | InlineValues


@D(frozen=True)
class DropTable(Node):
    table: Tuple[str, ...]
    if_exists: bool = False


@D(frozen=True)
class CallProcedure(Node):
    name: Tuple[str, ...]            # e.g. ('system', 'runtime', 'kill_query')
    args: Tuple["Expression", ...]


@D(frozen=True)
class Explain(Node):
    statement: Node
    analyze: bool = False
    # EXPLAIN (TYPE ...) — logical | distributed | validate | io
    plan_type: str = "logical"


@D(frozen=True)
class SetSession(Node):
    name: str
    value: str                       # literal text


@D(frozen=True)
class ResetSession(Node):
    name: str


@D(frozen=True)
class ShowSession(Node):
    pass


@D(frozen=True)
class ShowTables(Node):
    catalog: Optional[str] = None
    like: Optional[str] = None


@D(frozen=True)
class ShowColumns(Node):
    table: Tuple[str, ...]


# --- additional statements (SqlBase.g4 statement alternatives) -------------

@D(frozen=True)
class Delete(Node):
    """DELETE FROM t [WHERE e] (DeleteOperator/TableDeleteOperator role)."""

    table: Tuple[str, ...]
    where: Optional[Expression] = None


@D(frozen=True)
class Prepare(Node):
    """PREPARE name FROM <statement>; the statement may contain ?
    parameters (Parameter nodes).  ``original_sql`` keeps the statement
    text verbatim for the client protocol's added-prepare exchange."""

    name: str
    statement: Node
    original_sql: str = ""


@D(frozen=True)
class ExecutePrepared(Node):
    """EXECUTE name [USING expr, ...]."""

    name: str
    parameters: Tuple[Expression, ...] = ()


@D(frozen=True)
class Deallocate(Node):
    name: str


@D(frozen=True)
class DescribeInput(Node):
    name: str


@D(frozen=True)
class DescribeOutput(Node):
    name: str


@D(frozen=True)
class ShowCatalogs(Node):
    like: Optional[str] = None


@D(frozen=True)
class ShowSchemas(Node):
    catalog: Optional[str] = None
    like: Optional[str] = None


@D(frozen=True)
class ShowFunctions(Node):
    like: Optional[str] = None


@D(frozen=True)
class ShowStats(Node):
    """SHOW STATS FOR table (SHOW STATS FOR (query) unsupported)."""

    table: Tuple[str, ...]


@D(frozen=True)
class ShowCreateTable(Node):
    table: Tuple[str, ...]


@D(frozen=True)
class ShowCreateView(Node):
    view: Tuple[str, ...]


@D(frozen=True)
class Use(Node):
    """USE catalog | USE catalog.schema."""

    catalog: str
    schema: Optional[str] = None


@D(frozen=True)
class StartTransaction(Node):
    pass


@D(frozen=True)
class Commit(Node):
    pass


@D(frozen=True)
class Rollback(Node):
    pass


@D(frozen=True)
class CreateView(Node):
    view: Tuple[str, ...]
    query: Node
    replace: bool = False
    original_sql: str = ""            # stored/rendered by SHOW CREATE VIEW


@D(frozen=True)
class DropView(Node):
    view: Tuple[str, ...]
    if_exists: bool = False


@D(frozen=True)
class Analyze(Node):
    """ANALYZE t — collect table/column statistics."""

    table: Tuple[str, ...]


@D(frozen=True)
class Grant(Node):
    privileges: Tuple[str, ...]       # ('select','insert',...) or ('all',)
    table: Tuple[str, ...]
    grantee: str


@D(frozen=True)
class Revoke(Node):
    privileges: Tuple[str, ...]
    table: Tuple[str, ...]
    grantee: str


@D(frozen=True)
class RenameTable(Node):
    """ALTER TABLE t RENAME TO u."""

    table: Tuple[str, ...]
    new_name: Tuple[str, ...]


# --- tree utilities --------------------------------------------------------

def _rewrite(node, fn):
    """Bottom-up structural rewrite over the dataclass tree: applies ``fn``
    to every Node after rewriting its children; tuples are rewritten
    element-wise.  Non-Node leaves pass through."""
    if isinstance(node, tuple):
        return tuple(_rewrite(x, fn) for x in node)
    if not isinstance(node, Node):
        return node
    changes = {}
    for f in dataclasses.fields(node):
        old = getattr(node, f.name)
        new = _rewrite(old, fn)
        if new is not old and new != old:
            changes[f.name] = new
    if changes:
        node = dataclasses.replace(node, **changes)
    return fn(node)


def parameter_count(stmt: Node) -> int:
    """Number of ? parameters in the statement (max index + 1)."""
    count = [0]

    def visit(n):
        if isinstance(n, Parameter):
            count[0] = max(count[0], n.index + 1)
        return n

    _rewrite(stmt, visit)
    return count[0]


def substitute_parameters(stmt: Node,
                          values: Tuple[Expression, ...]) -> Node:
    """Replace each Parameter node with the corresponding expression
    (EXECUTE ... USING binding, QueryPreparer.java role)."""
    need = parameter_count(stmt)
    if need != len(values):
        raise ValueError(
            f"statement has {need} parameters, {len(values)} values given")

    def visit(n):
        if isinstance(n, Parameter):
            return values[n.index]
        return n

    return _rewrite(stmt, visit)
