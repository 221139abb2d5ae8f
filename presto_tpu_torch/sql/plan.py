"""Logical plan IR.

Channel-based analogue of the reference's PlanNode tree
(presto-main/.../sql/planner/plan/, 49 node types; this subset covers the
engine's executable shapes).  Unlike the reference's symbol-based plans,
expressions here reference *channel indices* of the child's output — the
planner resolves names once, and optimizer rewrites remap channels
explicitly (the HashGenerationOptimizer-style passes operate the same way).

Every node carries ``columns``: the output schema as (name, Type) pairs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.expr.functions import AggSpec
from presto_tpu_torch.expr.ir import RowExpression

Column = Tuple[str, T.Type]


class PlanNode:
    columns: Tuple[Column, ...]
    sources: Tuple["PlanNode", ...] = ()

    @property
    def types(self) -> List[T.Type]:
        return [t for _, t in self.columns]

    @property
    def names(self) -> List[str]:
        return [n for n, _ in self.columns]


D = dataclasses.dataclass


@D(frozen=True)
class TableScanNode(PlanNode):
    """Leaf scan (TableScanNode.java analogue); ``column_names`` are the
    connector-side names in output order."""

    catalog: str
    table: str
    column_names: Tuple[str, ...]
    columns: Tuple[Column, ...]


@D(frozen=True)
class ValuesNode(PlanNode):
    columns: Tuple[Column, ...]
    rows: Tuple[Tuple[object, ...], ...]


@D(frozen=True)
class FilterNode(PlanNode):
    source: PlanNode
    predicate: RowExpression

    @property
    def columns(self):  # type: ignore[override]
        return self.source.columns

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class ProjectNode(PlanNode):
    source: PlanNode
    expressions: Tuple[RowExpression, ...]
    columns: Tuple[Column, ...]

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class PlanAggregate:
    """One aggregate: resolved spec + input channel (None = count(*))."""

    spec: AggSpec
    channel: Optional[int]
    distinct: bool = False
    output_name: str = ""


@D(frozen=True)
class AggregationNode(PlanNode):
    source: PlanNode
    group_channels: Tuple[int, ...]
    aggregates: Tuple[PlanAggregate, ...]
    columns: Tuple[Column, ...]  # group keys then aggregate results
    step: str = "single"         # single | partial | final

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class JoinNode(PlanNode):
    """Equi-join (JoinNode.java analogue).  Output = left columns then
    right columns.  ``residual`` is evaluated over that concatenated
    channel space against matched pairs (JoinFilterFunction role)."""

    kind: str                    # inner | left | right | full | cross
    left: PlanNode
    right: PlanNode
    left_keys: Tuple[int, ...]
    right_keys: Tuple[int, ...]
    columns: Tuple[Column, ...]
    residual: Optional[RowExpression] = None
    # cost-chosen exchange placement (JoinNode.DistributionType role):
    # 'replicated' broadcasts the build side, 'partitioned' co-hash-
    # partitions both sides; None = let the fragmenter's stats threshold
    # decide (pre-CBO behavior)
    distribution: Optional[str] = None

    @property
    def sources(self):  # type: ignore[override]
        return (self.left, self.right)


@D(frozen=True)
class SemiJoinNode(PlanNode):
    """Filters ``source`` rows by key membership in ``filtering``
    (SemiJoinNode + the consuming filter, fused).  Output = source columns.
    ``residual`` (if any) is evaluated over [source columns, filtering
    columns] per candidate pair — the correlated-EXISTS residual."""

    source: PlanNode
    filtering: PlanNode
    source_keys: Tuple[int, ...]
    filtering_keys: Tuple[int, ...]
    negated: bool = False        # NOT IN / NOT EXISTS (anti join)
    residual: Optional[RowExpression] = None
    # NOT IN three-valued-logic semantics (vs NOT EXISTS): a NULL probe
    # key or any NULL in a non-empty filtering side yields UNKNOWN ->
    # row excluded; an EMPTY filtering side keeps every row
    null_aware: bool = False

    @property
    def columns(self):  # type: ignore[override]
        return self.source.columns

    @property
    def sources(self):  # type: ignore[override]
        return (self.source, self.filtering)


@D(frozen=True)
class PlanWindowFunction:
    """One windowed function over a shared (partition, order, frame) spec.

    ``name`` is the window/aggregate function; ``arg_channels`` index the
    source's channels; frame fields are None for ranking functions (which
    ignore frames).  ``offset``/``default_channel`` serve lag/lead/ntile/
    nth_value's extra scalar arguments."""

    name: str
    arg_channels: Tuple[int, ...]
    result_type: T.Type
    frame_unit: str = "range"            # rows | range
    frame_start: str = "unbounded_preceding"
    frame_end: str = "current"
    frame_start_offset: Optional[int] = None
    frame_end_offset: Optional[int] = None
    offset: Optional[int] = None         # lag/lead/nth_value k, ntile n
    default_channel: Optional[int] = None  # lag/lead default value


@D(frozen=True)
class WindowNode(PlanNode):
    """Window functions over a shared partition/order spec
    (WindowNode.java analogue).  Output = source columns + one column per
    function."""

    source: PlanNode
    partition_channels: Tuple[int, ...]
    order_keys: Tuple[Tuple[int, bool, Optional[bool]], ...]
    functions: Tuple[PlanWindowFunction, ...]
    columns: Tuple[Column, ...]

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class UnnestNode(PlanNode):
    """UNNEST over source rows (UnnestNode.java / UnnestOperator.java:39).

    ``replicate_channels`` pass through repeated per element;
    ``unnest_channels`` are ARRAY/MAP columns expanded positionally (zip to
    the longest, null-padding shorter ones); ``ordinality`` appends the
    1-based element index.  ``columns`` = replicated + per-unnest outputs
    (map -> key,value; array(row) -> one column per field) + ordinality.
    """

    source: PlanNode
    replicate_channels: Tuple[int, ...]
    unnest_channels: Tuple[int, ...]
    ordinality: bool
    columns: Tuple[Column, ...]
    # LEFT JOIN UNNEST: rows with empty/NULL containers still emit one
    # output row with NULL unnest columns
    outer: bool = False

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class UnionNode(PlanNode):
    """UNION ALL of same-width inputs (UnionNode.java analogue); DISTINCT
    and INTERSECT/EXCEPT are planned as aggregations/semijoins above this."""

    inputs: Tuple[PlanNode, ...]
    columns: Tuple[Column, ...]

    @property
    def sources(self):  # type: ignore[override]
        return self.inputs


@D(frozen=True)
class SortNode(PlanNode):
    source: PlanNode
    sort_keys: Tuple[Tuple[int, bool, Optional[bool]], ...]
    # (channel, ascending, nulls_first)

    @property
    def columns(self):  # type: ignore[override]
        return self.source.columns

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class LimitNode(PlanNode):
    source: PlanNode
    count: int

    @property
    def columns(self):  # type: ignore[override]
        return self.source.columns

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class EnforceSingleRowNode(PlanNode):
    """Scalar subquery guard (EnforceSingleRowOperator analogue): errors if
    the source yields >1 row; yields a single all-NULL row if empty."""

    source: PlanNode

    @property
    def columns(self):  # type: ignore[override]
        return self.source.columns

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class RemoteSourceNode(PlanNode):
    """Reads the output of other fragments over the exchange protocol
    (RemoteSourceNode / ExchangeOperator.java:36 analogue).  Appears only
    inside PlanFragments produced by the fragmenter."""

    fragment_ids: Tuple[int, ...]
    columns: Tuple[Column, ...]


@D(frozen=True)
class RemoteMergeNode(PlanNode):
    """Order-preserving remote source: every producer task emits a
    pre-sorted stream and this node k-way merges them (MergeOperator
    .java:45 + ExchangeOperator's ORDER BY variant).  ``limit`` stops
    the merge early for distributed TopN."""

    fragment_ids: Tuple[int, ...]
    sort_keys: Tuple[Tuple[int, bool, Optional[bool]], ...]
    columns: Tuple[Column, ...]
    limit: Optional[int] = None


@D(frozen=True)
class TableWriterNode(PlanNode):
    """Streams source rows into a per-task connector staging sink and
    emits ONE (rows, fragment) row (TableWriterOperator.java:58 role);
    the matching TableFinishNode commits.  Writer fragments are
    'scaled'-partitioned (SCALED_WRITER_DISTRIBUTION,
    SystemPartitioningHandle.java:62)."""

    source: PlanNode
    catalog: str
    table: str
    write_id: str
    columns: Tuple[Column, ...]  # (("rows", BIGINT), ("fragment", VARCHAR))

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class TableFinishNode(PlanNode):
    """Collects every writer task's (rows, fragment) row, commits the
    write atomically via Connector.finish_write, and emits the total row
    count (TableFinishOperator.java:46 role)."""

    source: PlanNode
    catalog: str
    table: str
    write_id: str
    columns: Tuple[Column, ...]  # (("rows", BIGINT),)

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


@D(frozen=True)
class OutputNode(PlanNode):
    source: PlanNode
    columns: Tuple[Column, ...]  # output names (possibly renamed)

    @property
    def sources(self):  # type: ignore[override]
        return (self.source,)


def format_plan(node: PlanNode, indent: int = 0, annotator=None) -> str:
    """EXPLAIN-style text rendering (planPrinter role).  ``annotator``
    (node -> str) appends per-node text — the EXPLAIN cost/stats surface
    (sql/memo.py cost_annotator)."""
    pad = "  " * indent
    name = type(node).__name__.replace("Node", "")
    detail = ""
    if isinstance(node, TableScanNode):
        detail = f" {node.catalog}.{node.table}"
    elif isinstance(node, FilterNode):
        detail = f" [{node.predicate}]"
    elif isinstance(node, ProjectNode):
        detail = " [" + ", ".join(map(str, node.expressions)) + "]"
    elif isinstance(node, AggregationNode):
        aggs = ", ".join(
            f"{a.spec.name}(#{a.channel if a.channel is not None else '*'})"
            + ("/distinct" if a.distinct else "")
            for a in node.aggregates)
        detail = f" keys={list(node.group_channels)} [{aggs}]"
        if node.step != "single":
            detail += f" step={node.step}"
    elif isinstance(node, JoinNode):
        detail = (f" {node.kind} on {list(node.left_keys)}="
                  f"{list(node.right_keys)}")
        if node.distribution is not None:
            detail += f" dist={node.distribution}"
        if node.residual is not None:
            detail += f" residual=[{node.residual}]"
    elif isinstance(node, SemiJoinNode):
        detail = (f" {'anti' if node.negated else 'semi'} on "
                  f"{list(node.source_keys)}={list(node.filtering_keys)}")
    elif isinstance(node, SortNode):
        detail = " " + str([(c, "asc" if a else "desc")
                            for c, a, _ in node.sort_keys])
    elif isinstance(node, LimitNode):
        detail = f" {node.count}"
    elif isinstance(node, (TableWriterNode, TableFinishNode)):
        detail = f" {node.catalog}.{node.table}"
    out = f"{pad}{name}{detail}  => {[n for n, _ in node.columns]}"
    if annotator is not None:
        out += annotator(node)
    out += "\n"
    for s in node.sources:
        out += format_plan(s, indent + 1, annotator)
    return out
