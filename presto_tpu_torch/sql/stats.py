"""Plan statistics derivation: the cost-based-optimizer substrate.

The reference derives per-PlanNode estimates through 40+ ``*StatsRule``
classes (presto-main/src/main/java/io/prestosql/cost/ —
``FilterStatsCalculator.java``, ``JoinStatsRule.java``,
``AggregationStatsRule.java``, ``StatsNormalizer``), which feed
``DetermineJoinDistributionType.java:50`` and ``ReorderJoins``.  This
module is that substrate: one bottom-up derivation over the channel-based
plan IR, carrying per-channel (ndv, nulls_fraction, low, high) beside the
row count.

The vocabulary mirrors the reference's:
- unknown stays unknown (``None``), never silently defaults — consumers
  choose their own fallbacks, like PlanNodeStatsEstimate.isOutputRowCountUnknown;
- filters use range interpolation for comparisons and 1/ndv for equality,
  with the reference's UNKNOWN_FILTER_COEFFICIENT (0.9) for opaque
  predicates (FilterStatsCalculator.java);
- equi-joins use |L|*|R| / max(ndv_l, ndv_r) per clause with independence
  across clauses (JoinStatsRule.java);
- aggregations cap the group count by the product of key NDVs
  (AggregationStatsRule.java).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Tuple

from presto_tpu_torch.expr.ir import (
    Call, Constant, InputRef, RowExpression, SpecialForm, input_channels,
)
from presto_tpu_torch.sql.plan import (
    AggregationNode, EnforceSingleRowNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanNode, ProjectNode, RemoteMergeNode, RemoteSourceNode,
    SemiJoinNode, SortNode, TableScanNode, UnionNode, UnnestNode,
    ValuesNode, WindowNode,
)

# the reference's FilterStatsCalculator.UNKNOWN_FILTER_COEFFICIENT
UNKNOWN_FILTER_COEFFICIENT = 0.9


@dataclasses.dataclass
class ColumnStats:
    """Per-channel statistics (cost/SymbolStatsEstimate role)."""

    ndv: Optional[float] = None
    nulls_fraction: float = 0.0
    low: Optional[float] = None    # numeric-comparable domain value
    high: Optional[float] = None


@dataclasses.dataclass
class PlanStats:
    """Per-node estimate (PlanNodeStatsEstimate role)."""

    row_count: Optional[float]
    columns: Dict[int, ColumnStats] = dataclasses.field(default_factory=dict)

    def col(self, ch: int) -> ColumnStats:
        return self.columns.get(ch, ColumnStats())


def _as_number(value) -> Optional[float]:
    """Literal -> comparable float (dates become epoch days)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, datetime.date):
        return float(value.toordinal() - datetime.date(1970, 1, 1).toordinal())
    return None


class StatsCalculator:
    """Memoized bottom-up derivation (StatsCalculator/CachingStatsProvider)."""

    def __init__(self, metadata=None):
        self.metadata = metadata
        # memo holds (node, stats): keeping the node referenced prevents
        # CPython from recycling its id() for a different (e.g. throwaway
        # join-ordering probe) node, which would alias cache entries
        self._cache: Dict[int, Tuple[PlanNode, PlanStats]] = {}

    def stats(self, node: PlanNode) -> PlanStats:
        hit = self._cache.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        derived = self._derive(node)
        self._cache[id(node)] = (node, derived)
        return derived

    def row_count(self, node: PlanNode,
                  default: float = float("inf")) -> float:
        rc = self.stats(node).row_count
        return default if rc is None else rc

    # ------------------------------------------------------------------
    def _derive(self, node: PlanNode) -> PlanStats:
        if isinstance(node, TableScanNode):
            return self._scan_stats(node)
        if isinstance(node, ValuesNode):
            return PlanStats(float(len(node.rows)))
        if isinstance(node, FilterNode):
            return self._filter_stats(node)
        if isinstance(node, ProjectNode):
            return self._project_stats(node)
        if isinstance(node, AggregationNode):
            return self._agg_stats(node)
        if isinstance(node, JoinNode):
            return self._join_stats(node)
        if isinstance(node, SemiJoinNode):
            return self._semijoin_stats(node)
        if isinstance(node, (SortNode, WindowNode)):
            return self.stats(node.sources[0])
        if isinstance(node, LimitNode):
            src = self.stats(node.source)
            rc = (float(node.count) if src.row_count is None
                  else min(src.row_count, float(node.count)))
            return PlanStats(rc, src.columns)
        if isinstance(node, EnforceSingleRowNode):
            return PlanStats(1.0)
        if isinstance(node, UnionNode):
            rcs = [self.stats(i).row_count for i in node.inputs]
            if any(r is None for r in rcs):
                return PlanStats(None)
            return PlanStats(float(sum(rcs)))
        if isinstance(node, UnnestNode):
            src = self.stats(node.source)
            rc = None if src.row_count is None else src.row_count * 3.0
            return PlanStats(rc)
        if isinstance(node, OutputNode):
            return self.stats(node.source)
        if isinstance(node, (RemoteSourceNode, RemoteMergeNode)):
            return PlanStats(None)
        return PlanStats(None)

    def _scan_stats(self, node: TableScanNode) -> PlanStats:
        if self.metadata is None:
            return PlanStats(None)
        try:
            conn = self.metadata.registry.get(node.catalog)
            handle = conn.get_table(node.table)
            ts = conn.table_statistics(handle)
        except Exception:
            return PlanStats(None)
        if ts is None:
            return PlanStats(None)
        cols: Dict[int, ColumnStats] = {}
        for ch, name in enumerate(node.column_names):
            cs = ColumnStats(
                ndv=ts.ndv.get(name),
                nulls_fraction=ts.nulls_fraction.get(name, 0.0),
                low=_as_number(ts.low.get(name)),
                high=_as_number(ts.high.get(name)))
            if cs.ndv is not None or cs.low is not None:
                cols[ch] = cs
        return PlanStats(float(ts.row_count), cols)

    # -- filters --------------------------------------------------------
    def _filter_stats(self, node: FilterNode) -> PlanStats:
        src = self.stats(node.source)
        if src.row_count is None:
            return PlanStats(None)
        sel, narrowed = _selectivity(node.predicate, src)
        rc = src.row_count * sel
        cols = dict(src.columns)
        cols.update(narrowed)
        # NDV cannot exceed the remaining row count
        cols = {ch: ColumnStats(
            None if c.ndv is None else min(c.ndv, rc),
            c.nulls_fraction, c.low, c.high) for ch, c in cols.items()}
        return PlanStats(rc, cols)

    def _project_stats(self, node: ProjectNode) -> PlanStats:
        src = self.stats(node.source)
        if src.row_count is None:
            return PlanStats(None)
        cols: Dict[int, ColumnStats] = {}
        for i, e in enumerate(node.expressions):
            if isinstance(e, InputRef) and e.index in src.columns:
                cols[i] = src.columns[e.index]
        return PlanStats(src.row_count, cols)

    def _agg_stats(self, node: AggregationNode) -> PlanStats:
        src = self.stats(node.source)
        if src.row_count is None:
            return PlanStats(None)
        if not node.group_channels:
            return PlanStats(1.0)
        groups = 1.0
        known = True
        for ch in node.group_channels:
            ndv = src.col(ch).ndv
            if ndv is None:
                known = False
                break
            groups *= max(ndv, 1.0)
        if not known:
            # the reference falls back to input rows when key NDV is
            # unknown; a 0.1 dampening matches its default heuristics
            groups = src.row_count * 0.1
        rc = min(groups, src.row_count)
        cols = {i: src.col(ch)
                for i, ch in enumerate(node.group_channels)}
        return PlanStats(rc, cols)

    # -- joins ----------------------------------------------------------
    def _join_stats(self, node: JoinNode) -> PlanStats:
        left = self.stats(node.left)
        right = self.stats(node.right)
        if left.row_count is None or right.row_count is None:
            return PlanStats(None)
        nleft = len(node.left.columns)
        if node.kind == "cross" or not node.left_keys:
            rc = left.row_count * right.row_count
        else:
            rc = left.row_count * right.row_count
            for lk, rk in zip(node.left_keys, node.right_keys):
                ndv_l = left.col(lk).ndv
                ndv_r = right.col(rk).ndv
                denom = None
                if ndv_l is not None and ndv_r is not None:
                    denom = max(ndv_l, ndv_r)
                elif ndv_l is not None:
                    denom = ndv_l
                elif ndv_r is not None:
                    denom = ndv_r
                if denom is not None and denom > 0:
                    rc /= denom
                else:
                    rc *= 0.1  # unknown key NDV: damp, don't explode
            if node.kind == "left":
                rc = max(rc, left.row_count)
        if node.residual is not None:
            rc *= UNKNOWN_FILTER_COEFFICIENT
        cols = dict(left.columns)
        for ch, cs in right.columns.items():
            cols[nleft + ch] = cs
        return PlanStats(rc, cols)

    def _semijoin_stats(self, node: SemiJoinNode) -> PlanStats:
        src = self.stats(node.source)
        filt = self.stats(node.filtering)
        if src.row_count is None:
            return PlanStats(None)
        # SemiJoinStatsCalculator: matched fraction ~ ndv overlap
        sel = 0.5
        if filt.row_count is not None and node.source_keys:
            ndv_s = src.col(node.source_keys[0]).ndv
            ndv_f = filt.col(node.filtering_keys[0]).ndv
            if ndv_s and ndv_f:
                sel = min(1.0, ndv_f / max(ndv_s, 1.0))
        if node.negated:
            sel = 1.0 - sel
        return PlanStats(src.row_count * max(sel, 0.0), src.columns)


# ---------------------------------------------------------------------------
# predicate selectivity (FilterStatsCalculator role)
# ---------------------------------------------------------------------------

_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}


def _selectivity(expr: RowExpression, src: PlanStats
                 ) -> Tuple[float, Dict[int, ColumnStats]]:
    """Returns (selectivity in [0,1], narrowed per-channel stats)."""
    if isinstance(expr, SpecialForm):
        if expr.form == "AND":
            sel = 1.0
            narrowed: Dict[int, ColumnStats] = {}
            cur = src
            for a in expr.args:
                s, n = _selectivity(a, cur)
                sel *= s
                narrowed.update(n)
                cur = PlanStats(cur.row_count,
                                {**cur.columns, **narrowed})
            return sel, narrowed
        if expr.form == "OR":
            inv = 1.0
            for a in expr.args:
                s, _ = _selectivity(a, src)
                inv *= (1.0 - s)
            return 1.0 - inv, {}
        if expr.form == "IN":
            v = expr.args[0]
            if isinstance(v, InputRef):
                ndv = src.col(v.index).ndv
                if ndv:
                    return min(1.0, (len(expr.args) - 1) / ndv), {}
            return 0.5, {}
    if isinstance(expr, Call) and expr.name in _CMP and len(expr.args) == 2:
        return _comparison_selectivity(expr, src)
    if isinstance(expr, Call) and expr.name == "not" and len(expr.args) == 1:
        s, _ = _selectivity(expr.args[0], src)
        return 1.0 - s, {}
    if isinstance(expr, Call) and getattr(expr.fn, "null_mode", None) \
            == "is_null" and expr.args:
        a = expr.args[0]
        if isinstance(a, InputRef):
            return src.col(a.index).nulls_fraction, {}
        return 0.1, {}
    if isinstance(expr, Call) and getattr(expr.fn, "null_mode", None) \
            == "is_not_null" and expr.args:
        a = expr.args[0]
        if isinstance(a, InputRef):
            return 1.0 - src.col(a.index).nulls_fraction, {}
        return 0.9, {}
    if isinstance(expr, Constant):
        if expr.value is True:
            return 1.0, {}
        if expr.value in (False, None):
            return 0.0, {}
    return UNKNOWN_FILTER_COEFFICIENT, {}


def _comparison_selectivity(expr: Call, src: PlanStats
                            ) -> Tuple[float, Dict[int, ColumnStats]]:
    a, b = expr.args
    op = expr.name
    if isinstance(b, InputRef) and isinstance(a, Constant):
        a, b = b, a
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
    if not (isinstance(a, InputRef) and isinstance(b, Constant)):
        if (isinstance(a, InputRef) and isinstance(b, InputRef)
                and op == "eq"):
            ndv_a = src.col(a.index).ndv
            ndv_b = src.col(b.index).ndv
            ndv = max(filter(None, [ndv_a, ndv_b]), default=None)
            return (1.0 / ndv if ndv else UNKNOWN_FILTER_COEFFICIENT), {}
        return UNKNOWN_FILTER_COEFFICIENT, {}
    cs = src.col(a.index)
    lit = _as_number(b.value)
    if op == "eq":
        sel = 1.0 / cs.ndv if cs.ndv else 0.1
        narrowed = ColumnStats(1.0, 0.0, lit, lit)
        return min(sel, 1.0), {a.index: narrowed}
    if op == "ne":
        sel = 1.0 - (1.0 / cs.ndv if cs.ndv else 0.1)
        return max(sel, 0.0), {}
    if lit is None or cs.low is None or cs.high is None \
            or cs.high <= cs.low:
        return 0.3, {}  # range comparison without domain: Presto's default
    span = cs.high - cs.low
    frac_below = min(max((lit - cs.low) / span, 0.0), 1.0)
    if op in ("lt", "le"):
        sel = frac_below
        narrowed = ColumnStats(
            None if cs.ndv is None else cs.ndv * max(sel, 1e-9),
            0.0, cs.low, lit)
    else:
        sel = 1.0 - frac_below
        narrowed = ColumnStats(
            None if cs.ndv is None else cs.ndv * max(sel, 1e-9),
            0.0, lit, cs.high)
    sel *= (1.0 - cs.nulls_fraction)
    return min(max(sel, 0.0), 1.0), {a.index: narrowed}
