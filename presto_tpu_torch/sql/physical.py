"""Physical planner: logical PlanNode tree -> executable Pipelines.

The LocalExecutionPlanner analogue (presto-main/.../sql/planner/
LocalExecutionPlanner.java:291): a bottom-up visitor mapping each PlanNode
to OperatorFactory chains.

Aggregate decomposition happens here: a PlanAggregate's AggSpec components
become primitive AggChannels (sum/count/min/max; sumsq pre-projects x*x)
and ``finalize`` becomes a post-aggregation projection (avg = sum/count,
stddev/variance from the moment components) — the role the reference's
AccumulatorCompiler + partial/final Step split plays.

This package lowers scans, VALUES, filter/project, aggregation, inner and
left hash joins (with dynamic filters), semi and anti joins (IN, EXISTS
and their negations, with a residual for a correlated EXISTS), the cross
join and EnforceSingleRow (scalar subqueries), UNION ALL, ORDER BY, TopN,
LIMIT, window functions (with the TopNRowNumber fusion of a
``row_number() <= N`` filter), the streaming aggregation of key-clustered
scans, UNNEST and the output, or in its place the table writer of an
INSERT or CTAS (``plan_fragment``); the runner adds the local exchange.
The planner composes RIGHT and FULL joins and INTERSECT/EXCEPT from
these.  Every other node raises ``NotImplementedError`` naming the
ROADMAP item that ports it.  There is no pipeline-fusion post-pass: the
chains run unfused.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import batch_from_pylist
from presto_tpu_torch.config import DEFAULT, EngineConfig
from presto_tpu_torch.connectors.api import ConnectorRegistry
from presto_tpu_torch.exec.aggregation import (
    AggChannel, GlobalAggregationOperatorFactory,
    HashAggregationOperatorFactory,
)
from presto_tpu_torch.exec.driver import Pipeline
from presto_tpu_torch.exec.joinop import (
    HashBuildOperatorFactory, LookupJoinOperatorFactory,
)
from presto_tpu_torch.exec.nestedloop import (
    EnforceSingleRowOperatorFactory, NestedLoopBuildOperatorFactory,
    NestedLoopJoinOperatorFactory,
)
from presto_tpu_torch.exec.operators import (
    FilterProjectOperatorFactory, LimitOperatorFactory,
    OutputCollectorFactory, TableScanOperatorFactory, ValuesOperatorFactory,
)
from presto_tpu_torch.exec.sortop import OrderByOperatorFactory, SortSpec
from presto_tpu_torch.exec.streamagg import (
    StreamingAggregationOperatorFactory,
)
from presto_tpu_torch.exec.unionop import (
    UnionBuffer, UnionSinkOperatorFactory, UnionSourceOperatorFactory,
)
from presto_tpu_torch.exec.unnestop import UnnestOperatorFactory
from presto_tpu_torch.exec.windowop import (
    TopNRowNumberOperatorFactory, WindowOperatorFactory,
)
from presto_tpu_torch.expr import build as B
from presto_tpu_torch.expr.ir import Call, Constant, InputRef, RowExpression
from presto_tpu_torch.sql.plan import (
    AggregationNode, EnforceSingleRowNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanAggregate, PlanNode, ProjectNode, SemiJoinNode,
    SortNode, TableFinishNode, TableScanNode, TableWriterNode, UnionNode,
    UnnestNode, ValuesNode, WindowNode,
)

# plan nodes this package does not lower yet -> the ROADMAP item porting
# them
_NOT_PORTED = (
    (TableWriterNode, "A13 (distributed writes)"),
    (TableFinishNode, "A13 (distributed writes)"),
)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in presto_tpu_torch yet: ROADMAP {item}")


@dataclasses.dataclass
class PhysicalPlan:
    pipelines: List[Pipeline]
    collector: OutputCollectorFactory
    column_names: List[str]
    column_types: List[T.Type]


class PhysicalPlanner:
    def __init__(self, registry: ConnectorRegistry, device,
                 config: EngineConfig = DEFAULT):
        """Scans stage their batches on ``device``; every operator
        downstream works on the device of its input."""
        self.registry = registry
        self.device = device
        self.config = config
        self._done_pipelines: List[Pipeline] = []
        self._counter = 0

    def plan(self, root: OutputNode) -> PhysicalPlan:
        factories, splits = self._lower(root.source)
        collector = OutputCollectorFactory()
        factories.append(collector)
        self._done_pipelines.append(
            Pipeline(factories, splits, name="output"))
        return PhysicalPlan(self._done_pipelines, collector,
                            [n for n, _ in root.columns],
                            [t for _, t in root.columns])

    def plan_fragment(self, root: PlanNode,
                      sink_factory) -> List[Pipeline]:
        """Lower ``root`` and terminate it with ``sink_factory`` (the
        single-process write path's TableWriter) instead of the output
        collector."""
        factories, splits = self._lower(root)
        factories.append(sink_factory)
        self._done_pipelines.append(
            Pipeline(factories, splits, name="fragment"))
        return self._done_pipelines

    # -- lowering -----------------------------------------------------------
    def _lower(self, node: PlanNode):
        """Returns (operator factory chain, splits) producing node's
        output batches."""
        if isinstance(node, TableScanNode):
            conn = self.registry.get(node.catalog)
            handle = conn.get_table(node.table)
            # enough splits to feed task_concurrency drivers through the
            # LocalExchange tier (4x for balance, the reference's
            # split-batch shape)
            desired = (max(4 * self.config.task_concurrency, 4)
                       if self.config.task_concurrency > 1 else 1)
            splits = conn.get_splits(handle, desired)
            return ([TableScanOperatorFactory(
                conn, node.column_names, self.device,
                batch_rows=self.config.scan_batch_rows,
                table=node.table)], splits)
        if isinstance(node, ValuesNode):
            batch = batch_from_pylist(node.types, list(node.rows),
                                      self.device)
            return ([ValuesOperatorFactory([batch])], [])
        if isinstance(node, (FilterNode, ProjectNode)):
            return self._lower_filter_project(node)
        if isinstance(node, AggregationNode):
            return self._lower_aggregation(node)
        if isinstance(node, SortNode):
            chain, splits = self._lower(node.source)
            specs = [SortSpec(c, not asc, bool(nf))
                     for c, asc, nf in node.sort_keys]
            chain.append(OrderByOperatorFactory(specs))
            return chain, splits
        if isinstance(node, LimitNode):
            if isinstance(node.source, SortNode):
                # TopN fusion (TopNOperator.java:35 role): sort + limit
                # becomes one truncated sort
                chain, splits = self._lower(node.source.source)
                specs = [SortSpec(c, not asc, bool(nf))
                         for c, asc, nf in node.source.sort_keys]
                chain.append(OrderByOperatorFactory(specs, node.count))
                return chain, splits
            chain, splits = self._lower(node.source)
            chain.append(LimitOperatorFactory(node.count))
            return chain, splits
        if isinstance(node, JoinNode):
            return self._lower_join(node)
        if isinstance(node, SemiJoinNode):
            return self._lower_semijoin(node)
        if isinstance(node, EnforceSingleRowNode):
            chain, splits = self._lower(node.source)
            chain.append(EnforceSingleRowOperatorFactory(node.types,
                                                         self.device))
            return chain, splits
        if isinstance(node, WindowNode):
            chain, splits = self._lower(node.source)
            chain.append(WindowOperatorFactory(
                node.partition_channels, node.order_keys, node.functions))
            return chain, splits
        if isinstance(node, UnnestNode):
            chain, splits = self._lower(node.source)
            chain.append(UnnestOperatorFactory(
                node.replicate_channels, node.unnest_channels,
                node.ordinality, node.outer))
            return chain, splits
        if isinstance(node, UnionNode):
            buffer = UnionBuffer(len(node.inputs))
            for i, inp in enumerate(node.inputs):
                in_chain, in_splits = self._lower(inp)
                in_chain.append(UnionSinkOperatorFactory(buffer, i))
                self._done_pipelines.append(
                    Pipeline(in_chain, in_splits, name=self._name("union")))
            return [UnionSourceOperatorFactory(buffer)], []
        for cls, item in _NOT_PORTED:
            if isinstance(node, cls):
                raise _not_ported(f"{cls.__name__} lowering", item)
        # the remote sources of a plan fragment
        raise _not_ported(f"{type(node).__name__} lowering",
                          "A13 (distributed tier)")

    def _lower_filter_project(self, node: PlanNode):
        """Fuse adjacent Filter/Project chains into one PageProcessor-style
        operator (ScanFilterAndProjectOperator fusion)."""
        filters: List[RowExpression] = []
        projections: Optional[Tuple[RowExpression, ...]] = None
        cur = node
        # walk down: Project over (Filter*) — compose
        if isinstance(cur, ProjectNode):
            projections = cur.expressions
            cur = cur.source
        while isinstance(cur, FilterNode):
            filters.append(cur.predicate)
            cur = cur.source
        if (filters and isinstance(cur, WindowNode)
                and len(cur.functions) == 1
                and cur.functions[0].name == "row_number"):
            # TopNRowNumber fusion (TopNRowNumberOperator.java:38): a
            # row_number <= N conjunct becomes a per-partition truncation
            # inside the window sort; filtered rows never materialize
            rn_ch = len(cur.source.columns)
            limit, rest = _extract_rn_limit(filters, rn_ch)
            if limit is not None:
                chain, splits = self._lower(cur.source)
                chain.append(TopNRowNumberOperatorFactory(
                    cur.partition_channels, cur.order_keys, limit,
                    cur.columns[rn_ch][1]))
                return self._append_filter_project(
                    chain, splits, rest, projections,
                    [t for _, t in cur.columns])
        chain, splits = self._lower(cur)
        return self._append_filter_project(
            chain, splits, filters, projections,
            [t for _, t in cur.columns])

    @staticmethod
    def _append_filter_project(chain, splits, filters, projections,
                               input_types):
        filt = None
        if filters:
            filt = filters[-1]
            for f in reversed(filters[:-1]):
                filt = B.and_(filt, f)
        if projections is None:
            projections = tuple(InputRef(i, t)
                                for i, t in enumerate(input_types))
        chain.append(FilterProjectOperatorFactory(
            filt, list(projections), input_types))
        return chain, splits

    def _lower_aggregation(self, node: AggregationNode):
        """``single`` and ``partial`` steps decompose the aggregates into
        primitive channels; a ``partial`` step emits the raw component
        columns (keys first), which its ``final`` step merges (the
        optimizer splits an aggregation over a UNION this way)."""
        if node.step == "final":
            return self._lower_final_aggregation(node)
        chain, splits = self._lower(node.source)
        input_types = [t for _, t in node.source.columns]

        pre_exprs, agg_channels, finalize_specs = decompose_aggregates(
            node.aggregates, input_types)

        if len(pre_exprs) > len(input_types):
            pre_types = [e.type for e in pre_exprs]
            chain.append(FilterProjectOperatorFactory(
                None, pre_exprs, input_types))
            input_types = pre_types

        ngroups = len(node.group_channels)
        if ngroups and self._streaming_eligible(
                chain, node.group_channels, agg_channels, input_types):
            chain.append(StreamingAggregationOperatorFactory(
                list(node.group_channels), agg_channels, input_types))
        elif ngroups:
            chain.append(HashAggregationOperatorFactory(
                list(node.group_channels), agg_channels, input_types))
        else:
            chain.append(GlobalAggregationOperatorFactory(
                agg_channels, input_types, self.device))
        if node.step == "partial":
            return chain, splits
        key_types = [input_types[c] for c in node.group_channels]
        self._append_finalize(chain, node, key_types, agg_channels,
                              finalize_specs)
        return chain, splits

    def _streaming_eligible(self, chain, group_channels, agg_channels,
                            input_types) -> bool:
        """True when the group keys trace to a prefix of the scan's
        declared sort order (rows arrive clustered by the keys), so the
        sort-free streaming aggregation applies
        (StreamingAggregationOperator.java:38; eligibility is the
        reference's LocalProperties/StreamPropertyDerivations check)."""
        if not self.config.streaming_aggregation_enabled:
            return False
        for ch in agg_channels:
            if ch.prim not in ("sum", "count", "min", "max"):
                return False
            if (ch.prim in ("min", "max") and ch.channel is not None
                    and input_types[ch.channel].is_dictionary):
                # the carry merge would compare interning codes
                return False
        traced = []
        scan = None
        for g in group_channels:
            hit = scan_column_for_channel(chain, g)
            if hit is None:
                return False
            f, col = hit
            if scan is None:
                scan = f
            elif scan is not f:
                return False
            traced.append(col)
        order = scan.connector.sort_order(
            scan.connector.get_table(scan.table))
        k = len(traced)
        return bool(order) and set(traced) == set(order[:k])

    def _lower_final_aggregation(self, node: AggregationNode):
        """FINAL step over a partial's output: [keys..., comp0, comp1, ...].
        Re-aggregates each component with its merge primitive, then runs
        the single-step finalize projection."""
        chain, splits = self._lower(node.source)
        input_types = [t for _, t in node.source.columns]
        ngroups = len(node.group_channels)
        agg_channels, finalize_specs = merge_agg_channels(
            node.aggregates, ngroups)
        if ngroups:
            chain.append(HashAggregationOperatorFactory(
                list(node.group_channels), agg_channels, input_types))
        else:
            chain.append(GlobalAggregationOperatorFactory(
                agg_channels, input_types, self.device))
        key_types = [input_types[c] for c in node.group_channels]
        self._append_finalize(chain, node, key_types, agg_channels,
                              finalize_specs)
        return chain, splits

    @staticmethod
    def _append_finalize(chain: List, node: AggregationNode, key_types,
                         agg_channels, finalize_specs) -> None:
        """The finalize projection [keys..., finalized aggs...], where it
        is not the identity."""
        ngroups = len(key_types)
        post_in = list(key_types) + [a.out_type for a in agg_channels]
        exprs: List[RowExpression] = [InputRef(i, t)
                                      for i, t in enumerate(key_types)]
        for agg, comps in finalize_specs:
            base = [InputRef(ngroups + c, agg_channels[c].out_type)
                    for c in comps]
            exprs.append(_finalize(agg, base))
        if (len(exprs) != len(post_in)
                or any(not isinstance(e, InputRef) or e.index != i
                       for i, e in enumerate(exprs))):
            chain.append(FilterProjectOperatorFactory(
                None, exprs, post_in))

    def _insert_dynamic_filter(self, chain: List, dyn,
                               key_channels: List[int]) -> None:
        """Place the runtime filter as close to the scan as channel
        provenance allows (the reference pushes dynamic filters into the
        probe-side TableScan, LocalDynamicFilter.java:45): walk backwards
        over FilterProject stages remapping key channels through pure
        InputRef projections, stopping at any operator that changes row
        identity."""
        from presto_tpu_torch.exec.dynamicfilter import (
            DynamicFilterOperatorFactory,
        )

        pos = len(chain)
        keys = list(key_channels)
        i = len(chain) - 1
        while i >= 0:
            f = chain[i]
            if not isinstance(f, FilterProjectOperatorFactory):
                break
            mapped = []
            for k in keys:
                p = f.projections[k] if k < len(f.projections) else None
                if not isinstance(p, InputRef):
                    mapped = None
                    break
                mapped.append(p.index)
            if mapped is None:
                break
            keys = mapped
            pos = i
            i -= 1
        chain.insert(pos, DynamicFilterOperatorFactory(dyn, keys))

    def _lower_join(self, node: JoinNode):
        if node.kind == "cross":
            build_chain, build_splits = self._lower(node.right)
            build = NestedLoopBuildOperatorFactory(
                [t for _, t in node.right.columns])
            build_chain.append(build)
            self._done_pipelines.append(
                Pipeline(build_chain, build_splits,
                         name=self._name("xbuild")))
            chain, splits = self._lower(node.left)
            chain.append(NestedLoopJoinOperatorFactory(build))
            return chain, splits
        if node.kind not in ("inner", "left"):
            # the planner composes right and full joins from left and
            # anti joins; a bare one has no operator
            raise NotImplementedError(f"{node.kind} join")
        build_chain, build_splits = self._lower(node.right)
        chain, splits = self._lower(node.left)
        dyn = None
        if node.kind == "inner" and self.config.dynamic_filtering_enabled:
            from presto_tpu_torch.exec.dynamicfilter import DynamicFilter

            dyn = DynamicFilter(len(node.right_keys))
        build = HashBuildOperatorFactory(
            list(node.right_keys), [t for _, t in node.right.columns],
            dynamic_filter=dyn)
        build_chain.append(build)
        self._done_pipelines.append(
            Pipeline(build_chain, build_splits, name=self._name("build")))
        if dyn is not None:
            self._insert_dynamic_filter(chain, dyn, list(node.left_keys))
        chain.append(LookupJoinOperatorFactory(
            build, list(node.left_keys), [t for _, t in node.left.columns],
            join_type=node.kind))
        if node.residual is not None:
            if node.kind != "inner":
                raise NotImplementedError("left-join residual not supported")
            types = [t for _, t in node.columns]
            proj = [InputRef(i, t) for i, t in enumerate(types)]
            chain.append(FilterProjectOperatorFactory(
                node.residual, proj, types))
        return chain, splits

    def _lower_semijoin(self, node: SemiJoinNode):
        dyn = None
        if not node.negated and self.config.dynamic_filtering_enabled:
            from presto_tpu_torch.exec.dynamicfilter import DynamicFilter

            dyn = DynamicFilter(len(node.filtering_keys))
        build_chain, build_splits = self._lower(node.filtering)
        build = HashBuildOperatorFactory(
            list(node.filtering_keys),
            [t for _, t in node.filtering.columns], dynamic_filter=dyn)
        build_chain.append(build)
        self._done_pipelines.append(
            Pipeline(build_chain, build_splits, name=self._name("sbuild")))
        chain, splits = self._lower(node.source)
        if dyn is not None:
            self._insert_dynamic_filter(chain, dyn, list(node.source_keys))
        chain.append(LookupJoinOperatorFactory(
            build, list(node.source_keys),
            [t for _, t in node.source.columns],
            join_type="anti" if node.negated else "semi",
            residual=node.residual, null_aware=node.null_aware))
        return chain, splits

    def _name(self, prefix: str) -> str:
        self._counter += 1
        return f"{prefix}{self._counter}"


def scan_column_for_channel(factories: Sequence, channel: int):
    """Trace an output channel of a factory chain back to its scan
    column through pure InputRef projections.  Returns
    (TableScanOperatorFactory, column_name) or None (the channel is
    computed, or the chain has no scan)."""
    ch = channel
    for f in reversed(list(factories)):
        if isinstance(f, FilterProjectOperatorFactory):
            if ch >= len(f.projections):
                return None
            p = f.projections[ch]
            if not isinstance(p, InputRef):
                return None
            ch = p.index
        elif isinstance(f, TableScanOperatorFactory):
            if ch >= len(f.columns):
                return None
            return f, f.columns[ch]
        else:
            return None
    return None


def _extract_rn_limit(filters, rn_channel: int):
    """Find one ``row_number <= K`` upper bound among the filter
    conjuncts; returns (K | None, remaining conjuncts)."""
    from presto_tpu_torch.sql.optimizer import split_and

    conjuncts = []
    for f in filters:
        conjuncts.extend(split_and(f))
    limit = None
    rest = []
    for c in conjuncts:
        k = None
        if (limit is None and isinstance(c, Call)
                and c.name in ("le", "lt", "eq", "ge", "gt")
                and len(c.args) == 2):
            a, b = c.args
            op = c.name
            if isinstance(b, InputRef) and isinstance(a, Constant):
                a, b = b, a
                op = {"lt": "gt", "le": "ge",
                      "gt": "lt", "ge": "le"}.get(op, op)
            if (isinstance(a, InputRef) and a.index == rn_channel
                    and isinstance(b, Constant)
                    and isinstance(b.value, int)):
                if op == "le":
                    k = b.value
                elif op == "lt":
                    k = b.value - 1
                elif op == "eq" and b.value == 1:
                    k = 1
        if k is not None and k >= 1:
            # the per-partition truncation IS the bound (le/lt/eq-1 all
            # keep exactly rows with rn <= k)
            limit = k
            continue
        rest.append(c)
    return limit, rest


def _coerce_to(expr: RowExpression, typ: T.Type) -> RowExpression:
    if expr.type == typ:
        return expr
    return B.cast(expr, typ)


def decompose_aggregates(aggregates: Sequence[PlanAggregate],
                         input_types: Sequence[T.Type]):
    """Aggregate specs -> primitive channels (the AccumulatorCompiler
    decomposition, shared by the operator and mesh lowerings).

    Returns (pre_exprs, agg_channels, finalize_specs): ``pre_exprs`` is the
    pre-projection (identity refs plus any derived channels such as x*x for
    sumsq); a pre-projection is needed iff len(pre_exprs) > len(input_types).
    """
    pre_exprs: List[RowExpression] = [
        InputRef(i, t) for i, t in enumerate(input_types)]
    agg_channels: List[AggChannel] = []
    finalize_specs: List[Tuple[PlanAggregate, List[int]]] = []
    for agg in aggregates:
        comp_channels: List[int] = []
        for prim, ctype in agg.spec.components:
            if agg.channel is None:
                agg_channels.append(AggChannel("count", None, ctype))
                comp_channels.append(len(agg_channels) - 1)
                continue
            in_ref = InputRef(agg.channel, input_types[agg.channel])
            if prim == "sumsq":
                sq = B.call("multiply", in_ref, in_ref)
                pre_exprs.append(_coerce_to(sq, ctype))
                ch = len(pre_exprs) - 1
                agg_channels.append(AggChannel("sum", ch, ctype))
            elif prim in ("sum", "min", "max", "count"):
                arg = in_ref
                if prim == "sum" and arg.type != ctype:
                    pre_exprs.append(_coerce_to(arg, ctype))
                    ch = len(pre_exprs) - 1
                else:
                    ch = agg.channel
                agg_channels.append(AggChannel(prim, ch, ctype))
            elif prim in ("collect", "hll", "kll"):
                agg_channels.append(
                    AggChannel(prim, agg.channel, ctype))
            elif prim == "sumln":
                ln = B.call("ln", _coerce_to(in_ref, T.DOUBLE))
                pre_exprs.append(ln)
                agg_channels.append(
                    AggChannel("sum", len(pre_exprs) - 1, ctype))
            elif prim == "sumhash":
                h = B.call("hash64", in_ref)
                pre_exprs.append(h)
                agg_channels.append(
                    AggChannel("sum", len(pre_exprs) - 1, ctype))
            else:
                raise NotImplementedError(f"agg component {prim}")
            comp_channels.append(len(agg_channels) - 1)
        finalize_specs.append((agg, comp_channels))
    return pre_exprs, agg_channels, finalize_specs


# merge primitive for each partial component primitive (the collect merge
# flattens the partial step's arrays, exec/aggregation.py host_aggregate)
_FINAL_PRIM = {"count": "sum", "sum": "sum", "sumsq": "sum", "min": "min",
               "max": "max", "sumln": "sum", "sumhash": "sum",
               "collect": "collect_merge", "hll": "hll_merge",
               "kll": "kll_merge"}


def merge_agg_channels(aggregates: Sequence[PlanAggregate], ngroups: int):
    """FINAL-step channels: re-aggregate each partial component with its
    merge primitive (HashAggregationOperator.Step:61 role)."""
    agg_channels: List[AggChannel] = []
    finalize_specs: List[Tuple[PlanAggregate, List[int]]] = []
    comp_ch = ngroups
    for agg in aggregates:
        comp_channels: List[int] = []
        for prim, ctype in agg.spec.components:
            agg_channels.append(AggChannel(_FINAL_PRIM[prim], comp_ch,
                                           ctype))
            comp_channels.append(len(agg_channels) - 1)
            comp_ch += 1
        finalize_specs.append((agg, comp_channels))
    return agg_channels, finalize_specs


def _finalize(agg: PlanAggregate, comps: List[RowExpression]
              ) -> RowExpression:
    fin = agg.spec.finalize
    if fin == "identity":
        out = comps[0]
        if out.type != agg.spec.result_type:
            out = B.cast(out, agg.spec.result_type)
        return out
    if fin == "avg":
        s, c = comps
        if agg.spec.result_type.name == "double":
            return B.call("divide", _coerce_to(s, T.DOUBLE),
                          B.cast(c, T.DOUBLE))
        return B.call("divide", s, c)
    if fin == "map_agg":
        return B.call("$rows_map_agg", comps[0])
    if fin in ("min_by", "max_by"):
        return B.call(f"$rows_{fin}", comps[0])
    if fin == "approx_distinct":
        return B.call("$hll_cardinality", comps[0])
    if fin.startswith("approx_percentile:"):
        from presto_tpu_torch.expr import functions as F
        from presto_tpu_torch.expr.ir import Call

        p = float(fin.split(":", 1)[1])
        fn = F.resolve_kll_percentile(agg.spec.result_type, p)
        return Call("$kll_percentile", (comps[0],), fn.result_type, fn)
    if fin in ("corr", "covar_samp", "covar_pop", "regr_slope",
               "regr_intercept"):
        return B.call(f"$rows_{fin}", comps[0])
    if fin in ("learn_classifier", "learn_regressor"):
        return B.call(f"$rows_{fin}", comps[0])
    if fin == "geometric_mean":
        s, n = comps
        return B.call("exp", B.call("divide", s, B.cast(n, T.DOUBLE)))
    if fin in ("stddev_samp", "stddev_pop", "var_samp", "var_pop"):
        s, sq, n = comps
        nd = B.cast(n, T.DOUBLE)
        mean_sq = B.call("divide", B.call("multiply", s, s), nd)
        num = B.call("subtract", sq, mean_sq)
        if fin.endswith("_pop"):
            var = B.call("divide", num, nd)
        else:
            var = B.call("divide", num,
                         B.call("subtract", nd, B.const(1.0, T.DOUBLE)))
        if fin.startswith("stddev"):
            return B.call("sqrt", var)
        return var
    raise NotImplementedError(f"finalize {fin}")
