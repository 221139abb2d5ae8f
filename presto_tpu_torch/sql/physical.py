"""Physical planner: logical PlanNode tree -> executable Pipelines.

The LocalExecutionPlanner analogue (presto-main/.../sql/planner/
LocalExecutionPlanner.java:291): a bottom-up visitor mapping each PlanNode
to OperatorFactory chains.

Aggregate decomposition happens here: a PlanAggregate's AggSpec components
become primitive AggChannels (sum/count/min/max; sumsq pre-projects x*x)
and ``finalize`` becomes a post-aggregation projection (avg = sum/count,
stddev/variance from the moment components) — the role the reference's
AccumulatorCompiler + partial/final Step split plays.

This package lowers scans, filter/project, aggregation, inner and left
hash joins (with dynamic filters), ORDER BY, TopN, LIMIT and the output;
the runner adds the local exchange.  Every other node raises
``NotImplementedError`` naming the ROADMAP item that ports it.  There is
no pipeline-fusion post-pass: the chains run unfused.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
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
from presto_tpu_torch.exec.operators import (
    FilterProjectOperatorFactory, LimitOperatorFactory,
    OutputCollectorFactory, TableScanOperatorFactory,
)
from presto_tpu_torch.exec.sortop import OrderByOperatorFactory, SortSpec
from presto_tpu_torch.expr import build as B
from presto_tpu_torch.expr.ir import InputRef, RowExpression
from presto_tpu_torch.sql.plan import (
    AggregationNode, EnforceSingleRowNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanAggregate, PlanNode, ProjectNode, SemiJoinNode,
    SortNode, TableFinishNode, TableScanNode, TableWriterNode, UnionNode,
    UnnestNode, ValuesNode, WindowNode,
)

# plan nodes this package does not lower yet -> the ROADMAP item porting
# them
_NOT_PORTED = (
    (SemiJoinNode, "A4 (semi and anti joins)"),
    (ValuesNode, "A5 (values)"),
    (EnforceSingleRowNode, "A5 (nested-loop operators)"),
    (WindowNode, "A5 (window functions)"),
    (UnnestNode, "A5 (unnest)"),
    (UnionNode, "A5 (union)"),
    (TableWriterNode, "A5 (writes)"),
    (TableFinishNode, "A5 (writes)"),
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
        for cls, item in _NOT_PORTED:
            if isinstance(node, cls):
                raise _not_ported(f"{cls.__name__} lowering", item)
        raise _not_ported(f"{type(node).__name__} lowering", "A5/A6")

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
        chain, splits = self._lower(cur)
        input_types = [t for _, t in cur.columns]
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
        if node.step != "single":
            raise _not_ported(f"{node.step} aggregation step",
                              "A5 (union) / A6 (distributed tier)")
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
        if ngroups:
            chain.append(HashAggregationOperatorFactory(
                list(node.group_channels), agg_channels, input_types))
        else:
            chain.append(GlobalAggregationOperatorFactory(
                agg_channels, input_types))

        # finalize projection: [keys..., finalized aggs...]
        key_types = [input_types[c] for c in node.group_channels]
        post_in = key_types + [a.out_type for a in agg_channels]
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
        return chain, splits


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
        if node.kind not in ("inner", "left"):
            item = ("A5 (nested-loop operators)" if node.kind == "cross"
                    else "A4 (right and full joins)")
            raise _not_ported(f"{node.kind} join", item)
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

    def _name(self, prefix: str) -> str:
        self._counter += 1
        return f"{prefix}{self._counter}"


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
        return B.call("map_from_entries", comps[0])
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
