"""Iterative rule-based optimizer.

The reference drives 113 pattern rules to fixpoint over a Memo of plan
groups (presto-main/.../sql/planner/iterative/IterativeOptimizer.java,
Memo.java, iterative/rule/).  This module plays that role for the
immutable-dataclass plan tree: each Rule pattern-matches one node and
returns a replacement (or None), and ``iterative_optimize`` applies the
rule set bottom-up to fixpoint with an explicit rewrite budget (the
IterativeOptimizer timeout analogue).  This destructive fixpointing
serves the always-good rules below (each fires only when it improves
the plan); decisions that need to HOLD alternatives — join order,
exchange placement — run the same Rule protocol non-destructively over
Memo groups in sql/memo.py, where cost extraction picks the winner.

Rules implemented (reference analogues cited per class):
- MergeFilters, MergeLimits
- PushLimitThroughProject / PushLimitThroughUnion
- PushPartialAggregationThroughUnion (partial->final split, the
  PushPartialAggregationThroughExchange idea applied at the logical
  tier; the fragmenter re-uses the same partial/final contract across
  remote exchanges)
- PushProjectionThroughJoin (computed single-side expressions evaluate
  below the join on preserved sides)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.expr.ir import InputRef, RowExpression, input_channels
from presto_tpu_torch.sql.plan import (
    AggregationNode, FilterNode, JoinNode, LimitNode, PlanNode,
    ProjectNode, UnionNode,
)


class RuleContext:
    def __init__(self, metadata=None, config=None):
        self.metadata = metadata
        self.config = config


class Rule:
    name = "rule"

    def apply(self, node: PlanNode,
              ctx: RuleContext) -> Optional[PlanNode]:
        raise NotImplementedError


class MergeFilters(Rule):
    """Filter(Filter(x)) -> Filter(x) with ANDed predicates
    (MergeFilters.java role)."""

    name = "merge_filters"

    def apply(self, node, ctx):
        if isinstance(node, FilterNode) \
                and isinstance(node.source, FilterNode):
            from presto_tpu_torch.expr import build as B

            return FilterNode(node.source.source,
                              B.and_(node.source.predicate,
                                     node.predicate))
        return None


class MergeLimits(Rule):
    """Limit(n, Limit(m, x)) -> Limit(min(n, m), x)
    (MergeLimits.java role)."""

    name = "merge_limits"

    def apply(self, node, ctx):
        if isinstance(node, LimitNode) \
                and isinstance(node.source, LimitNode):
            return LimitNode(node.source.source,
                             min(node.count, node.source.count))
        return None


class PushLimitThroughProject(Rule):
    """Limit(Project(x)) -> Project(Limit(x))
    (PushLimitThroughProject.java role): lets limits reach sorts/scans
    and shrinks the rows the projection evaluates."""

    name = "push_limit_through_project"

    def apply(self, node, ctx):
        if isinstance(node, LimitNode) \
                and isinstance(node.source, ProjectNode):
            p = node.source
            return ProjectNode(LimitNode(p.source, node.count),
                               p.expressions, p.columns)
        return None


class PushLimitThroughUnion(Rule):
    """Limit(Union(b...)) -> Limit(Union(Limit(b)...))
    (PushLimitThroughUnion.java role): each branch produces at most n
    rows before the concatenation."""

    name = "push_limit_through_union"

    def apply(self, node, ctx):
        if not (isinstance(node, LimitNode)
                and isinstance(node.source, UnionNode)):
            return None
        u = node.source
        if all(isinstance(b, LimitNode) and b.count <= node.count
               for b in u.inputs):
            return None  # already pushed (fixpoint guard)
        branches = tuple(
            b if isinstance(b, LimitNode) and b.count <= node.count
            else LimitNode(b, node.count)
            for b in u.inputs)
        return LimitNode(UnionNode(branches, u.columns), node.count)


class PushProjectionThroughUnion(Rule):
    """Project(Union(b...)) -> Union(Project(b)...)
    (PushProjectionThroughUnion.java role): normalizes plans so
    union-aware rules (partial aggregation, limits) see the union
    directly, and evaluates projections in the branch pipelines."""

    name = "push_projection_through_union"

    def apply(self, node, ctx):
        if not (isinstance(node, ProjectNode)
                and isinstance(node.source, UnionNode)):
            return None
        u = node.source
        branches = tuple(
            ProjectNode(b, node.expressions, node.columns)
            for b in u.inputs)
        return UnionNode(branches, node.columns)


class PushPartialAggregationThroughUnion(Rule):
    """Aggregate(single, Union) -> Aggregate(final, Union(Aggregate(
    partial, branch)...)).

    The PushPartialAggregationThroughExchange idea
    (presto-main/.../iterative/rule/
    PushPartialAggregationThroughExchange.java) applied where the
    logical plan itself concatenates streams: each UNION ALL branch
    pre-aggregates into the spec's component columns and the final step
    merges them, so the union moves group-sized — not row-sized — data.
    The fragmenter's partial/final split across remote exchanges uses
    the identical component-column contract (server/fragmenter.py)."""

    name = "push_partial_agg_through_union"

    def apply(self, node, ctx):
        if not (isinstance(node, AggregationNode)
                and node.step == "single"
                and isinstance(node.source, UnionNode)
                and node.aggregates
                and not any(a.distinct for a in node.aggregates)):
            return None
        u = node.source
        ngroups = len(node.group_channels)
        comp_cols: List[Tuple[str, T.Type]] = [
            node.columns[i] for i in range(ngroups)]
        ci = 0
        for agg in node.aggregates:
            for _prim, ctype in agg.spec.components:
                comp_cols.append((f"$comp{ci}", ctype))
                ci += 1
        partials = tuple(
            AggregationNode(b, node.group_channels, node.aggregates,
                            tuple(comp_cols), step="partial")
            for b in u.inputs)
        union = UnionNode(partials, tuple(comp_cols))
        return AggregationNode(union, tuple(range(ngroups)),
                               node.aggregates, node.columns,
                               step="final")


class PushProjectionThroughJoin(Rule):
    """Project(Join): computed expressions that reference only one
    PRESERVED side evaluate below the join
    (PushProjectionThroughJoin.java role).  Inner/cross joins preserve
    both sides; LEFT preserves the left only (a computed right-side
    column must null-extend, which computing below would break)."""

    name = "push_projection_through_join"

    def apply(self, node, ctx):
        if not (isinstance(node, ProjectNode)
                and isinstance(node.source, JoinNode)):
            return None
        join = node.source
        sides_ok = {"inner": (True, True), "cross": (True, True),
                    "left": (True, False)}.get(join.kind)
        if sides_ok is None:
            return None
        nleft = len(join.left.columns)
        push_left: List[int] = []
        push_right: List[int] = []
        for i, e in enumerate(node.expressions):
            if isinstance(e, InputRef):
                continue
            chans = input_channels(e)
            if not chans:
                continue
            if sides_ok[0] and all(ch < nleft for ch in chans):
                push_left.append(i)
            elif sides_ok[1] and all(ch >= nleft for ch in chans):
                push_right.append(i)
        if not push_left and not push_right:
            return None

        from presto_tpu_torch.sql.optimizer import remap

        def extend(child, indices, offset):
            exprs = [InputRef(j, t)
                     for j, (_n, t) in enumerate(child.columns)]
            cols = list(child.columns)
            pos = {}
            for i in indices:
                e = remap(node.expressions[i],
                          {ch: ch - offset
                           for ch in input_channels(node.expressions[i])})
                pos[i] = len(exprs)
                exprs.append(e)
                cols.append((f"$push{i}", e.type))
            return (ProjectNode(child, tuple(exprs), tuple(cols)), pos)

        new_left, lpos = extend(join.left, push_left, 0)
        new_right, rpos = extend(join.right, push_right, nleft)
        nleft_new = len(new_left.columns)
        # old join output channel -> new join output channel
        shift = {ch: ch for ch in range(nleft)}
        for ch in range(nleft, len(join.columns)):
            shift[ch] = ch - nleft + nleft_new
        cols = tuple(new_left.columns) + tuple(new_right.columns)
        residual = (remap(join.residual, shift)
                    if join.residual is not None else None)
        new_join = dataclasses.replace(
            join, left=new_left, right=new_right, columns=cols,
            right_keys=join.right_keys, residual=residual)
        out_exprs: List[RowExpression] = []
        for i, e in enumerate(node.expressions):
            if i in lpos:
                out_exprs.append(InputRef(lpos[i], e.type))
            elif i in rpos:
                out_exprs.append(InputRef(nleft_new + rpos[i], e.type))
            else:
                out_exprs.append(remap(e, {ch: shift[ch]
                                           for ch in input_channels(e)}))
        return ProjectNode(new_join, tuple(out_exprs), node.columns)


DEFAULT_RULES: Sequence[Rule] = (
    MergeFilters(), MergeLimits(), PushLimitThroughProject(),
    PushLimitThroughUnion(), PushProjectionThroughUnion(),
    PushPartialAggregationThroughUnion(), PushProjectionThroughJoin(),
)


def _children(node: PlanNode) -> List[PlanNode]:
    return list(node.sources)


def iterative_optimize(node: PlanNode, rules: Sequence[Rule],
                       ctx: RuleContext,
                       budget: int = 10_000) -> PlanNode:
    """Bottom-up rewrite to fixpoint.  Each position retries the whole
    rule list until none fires (then its subtree is stable, because
    rules only ever return strictly-rewritten nodes); the global budget
    bounds pathological rule interactions the way the reference's
    optimizer timeout does."""
    from presto_tpu_torch.sql.optimizer import _replace_sources

    fired = [0]

    def rewrite(n: PlanNode) -> PlanNode:
        n = _replace_sources(n, [rewrite(s) for s in n.sources])
        progress = True
        while progress and fired[0] < budget:
            progress = False
            for rule in rules:
                out = rule.apply(n, ctx)
                if out is not None:
                    fired[0] += 1
                    # a rule may expose new matches below its result
                    n = _replace_sources(
                        out, [rewrite(s) for s in out.sources])
                    progress = True
                    break
        return n

    return rewrite(node)
