"""Logical plan optimizer.

The reference runs ~40 ordered passes (PlanOptimizers.java:160) with 113
iterative rules; this module implements the subset that changes the game
for the executable query shapes, in the same spirit:

- ``build_join_graph`` + ``extract_joins``: Filter-over-cross-join ->
  equi-join tree with pushed single-relation predicates and residual
  placement (the PredicatePushDown + join-graph part of the reference's
  AddExchanges preparation).  With ``optimizer_use_memo`` on (default)
  the graph feeds the Memo-based ReorderJoins/DetermineJoinDistribution
  exploration in sql/memo.py; this module's greedy orderer (left-deep,
  probe side = largest estimated relation) is the fallback when stats
  are absent or the graph exceeds the enumeration bound.
- ``prune_columns``: unreferenced-output elimination down to the scans
  (PruneUnreferencedOutputs + pushdown-into-scan).
- ``rewrite_distinct_aggregates``: count(DISTINCT x) -> two-level
  aggregation (SingleDistinctAggregationToGroupBy rule analogue).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import build as B
from presto_tpu_torch.expr.functions import resolve_aggregate
from presto_tpu_torch.expr.ir import (
    Call, Constant, InputRef, RowExpression, SpecialForm, input_channels,
)
from presto_tpu_torch.sql.plan import (
    AggregationNode, EnforceSingleRowNode, FilterNode, JoinNode, LimitNode,
    OutputNode, PlanAggregate, PlanNode, ProjectNode, SemiJoinNode,
    SortNode, TableScanNode, UnionNode, UnnestNode, ValuesNode, WindowNode,
)


def optimize(plan: OutputNode, metadata=None, config=None) -> OutputNode:
    """Optimizer pipeline.  ``config`` carries the session-steerable
    policies (join_reordering_strategy, ... — the SystemSessionProperties
    reaching PlanOptimizers role); None = engine defaults."""
    from presto_tpu_torch.config import DEFAULT

    from presto_tpu_torch.sql.rules import (
        DEFAULT_RULES, RuleContext, iterative_optimize,
    )

    config = config or DEFAULT
    ctx = RuleContext(metadata, config)
    node = push_filters_down(plan)
    # iterative rule engine (IterativeOptimizer role) runs before join
    # extraction (limits/filters normalize, partial aggs split through
    # unions) and again after (projection-through-join sees the built
    # join tree)
    node = iterative_optimize(node, DEFAULT_RULES, ctx)
    node = _rewrite_bottom_up(node, metadata, config)
    node = iterative_optimize(node, DEFAULT_RULES, ctx)
    node = prune_columns(node)
    return node


# ---------------------------------------------------------------------------
# expression channel remapping
# ---------------------------------------------------------------------------

def remap(expr: RowExpression, mapping: Dict[int, int]) -> RowExpression:
    if isinstance(expr, InputRef):
        return InputRef(mapping[expr.index], expr.type)
    if isinstance(expr, Call):
        return Call(expr.name, tuple(remap(a, mapping) for a in expr.args),
                    expr.type, expr.fn)
    if isinstance(expr, SpecialForm):
        return SpecialForm(expr.form,
                           tuple(remap(a, mapping) for a in expr.args),
                           expr.type)
    return expr


def split_and(expr: RowExpression) -> List[RowExpression]:
    if isinstance(expr, SpecialForm) and expr.form == "AND":
        out: List[RowExpression] = []
        for a in expr.args:
            out.extend(split_and(a))
        return out
    return [expr]


def and_all(exprs: Sequence[RowExpression]) -> RowExpression:
    out = exprs[0]
    for e in exprs[1:]:
        out = B.and_(out, e)
    return out


# ---------------------------------------------------------------------------
# join extraction
# ---------------------------------------------------------------------------

def substitute(expr: RowExpression,
               exprs: Sequence[RowExpression]) -> RowExpression:
    """Replace InputRef(i) with exprs[i] (pushdown through a projection)."""
    if isinstance(expr, InputRef):
        return exprs[expr.index]
    if isinstance(expr, Call):
        return dataclasses.replace(
            expr, args=tuple(substitute(a, exprs) for a in expr.args))
    if isinstance(expr, SpecialForm):
        return dataclasses.replace(
            expr, args=tuple(substitute(a, exprs) for a in expr.args))
    return expr


def _push_filter(node: FilterNode) -> PlanNode:
    """One predicate-pushdown step (PredicatePushDown.java role): move
    eligible conjuncts below Filter/Project/outer-Join/SemiJoin/Union.
    Returns ``node`` unchanged when nothing can move."""
    src = node.source
    conjuncts = split_and(node.predicate)
    if isinstance(src, FilterNode):
        return FilterNode(src.source,
                          and_all(conjuncts + split_and(src.predicate)))
    if isinstance(src, ProjectNode):
        # substitution is safe: projections are pure expressions
        below = [substitute(c, src.expressions) for c in conjuncts]
        return ProjectNode(FilterNode(src.source, and_all(below)),
                           src.expressions, src.columns)
    if isinstance(src, JoinNode) and src.kind in ("left",):
        nleft = len(src.left.columns)
        pushable = [c for c in conjuncts
                    if all(ch < nleft for ch in input_channels(c))]
        rest = [c for c in conjuncts if c not in pushable]
        if pushable:
            new_left = FilterNode(src.left, and_all(pushable))
            new_join = dataclasses.replace(src, left=new_left)
            return (FilterNode(new_join, and_all(rest)) if rest
                    else new_join)
    if isinstance(src, SemiJoinNode):
        nsrc = len(src.source.columns)
        pushable = [c for c in conjuncts
                    if all(ch < nsrc for ch in input_channels(c))]
        rest = [c for c in conjuncts if c not in pushable]
        if pushable:
            new_inner = FilterNode(src.source, and_all(pushable))
            new_semi = dataclasses.replace(src, source=new_inner)
            return (FilterNode(new_semi, and_all(rest)) if rest
                    else new_semi)
    if isinstance(src, UnionNode):
        return UnionNode(tuple(
            FilterNode(inp, node.predicate) for inp in src.inputs),
            src.columns)
    return node


def push_filters_down(node: PlanNode) -> PlanNode:
    """Top-down predicate pushdown to fixpoint: conjuncts only ever move
    downward, so one sweep terminates."""
    while isinstance(node, FilterNode):
        pushed = _push_filter(node)
        if pushed is node:
            break
        node = pushed
    return _replace_sources(node,
                            [push_filters_down(s) for s in node.sources])


def _cross_chain(leaves: List[PlanNode]) -> PlanNode:
    cur = leaves[0]
    for leaf in leaves[1:]:
        cur = JoinNode("cross", cur, leaf, (), (),
                       tuple(cur.columns) + tuple(leaf.columns))
    return cur


def _rewrite_bottom_up(node: PlanNode, metadata, config=None) -> PlanNode:
    # Filter-over-join-chain (and bare chains): flatten BEFORE recursing
    # so WHERE conjuncts and ON keys place together during join
    # reordering (ReorderJoins + PredicatePushDown interplay); recursion
    # descends into the chain's leaves only, so extraction runs once.
    chain = None
    extra: List[RowExpression] = []
    if isinstance(node, FilterNode) and _is_join_chain(node.source):
        chain, extra = node.source, split_and(node.predicate)
    elif _is_join_chain(node) and _chain_size(node) > 2:
        chain = node
    if chain is not None:
        tree, conjs = _flatten_joins(chain)
        leaves = [_rewrite_bottom_up(l, metadata, config)
                  for l in _cross_leaves(tree)]
        tree = _cross_chain(leaves)
        conjs = conjs + extra
        if conjs:
            fnode = FilterNode(tree, and_all(conjs))
            if (config is not None and config.optimizer_use_memo
                    and config.join_reordering_strategy != "none"):
                from presto_tpu_torch.sql.memo import try_memo_extract_joins

                out = try_memo_extract_joins(fnode, metadata, config)
                if out is not None:   # None: stats absent / graph too big
                    return out
            return extract_joins(fnode, metadata, config)
        return tree

    node = _replace_sources(
        node, [_rewrite_bottom_up(s, metadata, config) for s in node.sources])
    if isinstance(node, AggregationNode) and any(
            a.distinct for a in node.aggregates):
        return rewrite_distinct_aggregates(node)
    return node


def _replace_sources(node: PlanNode,
                     sources: List[PlanNode]) -> PlanNode:
    if not sources:
        return node
    fields: Dict[str, object] = {}
    names = [f.name for f in dataclasses.fields(node)]
    if "source" in names:
        fields["source"] = sources[0]
    if "left" in names:
        fields["left"] = sources[0]
        fields["right"] = sources[1]
    if "filtering" in names:
        fields["source"] = sources[0]
        fields["filtering"] = sources[1]
    if "inputs" in names:
        fields["inputs"] = tuple(sources)
    return dataclasses.replace(node, **fields)


def _is_cross_tree(node: PlanNode) -> bool:
    return (isinstance(node, JoinNode) and node.kind == "cross"
            and not node.left_keys)


def _is_join_chain(node: PlanNode) -> bool:
    """A tree of cross/inner joins (flattenable for reorder+pushdown)."""
    return isinstance(node, JoinNode) and node.kind in ("cross", "inner")


def _chain_size(node: PlanNode) -> int:
    if _is_join_chain(node):
        return _chain_size(node.left) + _chain_size(node.right)  # type: ignore[attr-defined]
    return 1


def _flatten_joins(node: PlanNode) -> Tuple[PlanNode, List[RowExpression]]:
    """Inner/cross join tree -> (pure cross tree, conjuncts) in the tree's
    own output channel space; join keys become equality conjuncts and
    residuals are re-split.  Channel layout is preserved because inner and
    cross joins both concatenate left+right columns."""
    if not _is_join_chain(node):
        return node, []
    assert isinstance(node, JoinNode)
    lt, lc = _flatten_joins(node.left)
    rt, rc = _flatten_joins(node.right)
    nleft = len(node.left.columns)
    conjs = list(lc)
    for c in rc:
        conjs.append(remap(c, {ch: ch + nleft
                               for ch in input_channels(c)}))
    for lk, rk in zip(node.left_keys, node.right_keys):
        conjs.append(B.comparison(
            "=", InputRef(lk, node.left.columns[lk][1]),
            InputRef(nleft + rk, node.right.columns[rk][1])))
    if node.residual is not None:
        conjs.extend(split_and(node.residual))
    tree = JoinNode("cross", lt, rt, (), (), node.columns)
    return tree, conjs


def _cross_leaves(node: PlanNode) -> List[PlanNode]:
    if _is_cross_tree(node):
        return _cross_leaves(node.left) + _cross_leaves(node.right)  # type: ignore[attr-defined]
    return [node]


def _estimate_rows(node: PlanNode, metadata,
                   calculator=None) -> float:
    """Stats-driven row estimate (the StatsCalculator entry used by join
    ordering and the fragmenter's distribution choice); heuristic
    fallbacks apply only where the derivation reports unknown."""
    from presto_tpu_torch.sql.stats import StatsCalculator

    sc = calculator or StatsCalculator(metadata)
    rc = sc.stats(node).row_count
    if rc is not None:
        return rc
    if isinstance(node, TableScanNode):
        return 1e6
    if isinstance(node, (FilterNode, ProjectNode, LimitNode, SortNode)):
        return _estimate_rows(node.sources[0], metadata, sc) * (
            0.3 if isinstance(node, FilterNode) else 1.0)
    if isinstance(node, AggregationNode):
        return _estimate_rows(node.sources[0], metadata, sc) * 0.1
    if isinstance(node, JoinNode):
        return max(_estimate_rows(node.left, metadata, sc),
                   _estimate_rows(node.right, metadata, sc))
    if isinstance(node, SemiJoinNode):
        return _estimate_rows(node.sources[0], metadata, sc)
    if isinstance(node, EnforceSingleRowNode):
        return 1.0
    return 1e4


def factor_or_conjuncts(expr: RowExpression) -> List[RowExpression]:
    """OR(a AND x, a AND y) -> [a, OR(x, y)] (ExtractCommonPredicates
    rewriter analogue) — lets each OR branch's shared join equalities
    become join keys (TPC-H Q19's p_partkey = l_partkey)."""
    if not (isinstance(expr, SpecialForm) and expr.form == "OR"):
        return [expr]
    branches = []
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, SpecialForm) and e.form == "OR":
            stack.extend(e.args)
        else:
            branches.append(split_and(e))
    common = [c for c in branches[0]
              if all(any(c == d for d in b) for b in branches[1:])]
    if not common:
        return [expr]
    out = list(common)
    rests = []
    for b in branches:
        rest = [c for c in b if not any(c == d for d in common)]
        if not rest:
            return out  # one branch is fully covered: OR part is TRUE
        rests.append(and_all(rest))
    ored = rests[0]
    for r in rests[1:]:
        ored = B.or_(ored, r)
    out.append(ored)
    return out


@dataclasses.dataclass
class JoinGraph:
    """The join graph shared by the greedy orderer and the memo-based
    ``ReorderJoins`` exploration (sql/memo.py): filtered leaves, equality
    edges (direct first, then transitively-derived), and the residual
    conjuncts that could not push or become keys.  Channels in
    ``residual`` are in the ORIGINAL concatenated leaf space."""

    nodes: List[PlanNode]                      # leaves w/ pushed filters
    offsets: List[int]                         # original channel offsets
    edges: List[Tuple[int, int, int, int]]     # (leaf_a, ch_a, leaf_b, ch_b)
    derived_from: int                          # edges[:derived_from] direct
    residual: List[RowExpression]
    columns: Tuple                             # original concat columns

    def leaf_of(self, ch: int) -> int:
        for i in range(len(self.nodes) - 1, -1, -1):
            if ch >= self.offsets[i]:
                return i
        raise AssertionError


def build_join_graph(filter_node: FilterNode) -> JoinGraph:
    """Filter(cross-join tree) -> JoinGraph: push single-leaf conjuncts
    onto their leaves, classify two-leaf equalities as edges, run the
    transitive equality inference (EqualityInference.java role), and
    keep the rest as residual conjuncts."""
    leaves = _cross_leaves(filter_node.source)
    offsets = []
    off = 0
    for leaf in leaves:
        offsets.append(off)
        off += len(leaf.columns)

    def leaf_of(ch: int) -> int:
        for i in range(len(leaves) - 1, -1, -1):
            if ch >= offsets[i]:
                return i
        raise AssertionError

    conjuncts = []
    for c in split_and(filter_node.predicate):
        conjuncts.extend(factor_or_conjuncts(c))
    pushed: List[List[RowExpression]] = [[] for _ in leaves]
    edges: List[Tuple[int, int, int, int]] = []  # (la, cha, lb, chb)
    residual: List[RowExpression] = []
    for c in conjuncts:
        chans = input_channels(c)
        ls = {leaf_of(ch) for ch in chans}
        if len(ls) == 1:
            li = ls.pop()
            pushed[li].append(
                remap(c, {ch: ch - offsets[li] for ch in chans}))
        elif (len(ls) == 2 and isinstance(c, Call) and c.name == "eq"
                and len(c.args) == 2
                and all(isinstance(a, InputRef) for a in c.args)):
            a, b = c.args  # type: ignore[misc]
            la, lb = leaf_of(a.index), leaf_of(b.index)
            edges.append((la, a.index - offsets[la],
                          lb, b.index - offsets[lb]))
        else:
            residual.append(c)

    # Transitive equality inference (EqualityInference.java role):
    # equivalence classes over the equality edges (a) replicate
    # single-column constant predicates to every equivalent column's
    # leaf (o_orderkey < K infers l_orderkey < K through
    # l_orderkey = o_orderkey), and (b) derive join edges between leaf
    # pairs connected only transitively, giving the reorderer equi-join
    # options where it would otherwise cross-join.  Derived edges are
    # implied by the direct ones (every class is spanned by enforced
    # direct edges), so they never become post-join filters.
    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(x):
        r = x
        while parent.get(r, r) != r:
            r = parent[r]
        while parent.get(x, x) != x:
            parent[x], x = r, parent[x]
        return r

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for la, ca, lb, cb in edges:
        union((la, ca), (lb, cb))
    classes: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for la, ca, lb, cb in edges:
        for m in ((la, ca), (lb, cb)):
            classes.setdefault(find(m), [])
            if m not in classes[find(m)]:
                classes[find(m)].append(m)

    def _constant_pred_channel(p: RowExpression) -> Optional[int]:
        """The single input channel of a comparison-vs-constant."""
        if not (isinstance(p, Call) and len(p.args) == 2
                and p.name in ("eq", "ne", "lt", "le", "gt", "ge")):
            return None
        chans = input_channels(p)
        if len(chans) != 1:
            return None
        if not any(isinstance(a, Constant) for a in p.args):
            return None
        return next(iter(chans))

    for li in range(len(leaves)):
        for p in list(pushed[li]):
            ch = _constant_pred_channel(p)
            if ch is None:
                continue
            for lj, cj in classes.get(find((li, ch)), ()):
                if lj == li:
                    continue
                repl = remap(p, {ch: cj})
                if not any(repl == q for q in pushed[lj]):
                    pushed[lj].append(repl)
    direct_pairs = {frozenset((la, lb)) for la, _, lb, _ in edges}
    derived_from = len(edges)
    for members in classes.values():
        for i in range(len(members)):
            for j in range(i + 1, len(members)):
                (la, ca), (lb, cb) = members[i], members[j]
                if la == lb or frozenset((la, lb)) in direct_pairs:
                    continue
                edges.append((la, ca, lb, cb))
                direct_pairs.add(frozenset((la, lb)))

    nodes: List[PlanNode] = []
    for leaf, preds in zip(leaves, pushed):
        nodes.append(FilterNode(leaf, and_all(preds)) if preds else leaf)

    return JoinGraph(nodes, offsets, edges, derived_from, residual,
                     tuple(col for leaf in leaves for col in leaf.columns))


def extract_joins(filter_node: FilterNode, metadata, config=None) -> PlanNode:
    """Filter(cross-join tree) -> pushed filters + left-deep equi joins."""
    graph = build_join_graph(filter_node)
    nodes = graph.nodes
    offsets = graph.offsets
    edges = graph.edges
    derived_from = graph.derived_from
    residual = graph.residual
    leaf_of = graph.leaf_of

    # greedy left-deep order: start at the largest relation (probe side);
    # at each step join the connected relation whose join yields the
    # SMALLEST estimated intermediate (the ReorderJoins cost objective,
    # evaluated through the stats derivation instead of leaf sizes alone)
    from presto_tpu_torch.sql.stats import StatsCalculator

    sc = StatsCalculator(metadata)
    sizes = [_estimate_rows(n, metadata, sc) for n in nodes]
    remaining = set(range(len(nodes)))
    # join_reordering_strategy=none keeps the syntactic order
    syntactic = (config is not None
                 and config.join_reordering_strategy == "none")
    start = 0 if syntactic else max(remaining, key=lambda i: sizes[i])
    joined = [start]
    remaining.discard(start)
    current = nodes[start]
    # channel map: (leaf, local_ch) -> current output channel
    chan_map: Dict[Tuple[int, int], int] = {
        (start, i): i for i in range(len(nodes[start].columns))}
    used_edges = [False] * len(edges)
    pending_residual = list(residual)

    def candidate_keys(nxt: int
                       ) -> Tuple[List[int], List[int], List[int]]:
        """Join keys (and their edge indices) connecting the joined
        prefix to ``nxt`` — the ONE source of truth for both costing a
        candidate and building the chosen join."""
        lks: List[int] = []
        rks: List[int] = []
        eis: List[int] = []
        for i, (la, ca, lb, cb) in enumerate(edges):
            if used_edges[i]:
                continue
            if la in joined and lb == nxt:
                lks.append(chan_map[(la, ca)])
                rks.append(cb)
                eis.append(i)
            elif lb in joined and la == nxt:
                lks.append(chan_map[(lb, cb)])
                rks.append(ca)
                eis.append(i)
        return lks, rks, eis

    def connected() -> Optional[int]:
        candidates = set()
        for i, (la, _, lb, _) in enumerate(edges):
            if used_edges[i]:
                continue
            if la in joined and lb in remaining:
                candidates.add(lb)
            if lb in joined and la in remaining:
                candidates.add(la)
        if candidates:
            if syntactic:
                return min(candidates)

            def join_cost(i: int) -> Tuple[float, float]:
                lks, rks, _ = candidate_keys(i)
                cols = current.columns + nodes[i].columns
                kind = "inner" if lks else "cross"
                probe = JoinNode(kind, current, nodes[i],
                                 tuple(lks), tuple(rks), cols)
                return (_estimate_rows(probe, metadata, sc), sizes[i])

            return min(candidates, key=join_cost)
        return next(iter(remaining)) if remaining else None

    while remaining:
        nxt = connected()
        if nxt is None:
            break
        nxt_node = nodes[nxt]
        left_keys, right_keys, edge_idx = candidate_keys(nxt)
        for i in edge_idx:
            used_edges[i] = True
        base = len(current.columns)
        cols = current.columns + nxt_node.columns
        if left_keys:
            current = JoinNode("inner", current, nxt_node,
                               tuple(left_keys), tuple(right_keys), cols)
        else:
            current = JoinNode("cross", current, nxt_node, (), (), cols)
        for j in range(len(nxt_node.columns)):
            chan_map[(nxt, j)] = base + j
        joined.append(nxt)
        remaining.discard(nxt)

        # equality edges whose both leaves are now joined but were not
        # usable as keys become filters immediately (current-space refs)
        extra_now: List[RowExpression] = []
        for i, (la, ca, lb, cb) in enumerate(edges):
            if not used_edges[i] and la in joined and lb in joined:
                used_edges[i] = True
                if i >= derived_from:
                    # transitively-derived edge: implied by the direct
                    # edges (all enforced as keys or filters) — adding a
                    # filter would just re-check a=c after a=b and b=c
                    continue
                extra_now.append(
                    B.comparison("=",
                                 _ref_at(current, chan_map[(la, ca)]),
                                 _ref_at(current, chan_map[(lb, cb)])))
        if extra_now:
            current = FilterNode(current, and_all(extra_now))
        ready = []
        rest = []
        for c in pending_residual:
            chans = input_channels(c)
            if all(leaf_of(ch) in joined for ch in chans):
                ready.append(remap(c, {
                    ch: chan_map[(leaf_of(ch), ch - offsets[leaf_of(ch)])]
                    for ch in chans}))
            else:
                rest.append(c)
        pending_residual = rest
        if ready:
            current = FilterNode(current, and_all(ready))

    return restore_leaf_order(graph, current, chan_map)


def restore_leaf_order(graph: JoinGraph, current: PlanNode,
                       chan_map: Dict[Tuple[int, int], int]) -> PlanNode:
    """Project the ordered join tree back to the original concatenated
    leaf channel order for the parent (shared greedy/memo epilogue)."""
    out_exprs = []
    for li, leaf in enumerate(graph.nodes):
        for j in range(len(leaf.columns)):
            ch = chan_map[(li, j)]
            out_exprs.append(InputRef(ch, current.columns[ch][1]))
    return ProjectNode(current, tuple(out_exprs), graph.columns)


def _ref_at(node: PlanNode, ch: int) -> InputRef:
    # build an InputRef in the *pre-remap* leaf space is incorrect here;
    # these equality folds are already in current-channel space, so remap
    # in the caller is an identity for them — construct directly.
    return InputRef(ch, node.columns[ch][1])


# ---------------------------------------------------------------------------
# distinct aggregate rewrite
# ---------------------------------------------------------------------------

def rewrite_distinct_aggregates(node: AggregationNode) -> PlanNode:
    """Aggregate(keys, [agg(distinct x)]) ->
    Aggregate(keys, [agg(x)]) over Aggregate(keys + x, []).

    Several distinct channels and/or mixed DISTINCT + plain aggregates
    split into one aggregation per distinct channel (plus one for plains)
    over the same source, joined back on the group keys (the role the
    reference's MarkDistinct/OptimizeMixedDistinctAggregations rewrites
    play; a join on NULL group keys drops them, an accepted divergence
    noted here)."""
    d_channels = sorted({a.channel for a in node.aggregates if a.distinct})
    if len(d_channels) == 1 and all(a.distinct for a in node.aggregates):
        return _rewrite_one_distinct_channel(node)
    return _rewrite_split_distinct(node, d_channels)


def _rewrite_one_distinct_channel(node: AggregationNode) -> PlanNode:
    """All aggregates DISTINCT over the same single input channel."""
    in_channels = sorted({a.channel for a in node.aggregates
                          if a.channel is not None})
    inner_keys = tuple(node.group_channels) + tuple(in_channels)
    src = node.source
    inner_cols = tuple(src.columns[c] for c in inner_keys)
    inner = AggregationNode(src, inner_keys, (), inner_cols)
    ch_pos = {c: i for i, c in enumerate(inner_keys)}
    aggs = []
    for a in node.aggregates:
        spec = a.spec
        if spec.name in ("count", "count_star"):
            # count(distinct x): count non-null x per group
            arg_t = inner_cols[ch_pos[a.channel]][1]
            spec = resolve_aggregate("count", arg_t)
        aggs.append(PlanAggregate(spec,
                                  ch_pos.get(a.channel), False,
                                  a.output_name))
    return AggregationNode(inner,
                           tuple(range(len(node.group_channels))),
                           tuple(aggs), node.columns)


def _rewrite_split_distinct(node: AggregationNode,
                            d_channels: List[int]) -> PlanNode:
    """One aggregation branch per distinct channel + one for plain
    aggregates, all over the same source, joined on the group keys
    (cross join of single rows in the global case)."""
    ngroups = len(node.group_channels)
    key_cols = tuple(node.columns[:ngroups])

    parts: List[List[int]] = []          # aggregate indices per branch
    for ch in d_channels:
        parts.append([i for i, a in enumerate(node.aggregates)
                      if a.distinct and a.channel == ch])
    plains = [i for i, a in enumerate(node.aggregates) if not a.distinct]
    if plains:
        parts.append(plains)

    def agg_node(indices: List[int]) -> PlanNode:
        aggs = tuple(node.aggregates[i] for i in indices)
        cols = key_cols + tuple(node.columns[ngroups + i] for i in indices)
        branch = AggregationNode(node.source, node.group_channels, aggs,
                                 cols)
        if any(a.distinct for a in aggs):
            return _rewrite_one_distinct_channel(branch)
        return branch

    branches = [agg_node(p) for p in parts]
    joined = branches[0]
    # position of each original aggregate in the joined output
    agg_pos: Dict[int, int] = {i: ngroups + k
                               for k, i in enumerate(parts[0])}
    for branch, part in zip(branches[1:], parts[1:]):
        base = len(joined.columns)
        out_cols = tuple(joined.columns) + tuple(branch.columns)
        if ngroups:
            keys = tuple(range(ngroups))
            joined = JoinNode("inner", joined, branch, keys, keys,
                              out_cols)
        else:
            joined = JoinNode("cross", joined, branch, (), (), out_cols)
        for k, i in enumerate(part):
            agg_pos[i] = base + ngroups + k
    # restore the original column order: keys, then aggregates in order
    exprs: List[RowExpression] = [
        InputRef(i, t) for i, (_, t) in enumerate(key_cols)]
    for i in range(len(node.aggregates)):
        ch = agg_pos[i]
        exprs.append(InputRef(ch, joined.columns[ch][1]))
    return ProjectNode(joined, tuple(exprs), node.columns)


# ---------------------------------------------------------------------------
# column pruning
# ---------------------------------------------------------------------------

def prune_columns(plan: OutputNode) -> OutputNode:
    src, mapping = _prune(plan.source,
                          sorted(range(len(plan.source.columns))))
    return dataclasses.replace(plan, source=src)


def _prune(node: PlanNode,
           needed: List[int]) -> Tuple[PlanNode, Dict[int, int]]:
    """Returns (pruned node, old-channel -> new-channel mapping covering at
    least ``needed``)."""
    if not needed:
        needed = [0]  # count(*)-style shapes still need row counts
    if isinstance(node, TableScanNode):
        names = [node.column_names[i] for i in needed]
        cols = tuple(node.columns[i] for i in needed)
        return (dataclasses.replace(node, column_names=tuple(names),
                                    columns=cols),
                {ch: i for i, ch in enumerate(needed)})
    if isinstance(node, ValuesNode):
        cols = tuple(node.columns[i] for i in needed)
        rows = tuple(tuple(r[i] for i in needed) for r in node.rows)
        return (ValuesNode(cols, rows),
                {ch: i for i, ch in enumerate(needed)})
    if isinstance(node, FilterNode):
        child_needed = sorted(set(needed)
                              | set(input_channels(node.predicate)))
        src, m = _prune(node.source, child_needed)
        return (FilterNode(src, remap(node.predicate, m)),
                {ch: m[ch] for ch in needed})
    if isinstance(node, ProjectNode):
        child_needed = sorted({ch for i in needed
                               for ch in input_channels(
                                   node.expressions[i])})
        src, m = _prune(node.source, child_needed)
        exprs = tuple(remap(node.expressions[i], m) for i in needed)
        cols = tuple(node.columns[i] for i in needed)
        return (ProjectNode(src, exprs, cols),
                {ch: i for i, ch in enumerate(needed)})
    if isinstance(node, AggregationNode):
        ngroups = len(node.group_channels)
        if node.step != "single":
            # partial/final pairs speak the positional component-column
            # contract (keys, then each spec's components in order):
            # pruning through would desync the layouts — keep the full
            # source schema
            src, m = _prune(node.source,
                            sorted(range(len(node.source.columns))))
            new_node = _replace_sources(node, [src])
            return new_node, {ch: ch for ch in needed}
        # the empty-needed [0] fallback can point past a zero-column
        # aggregation (grouping-sets grand-total branch); clamp to
        # channels the node actually has
        agg_needed = [i - ngroups for i in needed
                      if ngroups <= i < ngroups + len(node.aggregates)]
        keep_aggs = [node.aggregates[i] for i in agg_needed]
        child_needed = sorted(set(node.group_channels)
                              | {a.channel for a in keep_aggs
                                 if a.channel is not None})
        src, m = _prune(node.source, child_needed)
        aggs = tuple(dataclasses.replace(
            a, channel=None if a.channel is None else m[a.channel])
            for a in keep_aggs)
        out_cols = (tuple(node.columns[:ngroups])
                    + tuple(node.columns[ngroups + i] for i in agg_needed))
        new_node = AggregationNode(
            src, tuple(m[c] for c in node.group_channels), aggs, out_cols,
            node.step)
        mapping = {c: i for i, c in enumerate(range(ngroups))}
        for newpos, i in enumerate(agg_needed):
            mapping[ngroups + i] = ngroups + newpos
        return new_node, {ch: mapping[ch] for ch in
                          list(range(ngroups)) + [n + ngroups
                                                  for n in agg_needed]}
    if isinstance(node, JoinNode):
        nleft = len(node.left.columns)
        res_chans = (input_channels(node.residual)
                     if node.residual is not None else ())
        left_needed = sorted({ch for ch in set(needed) | set(res_chans)
                              if ch < nleft} | set(node.left_keys))
        right_needed = sorted({ch - nleft
                               for ch in set(needed) | set(res_chans)
                               if ch >= nleft} | set(node.right_keys))
        lsrc, lm = _prune(node.left, left_needed)
        rsrc, rm = _prune(node.right, right_needed)
        nleft_new = len(lsrc.columns)
        mapping = {}
        for ch in left_needed:
            mapping[ch] = lm[ch]
        for ch in right_needed:
            mapping[ch + nleft] = rm[ch] + nleft_new
        # children may keep extra channels (their own join keys), so the
        # pruned schema comes from their ACTUAL outputs
        cols = tuple(lsrc.columns) + tuple(rsrc.columns)
        residual = (remap(node.residual, mapping)
                    if node.residual is not None else None)
        new_node = JoinNode(node.kind, lsrc, rsrc,
                            tuple(lm[c] for c in node.left_keys),
                            tuple(rm[c] for c in node.right_keys),
                            cols, residual, node.distribution)
        return new_node, {ch: mapping[ch] for ch in needed}
    if isinstance(node, SemiJoinNode):
        nsrc = len(node.source.columns)
        res_chans = (input_channels(node.residual)
                     if node.residual is not None else ())
        src_needed = sorted({ch for ch in set(needed) | set(res_chans)
                             if ch < nsrc} | set(node.source_keys))
        filt_needed = sorted({ch - nsrc for ch in res_chans
                              if ch >= nsrc} | set(node.filtering_keys))
        ssrc, sm = _prune(node.source, src_needed)
        fsrc, fm = _prune(node.filtering, filt_needed)
        mapping = {}
        for ch in src_needed:
            mapping[ch] = sm[ch]
        for ch in filt_needed:
            mapping[ch + nsrc] = fm[ch] + len(ssrc.columns)
        residual = (remap(node.residual, mapping)
                    if node.residual is not None else None)
        new_node = SemiJoinNode(ssrc, fsrc,
                                tuple(sm[c] for c in node.source_keys),
                                tuple(fm[c] for c in node.filtering_keys),
                                node.negated, residual, node.null_aware)
        return new_node, {ch: sm[ch] for ch in needed}
    if isinstance(node, SortNode):
        child_needed = sorted(set(needed)
                              | {c for c, _, _ in node.sort_keys})
        src, m = _prune(node.source, child_needed)
        keys = tuple((m[c], asc, nf) for c, asc, nf in node.sort_keys)
        return SortNode(src, keys), {ch: m[ch] for ch in needed}
    if isinstance(node, LimitNode):
        src, m = _prune(node.source, needed)
        return LimitNode(src, node.count), m
    if isinstance(node, EnforceSingleRowNode):
        # must keep all columns (the NULL-row synthesis needs the schema)
        src, m = _prune(node.source,
                        sorted(range(len(node.source.columns))))
        return EnforceSingleRowNode(src), m
    if isinstance(node, OutputNode):
        src, m = _prune(node.source, needed)
        return dataclasses.replace(node, source=src), m
    if isinstance(node, WindowNode):
        # keep the full source schema (window output is source-prefix +
        # function channels); prune only unused function channels
        n_src = len(node.source.columns)
        src, m = _prune(node.source, sorted(range(n_src)))
        keep = [i for i in range(len(node.functions))
                if (n_src + i) in needed]
        funcs = tuple(node.functions[i] for i in keep)
        cols = (tuple(src.columns)
                + tuple(node.columns[n_src + i] for i in keep))
        new_node = WindowNode(src, node.partition_channels,
                              node.order_keys, funcs, cols)
        mapping = {ch: ch for ch in range(n_src)}
        for newpos, i in enumerate(keep):
            mapping[n_src + i] = n_src + newpos
        return new_node, {ch: mapping[ch] for ch in needed}
    if isinstance(node, UnnestNode):
        # no pruning through unnest: its output layout is positional
        src, m = _prune(node.source,
                        sorted(range(len(node.source.columns))))
        new_node = dataclasses.replace(
            node, source=src,
            replicate_channels=tuple(m[c] for c in node.replicate_channels),
            unnest_channels=tuple(m[c] for c in node.unnest_channels))
        return new_node, {ch: ch for ch in needed}
    if isinstance(node, UnionNode):
        pruned = []
        for inp in node.inputs:
            src, m = _prune(inp, list(needed))
            # normalize each branch to exactly `needed` order
            if [m[ch] for ch in needed] != list(range(len(needed))):
                exprs = tuple(InputRef(m[ch], node.columns[ch][1])
                              for ch in needed)
                cols = tuple(node.columns[ch] for ch in needed)
                src = ProjectNode(src, exprs, cols)
            pruned.append(src)
        cols = tuple(node.columns[ch] for ch in needed)
        return (UnionNode(tuple(pruned), cols),
                {ch: i for i, ch in enumerate(needed)})
    raise NotImplementedError(f"prune: {type(node).__name__}")
