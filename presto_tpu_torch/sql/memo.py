"""Memo-based cost exploration: Cascades-style groups + cost pruning.

The reference holds plan alternatives in a Memo of groups with GroupReference
leaves (presto-main/.../sql/planner/iterative/Memo.java,
GroupReference.java), drives rules over them via IterativeOptimizer.java,
and commits to the cheapest alternative through CostComparator.java over
the stats-derived CostCalculator estimates.  sql/rules.py rewrites
destructively to fixpoint, which is fine for always-good rules but cannot
hold alternatives — so join order and exchange placement stayed greedy
heuristics in optimizer.extract_joins.  This module adds the missing tier:

- ``Memo`` / ``GroupRef``: groups of logically-equivalent members whose
  children are group references, deduplicated structurally (Memo.java's
  rewriteChildren + GroupReference sharing);
- ``MemoStatsCalculator``: the stats derivation (sql/stats.py) extended
  through group references — a group's logical properties come from its
  first (original) member;
- ``CostModel`` + ``CostComparator``: cumulative (cpu, memory, network)
  estimates — bytes processed, build-side residency, and per-distribution
  exchange traffic — weighted like the reference's CostComparator
  defaults (cost/CostCalculatorUsingExchanges.java, CostComparator.java);
- ``MemoOptimizer``: the exploration driver.  It runs ordinary
  ``rules.Rule`` instances NON-destructively over groups (each match adds
  an alternative member; the original stays), materializing depth-1
  bindings the way the reference's Matcher resolves GroupReferences
  through Lookup.resolve, and extracts the cheapest plan per group;
- the first two exploration rules that need alternatives:
  ``JoinEnumerator`` (the ReorderJoins.java role — bounded bushy
  enumeration over optimizer.JoinGraph, one memo group per relation
  subset) and ``DetermineJoinDistribution`` (the
  DetermineJoinDistributionType.java role — REPLICATED vs PARTITIONED by
  exchange cost instead of the fragmenter's row-count threshold).

``try_memo_extract_joins`` is the production entry, called from
optimizer._rewrite_bottom_up when ``optimizer_use_memo`` is on.  It
returns None — and the caller falls back to the greedy orderer — when any
leaf lacks a row-count estimate or the graph exceeds
``memo_max_reorder_relations``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from presto_tpu_torch.expr.ir import InputRef, RowExpression, input_channels
from presto_tpu_torch.sql.plan import (
    AggregationNode, Column, FilterNode, JoinNode, PlanNode, ProjectNode,
    SemiJoinNode,
)
from presto_tpu_torch.sql.rules import Rule, RuleContext
from presto_tpu_torch.sql.stats import PlanStats, StatsCalculator

_INF = float("inf")


# ---------------------------------------------------------------------------
# Memo
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupRef(PlanNode):
    """Leaf standing for 'any member of group' (GroupReference.java)."""

    group: int
    columns: Tuple[Column, ...]


class Memo:
    """Groups of logically-equivalent plan alternatives.  Members are
    nodes whose children are GroupRefs; inserting a concrete subtree
    recursively rewrites children into groups and deduplicates
    structurally, so shared subtrees land in shared groups."""

    def __init__(self):
        self._members: List[List[PlanNode]] = []
        self._columns: List[Tuple[Column, ...]] = []
        self._index: Dict[object, int] = {}

    def __len__(self) -> int:
        return len(self._members)

    def new_group(self, columns: Tuple[Column, ...]) -> int:
        self._members.append([])
        self._columns.append(tuple(columns))
        return len(self._members) - 1

    def ref(self, gid: int) -> GroupRef:
        return GroupRef(gid, self._columns[gid])

    def members(self, gid: int) -> List[PlanNode]:
        return self._members[gid]

    @staticmethod
    def _key(member: PlanNode):
        try:
            hash(member)
            return member
        except TypeError:  # unhashable payload (e.g. VALUES literals)
            return ("unhashable", id(member))

    def _canonicalize(self, node: PlanNode) -> PlanNode:
        """Children -> GroupRefs (inserting concrete subtrees)."""
        from presto_tpu_torch.sql.optimizer import _replace_sources

        if not node.sources:
            return node
        srcs = [s if isinstance(s, GroupRef) else self.ref(self.insert(s))
                for s in node.sources]
        return _replace_sources(node, srcs)

    def insert(self, node: PlanNode) -> int:
        """Subtree -> group id (existing group when an equal member is
        already registered)."""
        if isinstance(node, GroupRef):
            return node.group
        member = self._canonicalize(node)
        key = self._key(member)
        gid = self._index.get(key)
        if gid is not None:
            return gid
        gid = self.new_group(tuple(member.columns))
        self._members[gid].append(member)
        self._index[key] = gid
        return gid

    def add(self, gid: int, node: PlanNode) -> bool:
        """Add an ALTERNATIVE member to an existing group (rule output);
        returns False when an equal member is already present."""
        member = self._canonicalize(node)
        if any(member == m for m in self._members[gid]):
            return False
        self._members[gid].append(member)
        self._index.setdefault(self._key(member), gid)
        return True


class MemoStatsCalculator(StatsCalculator):
    """Stats derivation through GroupRefs: a group's stats are the
    stats of its FIRST member — logical properties belong to the group,
    not the alternative (the Volcano invariant; Memo.java group stats)."""

    def __init__(self, memo: Memo, metadata=None):
        super().__init__(metadata)
        self.memo = memo
        self._group_stats: Dict[int, PlanStats] = {}

    def _derive(self, node: PlanNode) -> PlanStats:
        if isinstance(node, GroupRef):
            hit = self._group_stats.get(node.group)
            if hit is None:
                # cycle guard: a self-referential group derives unknown
                self._group_stats[node.group] = PlanStats(None)
                hit = self.stats(self.memo.members(node.group)[0])
                self._group_stats[node.group] = hit
            return hit
        return super()._derive(node)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """(cpu, memory, network) in estimated bytes touched
    (PlanCostEstimate role)."""

    cpu: float
    memory: float
    network: float

    def __add__(self, other: "CostEstimate") -> "CostEstimate":
        return CostEstimate(self.cpu + other.cpu,
                            self.memory + other.memory,
                            self.network + other.network)

    @property
    def unknown(self) -> bool:
        return self.cpu == _INF


ZERO_COST = CostEstimate(0.0, 0.0, 0.0)
UNKNOWN_COST = CostEstimate(_INF, _INF, _INF)


class CostComparator:
    """Weighted total ordering over CostEstimate (CostComparator.java —
    same default weights)."""

    def __init__(self, cpu_weight: float = 75.0,
                 memory_weight: float = 10.0,
                 network_weight: float = 15.0):
        self.cpu_weight = cpu_weight
        self.memory_weight = memory_weight
        self.network_weight = network_weight

    def total(self, c: CostEstimate) -> float:
        return (c.cpu * self.cpu_weight + c.memory * self.memory_weight
                + c.network * self.network_weight)


def _col_width(t) -> float:
    d = t.display()
    if d.startswith(("varchar", "char")):
        return 16.0
    if d.startswith(("array", "map", "row")):
        return 64.0
    return 8.0


def _row_width(columns) -> float:
    return sum(_col_width(t) for _, t in columns) or 8.0


class CostModel:
    """Per-node local cost from the stats derivation
    (CostCalculatorUsingExchanges.java role): cpu = bytes consumed +
    produced, memory = build-side residency, network = exchange traffic
    per distribution choice."""

    def __init__(self, stats: StatsCalculator, config=None):
        from presto_tpu_torch.config import DEFAULT

        self.stats = stats
        self.config = config or DEFAULT
        # exchange fan-out: tasks a broadcast build must reach
        self.fanout = float(self.config.hash_partition_count or 4)
        self._cumulative: Dict[int, Tuple[PlanNode, CostEstimate]] = {}

    def output_bytes(self, node: PlanNode) -> Optional[float]:
        rc = self.stats.stats(node).row_count
        if rc is None:
            return None
        return rc * _row_width(node.columns)

    def replicated_allowed(self, node: JoinNode) -> bool:
        """join_max_broadcast_table_size analogue: a build side above the
        broadcast row limit may not replicate, whatever the cost says."""
        rc = self.stats.stats(node.right).row_count
        return rc is not None and rc <= self.config.broadcast_join_row_limit

    def join_network(self, node: JoinNode, probe_bytes: float,
                     build_bytes: float) -> float:
        """Exchange traffic of one join: REPLICATED ships the build side
        to every task; PARTITIONED re-hashes both sides once.  An
        undecided join is charged its cheapest admissible choice — the
        one DetermineJoinDistribution will commit to."""
        if node.kind == "cross" or not node.left_keys:
            return build_bytes * self.fanout
        replicated = build_bytes * self.fanout
        partitioned = probe_bytes + build_bytes
        dist = node.distribution
        forced = self.config.join_distribution_type
        if forced == "broadcast":
            dist = "replicated"
        elif forced == "partitioned":
            dist = "partitioned"
        if dist == "replicated":
            return replicated
        if dist == "partitioned":
            return partitioned
        if self.replicated_allowed(node):
            return min(replicated, partitioned)
        return partitioned

    def local_cost(self, node: PlanNode) -> CostEstimate:
        """Cost of this node alone (children excluded); children may be
        GroupRefs when ``stats`` is memo-aware."""
        out = self.output_bytes(node)
        if out is None:
            return UNKNOWN_COST
        if isinstance(node, JoinNode):
            probe = self.output_bytes(node.left)
            build = self.output_bytes(node.right)
            if probe is None or build is None:
                return UNKNOWN_COST
            return CostEstimate(probe + build + out, build,
                                self.join_network(node, probe, build))
        if isinstance(node, SemiJoinNode):
            src = self.output_bytes(node.source)
            filt = self.output_bytes(node.filtering)
            if src is None or filt is None:
                return UNKNOWN_COST
            # filtering side broadcasts (fragmenter policy)
            return CostEstimate(src + filt + out, filt,
                                filt * self.fanout)
        if isinstance(node, AggregationNode):
            src = self.output_bytes(node.sources[0])
            if src is None:
                return UNKNOWN_COST
            return CostEstimate(src + out, out, 0.0)
        if isinstance(node, ProjectNode) and all(
                isinstance(e, InputRef) for e in node.expressions):
            # pure channel permutation: column references, no evaluation
            return ZERO_COST
        return CostEstimate(out, 0.0, 0.0)

    def cumulative(self, node: PlanNode) -> CostEstimate:
        """Recursive cost of a CONCRETE plan (no GroupRefs) — the
        EXPLAIN annotation path."""
        hit = self._cumulative.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        cost = self.local_cost(node)
        for s in node.sources:
            cost = cost + self.cumulative(s)
        self._cumulative[id(node)] = (node, cost)
        return cost


# ---------------------------------------------------------------------------
# Exploration driver + extraction
# ---------------------------------------------------------------------------

class MemoOptimizer:
    """Runs rules non-destructively over memo groups and extracts the
    cheapest alternative per group (IterativeOptimizer.exploreGroup +
    Memo extraction roles)."""

    def __init__(self, memo: Memo, metadata=None, config=None,
                 stats: Optional[MemoStatsCalculator] = None,
                 cost_model: Optional[CostModel] = None,
                 comparator: Optional[CostComparator] = None):
        self.memo = memo
        self.stats = stats or MemoStatsCalculator(memo, metadata)
        self.cost_model = cost_model or CostModel(self.stats, config)
        self.comparator = comparator or CostComparator()
        # gid -> (cost, member index, materialized plan) | None (cyclic)
        self._best: Dict[int, Optional[Tuple[CostEstimate, int, PlanNode]]] \
            = {}
        self._in_progress: set = set()

    # -- exploration ----------------------------------------------------
    def _bindings(self, member: PlanNode,
                  chosen_only: bool = False) -> Iterator[PlanNode]:
        """The member itself, plus one variant per (child slot, child
        member) with that GroupRef resolved one level — enough for the
        depth-2 patterns rules.py matches (Matcher-through-Lookup role).
        ``chosen_only`` binds each child slot to its group's extracted
        winner only (bounded exploration of the best tree)."""
        from presto_tpu_torch.sql.optimizer import _replace_sources

        yield member
        srcs = list(member.sources)
        for i, s in enumerate(srcs):
            if not isinstance(s, GroupRef):
                continue
            alts = self.memo.members(s.group)
            if chosen_only:
                hit = self._best.get(s.group)
                alts = [alts[hit[1]]] if hit else alts[:1]
            for alt in alts:
                bound = list(srcs)
                bound[i] = alt
                yield _replace_sources(member, bound)

    def explore(self, ctx: RuleContext, rules: Sequence[Rule],
                gids: Optional[Sequence[int]] = None,
                budget: int = 500, chosen_only: bool = False) -> int:
        """Apply ``rules`` over group members to fixpoint; every match
        ADDS an alternative member (originals stay — non-destructive,
        unlike rules.iterative_optimize).  ``chosen_only`` visits only
        each group's extracted winner (and binds winners below it), the
        bounded post-extraction pass the join enumerator uses on big
        memos.  Returns members added."""
        added = 0
        progress = True
        while progress and added < budget:
            progress = False
            targets = (list(gids) if gids is not None
                       else list(range(len(self.memo))))
            for gid in targets:
                members = self.memo.members(gid)
                if chosen_only:
                    hit = self._best.get(gid)
                    members = [members[hit[1]]] if hit else list(members)
                else:
                    members = list(members)
                for member in members:
                    for binding in self._bindings(member, chosen_only):
                        for rule in rules:
                            if added >= budget:
                                return added
                            out = rule.apply(binding, ctx)
                            if out is not None and self.memo.add(gid, out):
                                added += 1
                                progress = True
        return added

    # -- extraction -----------------------------------------------------
    def invalidate(self) -> None:
        self._best.clear()

    def best(self, gid: int
             ) -> Optional[Tuple[CostEstimate, int, PlanNode]]:
        """(cost, member index, materialized plan) of the cheapest
        alternative; ties go to the LATER member (rule outputs beat the
        originals they rewrote)."""
        from presto_tpu_torch.sql.optimizer import _replace_sources

        hit = self._best.get(gid)
        if hit is not None or gid in self._best:
            return hit
        if gid in self._in_progress:
            return None
        self._in_progress.add(gid)
        try:
            winner: Optional[Tuple[CostEstimate, int, PlanNode]] = None
            winner_total = _INF
            for idx, member in enumerate(self.memo.members(gid)):
                cost = self.cost_model.local_cost(member)
                srcs = []
                dead = False
                for s in member.sources:
                    if isinstance(s, GroupRef):
                        sub = self.best(s.group)
                        if sub is None:
                            dead = True
                            break
                        cost = cost + sub[0]
                        srcs.append(sub[2])
                    else:
                        srcs.append(s)
                if dead:
                    continue
                plan = _replace_sources(member, srcs) if srcs else member
                total = self.comparator.total(cost)
                if winner is None or total < winner_total or (
                        total == winner_total and idx > winner[1]):
                    winner = (cost, idx, plan)
                    winner_total = total
            self._best[gid] = winner
            return winner
        finally:
            self._in_progress.discard(gid)

    def best_groups(self, gid: int) -> List[int]:
        """Groups reachable through the chosen members of ``gid``'s best
        tree (must be called after best())."""
        out: List[int] = []
        seen = set()
        stack = [gid]
        while stack:
            g = stack.pop()
            if g in seen:
                continue
            seen.add(g)
            out.append(g)
            hit = self._best.get(g)
            if not hit:
                continue
            member = self.memo.members(g)[hit[1]]
            for s in member.sources:
                if isinstance(s, GroupRef):
                    stack.append(s.group)
        return out


# ---------------------------------------------------------------------------
# Exploration rule: DetermineJoinDistribution
# ---------------------------------------------------------------------------

class DetermineJoinDistribution(Rule):
    """REPLICATED vs PARTITIONED chosen by exchange cost
    (DetermineJoinDistributionType.java:50 role) instead of the
    fragmenter's bare row-count threshold — the threshold survives only
    as the broadcast admissibility cap.  Produces an annotated
    alternative member; extraction's later-member tie-break commits it."""

    name = "determine_join_distribution"

    def __init__(self, cost_model: CostModel):
        self.cost_model = cost_model

    def apply(self, node: PlanNode, ctx: RuleContext) -> Optional[PlanNode]:
        if not (isinstance(node, JoinNode) and node.kind != "cross"
                and node.left_keys and node.distribution is None):
            return None
        if self.cost_model.config.join_distribution_type != "automatic":
            return None       # session property forces the distribution
        probe = self.cost_model.output_bytes(node.left)
        build = self.cost_model.output_bytes(node.right)
        if probe is None or build is None:
            return None
        replicated = build * self.cost_model.fanout
        partitioned = probe + build
        dist = ("replicated"
                if self.cost_model.replicated_allowed(node)
                and replicated <= partitioned else "partitioned")
        return dataclasses.replace(node, distribution=dist)


# ---------------------------------------------------------------------------
# Exploration rule: ReorderJoins (bounded bushy enumeration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Layout:
    """Canonical channel layout of one relation subset: leaves in
    ascending index order, concatenated."""

    leaves: List[int]
    pos: Dict[Tuple[int, int], int]     # (leaf, local ch) -> position
    columns: Tuple[Column, ...]


class JoinEnumerator:
    """ReorderJoins.java's JoinEnumerator role over optimizer.JoinGraph:
    every connected relation subset becomes ONE memo group whose members
    are the valid (edge-crossing, connected) partitions of that subset
    into probe x build — bushy shapes included.  Cost extraction over
    the memo IS the dynamic program: cheapest per subset, reused by
    every containing subset."""

    def __init__(self, graph, optimizer: MemoOptimizer, config):
        self.graph = graph
        self.opt = optimizer
        self.memo = optimizer.memo
        self.config = config
        n = len(graph.nodes)
        self.n = n
        self.adj = [0] * n
        for la, _, lb, _ in graph.edges:
            self.adj[la] |= 1 << lb
            self.adj[lb] |= 1 << la
        # residual conjunct -> mask of referenced leaves
        self.res_masks: List[int] = []
        for c in graph.residual:
            m = 0
            for ch in input_channels(c):
                m |= 1 << graph.leaf_of(ch)
            self.res_masks.append(m)
        self._layouts: Dict[int, _Layout] = {}
        self._groups: Dict[int, int] = {}
        self._conn: Dict[int, bool] = {}

    # -- bitmask helpers ------------------------------------------------
    def _bits(self, mask: int) -> List[int]:
        return [i for i in range(self.n) if mask >> i & 1]

    def _connected(self, mask: int) -> bool:
        hit = self._conn.get(mask)
        if hit is not None:
            return hit
        bits = self._bits(mask)
        seen = 1 << bits[0]
        frontier = seen
        while frontier:
            nxt = 0
            for i in self._bits(frontier):
                nxt |= self.adj[i] & mask & ~seen
            seen |= nxt
            frontier = nxt
        out = seen == mask
        self._conn[mask] = out
        return out

    def layout(self, mask: int) -> _Layout:
        hit = self._layouts.get(mask)
        if hit is not None:
            return hit
        leaves = self._bits(mask)
        pos: Dict[Tuple[int, int], int] = {}
        cols: List[Column] = []
        for li in leaves:
            for j, col in enumerate(self.graph.nodes[li].columns):
                pos[(li, j)] = len(cols)
                cols.append(col)
        out = _Layout(leaves, pos, tuple(cols))
        self._layouts[mask] = out
        return out

    # -- group construction ---------------------------------------------
    def group(self, mask: int) -> int:
        """Memo group holding every enumerated alternative for ``mask``."""
        hit = self._groups.get(mask)
        if hit is not None:
            return hit
        bits = self._bits(mask)
        if len(bits) == 1:
            gid = self.memo.insert(self.graph.nodes[bits[0]])
            self._groups[mask] = gid
            return gid
        gid = self.memo.new_group(self.layout(mask).columns)
        self._groups[mask] = gid        # register before recursing
        sub = (mask - 1) & mask
        while sub:
            other = mask ^ sub
            if (other and self._cross_edges(sub, other)
                    and self._connected(sub) and self._connected(other)):
                self.memo.add(gid, self._member(mask, sub, other))
            sub = (sub - 1) & mask
        return gid

    def _cross_edges(self, a: int, b: int
                     ) -> List[Tuple[int, int, int, int]]:
        """Edges crossing the (a, b) partition, oriented a-side first."""
        out = []
        for la, ca, lb, cb in self.graph.edges:
            if a >> la & 1 and b >> lb & 1:
                out.append((la, ca, lb, cb))
            elif b >> la & 1 and a >> lb & 1:
                out.append((lb, cb, la, ca))
        return out

    def _member(self, mask: int, a: int, b: int) -> PlanNode:
        """One alternative: probe=group(a) JOIN build=group(b), residuals
        first coverable here, then the canonical-order projection that
        keeps every member of the group schema-identical."""
        lay_a, lay_b = self.layout(a), self.layout(b)
        lks, rks = [], []
        for la, ca, lb, cb in self._cross_edges(a, b):
            lks.append(lay_a.pos[(la, ca)])
            rks.append(lay_b.pos[(lb, cb)])
        concat = lay_a.columns + lay_b.columns
        node: PlanNode = JoinNode(
            "inner", self.memo.ref(self.group(a)),
            self.memo.ref(self.group(b)), tuple(lks), tuple(rks), concat)

        def concat_pos(leaf: int, local: int) -> int:
            if a >> leaf & 1:
                return lay_a.pos[(leaf, local)]
            return len(lay_a.columns) + lay_b.pos[(leaf, local)]

        ready: List[RowExpression] = []
        for c, rm in zip(self.graph.residual, self.res_masks):
            if rm and rm & mask == rm and rm & a != rm and rm & b != rm:
                ready.append(self._remap_residual(c, concat_pos))
        if ready:
            from presto_tpu_torch.sql.optimizer import and_all

            node = FilterNode(node, and_all(ready))

        lay = self.layout(mask)
        perm = [concat_pos(li, j) for li in lay.leaves
                for j in range(len(self.graph.nodes[li].columns))]
        if perm != list(range(len(perm))):
            node = ProjectNode(
                node,
                tuple(InputRef(p, concat[p][1]) for p in perm),
                lay.columns)
        return node

    def _remap_residual(self, c: RowExpression, concat_pos) -> RowExpression:
        from presto_tpu_torch.sql.optimizer import remap

        mapping = {}
        for ch in input_channels(c):
            leaf = self.graph.leaf_of(ch)
            mapping[ch] = concat_pos(leaf, ch - self.graph.offsets[leaf])
        return remap(c, mapping)

    # -- top-level plan ---------------------------------------------------
    def plan(self, ctx: RuleContext
             ) -> Optional[Tuple[PlanNode, Dict[Tuple[int, int], int]]]:
        """Best join tree + (leaf, local ch) -> output channel map.
        Disconnected graphs enumerate per component; components then
        cross-join left-deep, largest first (the greedy anchor rule)."""
        from presto_tpu_torch.sql.optimizer import and_all
        from presto_tpu_torch.sql.rules import DEFAULT_RULES

        full = (1 << self.n) - 1
        comps: List[int] = []
        rest = full
        while rest:
            seed = rest & -rest
            comp = seed
            frontier = seed
            while frontier:
                nxt = 0
                for i in self._bits(frontier):
                    nxt |= self.adj[i] & rest & ~comp
                comp |= nxt
                frontier = nxt
            comps.append(comp)
            rest &= ~comp

        comp_gids = [self.group(m) for m in comps]
        for gid in comp_gids:
            if self.opt.best(gid) is None:
                return None
        # exploration pass over the winning trees only: the existing
        # rules plus the distribution annotator run non-destructively;
        # re-extraction commits annotated members on cost ties
        explore_gids: List[int] = []
        for gid in comp_gids:
            explore_gids.extend(self.opt.best_groups(gid))
        rules = tuple(DEFAULT_RULES) + (
            DetermineJoinDistribution(self.opt.cost_model),)
        self.opt.explore(ctx, rules, gids=explore_gids, chosen_only=True)
        self.opt.invalidate()

        extracted = []
        for m, gid in zip(comps, comp_gids):
            hit = self.opt.best(gid)
            if hit is None:
                return None
            extracted.append((m, hit[0], hit[2]))
        # largest estimated output anchors the cross-join chain
        def comp_rows(m: int) -> float:
            rc = self.opt.stats.stats(
                self.memo.ref(self._groups[m])).row_count
            return -1.0 if rc is None else rc

        extracted.sort(key=lambda t: (-comp_rows(t[0]), t[0]))

        chan_map: Dict[Tuple[int, int], int] = {}
        current: Optional[PlanNode] = None
        placed_mask = 0
        # residuals fully inside one component were placed during
        # enumeration; spanning ones place along the cross-join chain and
        # zero-channel (constant) ones apply at the very top
        pending = [(c, rm) for c, rm in zip(self.graph.residual,
                                            self.res_masks)
                   if not any(rm and rm & m == rm for m in comps)]
        for m, _cost, plan in extracted:
            base = 0 if current is None else len(current.columns)
            lay = self.layout(m)
            for key, p in lay.pos.items():
                chan_map[key] = base + p
            if current is None:
                current = plan
            else:
                current = JoinNode("cross", current, plan, (), (),
                                   tuple(current.columns) + lay.columns)
            placed_mask |= m
            ready = []
            still = []
            for c, rm in pending:
                if rm and rm & placed_mask == rm:
                    from presto_tpu_torch.sql.optimizer import remap

                    mapping = {
                        ch: chan_map[(self.graph.leaf_of(ch),
                                      ch - self.graph.offsets[
                                          self.graph.leaf_of(ch)])]
                        for ch in input_channels(c)}
                    ready.append(remap(c, mapping))
                else:
                    still.append((c, rm))
            pending = still
            if ready:
                current = FilterNode(current, and_all(ready))
        # zero-channel residuals (constant predicates) at the top
        consts = [c for c, rm in pending if not rm]
        if consts:
            current = FilterNode(current, and_all(consts))
        return current, chan_map


# ---------------------------------------------------------------------------
# Production entries
# ---------------------------------------------------------------------------

def try_memo_extract_joins(filter_node: FilterNode, metadata,
                           config) -> Optional[PlanNode]:
    """Memo-based replacement for optimizer.extract_joins.  Returns None
    (caller falls back to the greedy orderer) when any leaf lacks a
    row-count estimate or the graph exceeds the enumeration bound."""
    from presto_tpu_torch.sql.optimizer import build_join_graph, restore_leaf_order

    graph = build_join_graph(filter_node)
    n = len(graph.nodes)
    if n < 2 or n > config.memo_max_reorder_relations:
        return None
    memo = Memo()
    stats = MemoStatsCalculator(memo, metadata)
    for leaf in graph.nodes:
        if stats.stats(leaf).row_count is None:
            return None
    opt = MemoOptimizer(memo, metadata=metadata, config=config, stats=stats)
    enumerator = JoinEnumerator(graph, opt, config)
    out = enumerator.plan(RuleContext(metadata, config))
    if out is None:
        return None
    current, chan_map = out
    return restore_leaf_order(graph, current, chan_map)


def cost_annotator(metadata, config=None):
    """format_plan annotator: per-node estimated rows + cumulative
    (cpu, memory, network) — the EXPLAIN cost surface
    (PlanPrinter.formatPlanNodeStats role)."""
    stats = StatsCalculator(metadata)
    model = CostModel(stats, config)

    def annotate(node: PlanNode) -> str:
        st = stats.stats(node)
        if st.row_count is None:
            return ""
        cost = model.cumulative(node)
        if cost.unknown:
            return f"  {{rows: {st.row_count:.0f}}}"
        return (f"  {{rows: {st.row_count:.0f}, cpu: {cost.cpu:.3g}, "
                f"mem: {cost.memory:.3g}, net: {cost.network:.3g}}}")

    return annotate
