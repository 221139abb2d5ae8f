"""presto_tpu_torch on a CUDA card: the hand-written kernels against
their plain PyTorch versions, the repeat-run bit identity of the float
group sums on every tier, and SQL on cuda against the same SQL on the
CPU.  Every test here needs the card and skips without one.

This file imports neither jax nor presto_tpu, so it also runs where jax
is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402
from presto_tpu_torch.ops import probe_insert as B2  # noqa: E402
from presto_tpu_torch.ops import segment_sums as S  # noqa: E402

pytestmark = pytest.mark.cuda

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
       avg(l_discount), count(*)
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,a,g,odd", [
    (1 << 20, 19, 7, False), (1_000_003, 5, 32, False), (1, 1, 1, False),
    (0, 3, 2, False),
    # the edges of the 8-, 16- and 32-segment builds at Q1's width
    (1 << 20, 19, 8, False), (1 << 20, 19, 9, False),
    (1 << 20, 19, 16, False), (1 << 20, 19, 17, False),
    # a column off 16 bytes (scalar loads), and more columns than a launch
    (1 << 20, 19, 7, True), (300_001, 40, 5, False)])
def test_segment_sums_kernel_matches_plain(card, n, a, g, odd):
    gid, cols = C.b1_inputs(n, g, a, seed=n + g, odd=odd)
    per, _blocks = S._grid(gid, a, g)
    before = S.LAUNCHES.count
    got, bad = S.direct_segment_sums(gid, cols, g)
    again, bad2 = S.direct_segment_sums(gid, cols, g)
    want = S.direct_segment_sums_reference(gid, cols, g)
    torch.cuda.synchronize()
    assert S.LAUNCHES.count == before + 2 * -(-a // per)
    assert int(bad[0]) == int(bad2[0]) == 0
    # both float64: only the order of the additions differs
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-12 if n else torch.equal(got, want)
    # no float atomics: the same bits on every run
    assert torch.equal(got, again)


def test_segment_sums_captures_in_a_cuda_graph(card):
    """The wrapper reads nothing back from the card (a read would fail the
    capture), and the captured call sums whatever its inputs then hold."""
    gid, cols = C.b1_inputs(1 << 18, 7, 19, seed=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want, _ = S.direct_segment_sums(gid, cols, 7)  # build, plan
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, bad = S.direct_segment_sums(gid, cols, 7)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(bad[0]) == 0
    cols[3].mul_(-2.0)
    gid.copy_(torch.flip(gid, (0,)))
    graph.replay()
    torch.cuda.synchronize()
    plain = S.direct_segment_sums_reference(gid, cols, 7)
    assert float(((got - plain).abs() / plain.abs().clamp(min=1.0)).max()
                 ) <= 1e-12


def test_out_of_range_gid_sets_status_and_direct_tier_raises(card):
    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.exec import aggregation as A

    n = 100_003
    gid, cols = C.b1_inputs(n, 7, 3, seed=9)
    gid[torch.tensor([5, 77, n - 1], device=card)] = torch.tensor(
        [7, -1, 40], dtype=torch.int32, device=card)
    got, bad = S.direct_segment_sums(gid, cols, 7)
    assert int(bad[0]) == 3
    ok = (gid >= 0) & (gid < 7)
    want = S.direct_segment_sums_reference(
        torch.where(ok, gid, 0), [torch.where(ok, c, 0.0) for c in cols], 7)
    assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()
                 ) <= 1e-12
    # the direct tier over key codes outside the domains it was given
    # raises at the host read it makes for the group slots
    codes = torch.randint(0, 3, (n,), device=card, dtype=torch.int32)
    codes[10] = 5
    batch = Batch((Column(T.INTEGER, codes),
                   Column(T.INTEGER, torch.zeros_like(codes)),
                   Column(T.DOUBLE, cols[0])), n)
    op = object.__new__(A.HashAggregationOperator)
    op.group_channels = [0, 1]
    op.aggs = [A.AggChannel("sum", 2, T.DOUBLE),
               A.AggChannel("count", None, T.BIGINT)]
    with pytest.raises(ValueError, match="group id outside"):
        op._compute_direct(batch, [3, 2])
    codes[10] = 2
    out = op._compute_direct(batch, [3, 2])
    assert out.num_rows == 3


def test_q1_on_cuda_matches_cpu(card):
    before = S.LAUNCHES.count
    got = LocalQueryRunner.tpch(scale=0.01, device=card).execute(Q1).rows
    assert S.LAUNCHES.count > before
    want = LocalQueryRunner.tpch(scale=0.01, device="cpu").execute(Q1).rows
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0)
            else:
                assert x == y


def test_probe_insert_and_lookup_match_claim_loop(card):
    """B2 at the chip_smoke shapes (Q3's join build and probe at SF1, a
    GroupByHash batch into a small and a large table, the collision
    storm, a full table, SF10 partkey's last rung above the L2, a GROUP
    BY batch with Q3's shape): the claim loop's partition, found flags,
    ok and claimed count, on every repeat; the journal undoes each batch;
    the fused lookup's ranges equal their plain version."""
    before = (B2.INSERT_LAUNCHES.count, B2.LOOKUP_LAUNCHES.count)
    inserts, lookups = C.b2_checks(seed=3)
    assert [c["ok"] for c in inserts] == [True, False, True, True, False,
                                          True, True]
    assert lookups[0]["found"] > 0
    assert B2.INSERT_LAUNCHES.count > before[0]
    assert B2.LOOKUP_LAUNCHES.count > before[1]


def _shape(label):
    return next(s for s in C.b2_shapes(seed=7) if s["label"] == label)


@pytest.mark.parametrize("label", ["collision_storm", "full_table",
                                   "groupby_batch_8192", "q3_groupby_batch",
                                   "groupby_batch_4194304"])
def test_window_walk_matches_claim_loop(card, label):
    """The kernel's windowed walk on clustered keys (Q3's GROUP BY batch,
    into a table already holding groups), a collision storm, full tables
    and a table above the L2: ok, the claimed count and a partition as
    the claim loop's, every row at the slot of its own key."""
    from presto_tpu_torch.ops import hashtable as H

    shape = _shape(label)
    keys, live, cap = shape["keys"], shape["live"], shape["cap"]
    tw, tc = C.b2_table(shape)
    pw, pc = tw.clone(), tc.clone()
    live_all = torch.ones(keys.shape[0], dtype=torch.bool, device=card) \
        if live is None else live
    _pslot, pok = H.probe_insert(keys, live_all, pw, pc)
    used_before = int(H.used_slots(tc).sum())
    slot, status, journal = B2.launch_insert(keys, live, tw, tc)
    fail, n_claimed = status.tolist()
    assert (not fail) == pok
    placed = live_all & (slot != cap)
    C._check_partition(keys, slot, placed, cap, label)
    assert torch.equal(tw[slot[placed].long()], keys[placed])
    assert int((journal >= 0).sum()) == n_claimed
    assert n_claimed == int(H.used_slots(tc).sum()) - used_before
    if pok:
        assert n_claimed == int(H.used_slots(pc).sum()) - used_before


def test_kernel_refuses_a_table_below_one_window(card):
    """The kernel reads whole windows of B2.WINDOW control words: a CUDA
    table smaller than one raises, it takes no other path."""
    from presto_tpu_torch.ops import hashtable as H

    keys = torch.arange(3, dtype=torch.int64, device=card)[:, None]
    tw, tc = H.empty_table(B2.WINDOW // 2, 1, card)
    with pytest.raises(ValueError, match="at least"):
        B2.insert(keys, None, tw, tc)
    with pytest.raises(ValueError, match="at least"):
        B2.lookup(keys, None, tw, tc)


def test_failed_insert_stops_early_and_journal_restores(card):
    """A batch too large for its table: ok is False as for the claim loop,
    and groupby_update takes the placed keys out again through the
    journal, so the control words and the group count are as before."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.ops import hashtable as H

    gen = torch.Generator(device=card).manual_seed(11)
    state = H.groupby_init(8_192, 2, [torch.int64], [True],
                           [("count", None)], card)
    first = torch.randint(0, 1 << 40, (4_000,), generator=gen, device=card)
    state, ng, ok = H.groupby_update(state, [(first, None, T.BIGINT)],
                                     [("count", None, None)], 4_000)
    assert ok and ng == int(H.used_slots(state[1]).sum())
    ctrl = state[1].clone()
    big = torch.randint(0, 1 << 40, (65_536,), generator=gen, device=card)
    state2, ng2, ok2 = H.groupby_update(state, [(big, None, T.BIGINT)],
                                        [("count", None, None)], 65_536)
    assert not ok2 and ng2 == ng and state2 is state
    assert torch.equal(state[1], ctrl)
    pw, pc = H.empty_table(8_192, 2, card)
    kw = torch.stack([big, torch.zeros_like(big)], 1)
    assert not H.probe_insert(kw, torch.ones(65_536, dtype=torch.bool,
                                             device=card), pw, pc)[1]


def test_lookup_ranges_kernel_matches_plain(card):
    """The fused (lo, cnt) lookup of a PagesHash probe against its plain
    version, with dead rows and absent keys."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.ops import hashtable as H

    gen = torch.Generator(device=card).manual_seed(13)
    bk = torch.randint(0, 20_000, (30_000,), generator=gen, device=card)
    tw, tc, starts, counts, _perm, _null, ok = H.pages_hash_build(
        [(bk, None, T.BIGINT)], 30_000, 65_536)
    assert ok
    pk = torch.randint(0, 40_000, (65_536, 1), generator=gen, device=card)
    live = torch.rand(65_536, generator=gen, device=card) > 0.1
    before = B2.LOOKUP_LAUNCHES.count
    got = B2.lookup_ranges(pk, live, tw, tc, starts, counts)
    assert B2.LOOKUP_LAUNCHES.count == before + 1
    want = B2.lookup_ranges_reference(pk, live, tw, tc, starts, counts)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0


def test_float_group_sums_bit_identical_on_every_tier(card):
    """C2: the direct (above 32 groups), sort, hash and clustered
    (streaming) tiers and a window's segmented scan give the same bits on
    a repeat (and agree with index_add_ to 1e-9)."""
    out = C.c2_checks(seed=5)
    assert set(out) == {"direct", "sort", "hash", "clustered", "window"}


def _same_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0)
            else:
                assert x == y


WINDOW_SQL = """
select o_custkey, o_orderkey,
       sum(o_totalprice) over (partition by o_custkey
                               order by o_orderkey) rsum,
       avg(o_totalprice) over (partition by o_custkey) pavg,
       min(o_totalprice) over (partition by o_custkey order by o_orderkey
                               rows between 2 preceding and current row) mn,
       rank() over (partition by o_orderpriority order by o_totalprice) rk,
       lag(o_orderkey) over (partition by o_custkey order by o_orderkey) lg
from orders order by o_custkey, o_orderkey
"""

TOPN_SQL = """
select o_custkey, o_orderkey, rn from (
    select o_custkey, o_orderkey,
           row_number() over (partition by o_custkey
                              order by o_totalprice desc, o_orderkey) rn
    from orders) t
where rn <= 2 order by o_custkey, rn
"""


@pytest.mark.parametrize("sql,operator", [(WINDOW_SQL, "WindowOperator"),
                                          (TOPN_SQL, "TopNRowNumber")])
def test_window_sql_on_cuda_matches_cpu(card, sql, operator):
    """Window functions (with partitions cut into chunks: 15,000 orders
    against 4,096-row batches) and the TopNRowNumber fusion on the card:
    the same bits on a repeat, the CPU's rows."""
    from presto_tpu_torch.config import EngineConfig

    cfg = EngineConfig(scan_batch_rows=4096)
    runner = LocalQueryRunner.tpch(scale=0.01, device=card, config=cfg)
    got = runner.execute(sql).rows
    assert any(operator in s.operator
               for s in runner._last_task.operator_stats)
    assert runner.execute(sql).rows == got
    want = LocalQueryRunner.tpch(scale=0.01, device="cpu",
                                 config=cfg).execute(sql).rows
    _same_rows(got, want)


def test_streaming_on_cuda_reads_once_a_batch(card, monkeypatch):
    """The streaming tier on the card: the CPU's rows, the same bits on a
    repeat, and one device read a batch."""
    from presto_tpu_torch.config import EngineConfig
    from presto_tpu_torch.exec import streamagg as SA

    reads = []
    real = SA._read_host
    monkeypatch.setattr(SA, "_read_host",
                        lambda parts: reads.append(1) or real(parts))
    sql = ("select l_orderkey, count(*), sum(l_extendedprice), "
           "min(l_shipdate), max(l_discount) from lineitem "
           "group by l_orderkey order by l_orderkey")
    cfg = EngineConfig(scan_batch_rows=4096)
    runner = LocalQueryRunner.tpch(scale=0.01, device=card, config=cfg)
    got = runner.execute(sql).rows
    stats = [s for s in runner._last_task.operator_stats
             if "StreamingAggregation" in s.operator]
    assert len(stats) == 1 and len(reads) == stats[0].input_batches > 10
    assert runner.execute(sql).rows == got
    want = LocalQueryRunner.tpch(scale=0.01, device="cpu",
                                 config=cfg).execute(sql).rows
    _same_rows(got, want)


@pytest.mark.parametrize("q", ["q72", "q47", "q67"])
def test_tpcds_on_cuda_matches_cpu(card, q):
    runner = LocalQueryRunner.tpch(scale=0.05, device=card)
    got = runner.execute(C.ds_sql(q)).rows
    assert runner.execute(C.ds_sql(q)).rows == got
    want = LocalQueryRunner.tpch(scale=0.05, device="cpu").execute(
        C.ds_sql(q)).rows
    _same_rows(got, want)


def test_q3_on_cuda_matches_cpu(card):
    from presto_tpu_torch.config import EngineConfig

    cfg = EngineConfig(hash_groupby_min_rows=0)   # the hash tier too
    before = (B2.INSERT_LAUNCHES.count, B2.LOOKUP_LAUNCHES.count)
    runner = LocalQueryRunner.tpch(scale=0.01, device=card, config=cfg)
    got = runner.execute(C.Q3).rows
    again = runner.execute(C.Q3).rows
    assert B2.INSERT_LAUNCHES.count > before[0]
    assert B2.LOOKUP_LAUNCHES.count > before[1]
    assert got == again                      # the same bits
    want = LocalQueryRunner.tpch(scale=0.01, device="cpu").execute(
        C.Q3).rows
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0)
            else:
                assert x == y


def test_hash_overflow_seam_on_cuda_matches_cpu(card):
    """A rehash ceiling below the group count: a batch that fails at the
    top of the ladder leaves none of its keys behind on the card either,
    so the carried state and the sort tier's merge give the CPU's rows."""
    from presto_tpu_torch.config import EngineConfig

    cfg = EngineConfig(hash_groupby_min_rows=0, hash_groupby_init_slots=256,
                       hash_groupby_max_slots=1024)
    sql = ("select l_partkey, sum(l_quantity), count(*) from lineitem "
           "group by l_partkey")
    runner = LocalQueryRunner.tpch(scale=0.01, device=card, config=cfg)
    got = sorted(runner.execute(sql).rows)
    assert "hash+sort" in {s.kernel_tier
                           for s in runner._last_task.operator_stats}
    want = sorted(LocalQueryRunner.tpch(scale=0.01, device="cpu",
                                        config=cfg).execute(sql).rows)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2]
        assert g[1] == pytest.approx(w[1], rel=1e-9, abs=0.0)


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0)
            else:
                assert x == y


@pytest.mark.parametrize("q", [4, 18, 21, 22])
def test_semi_anti_queries_on_cuda_match_cpu(card, q):
    """TPC-H queries with semi and anti joins (Q21's with a residual) on
    cuda: the CPU's rows, the same bits on a repeat, and B2 serving the
    small semi/anti builds (PagesHash on the card)."""
    sql = C.SQL_QUERIES[f"q{q}"]
    before = B2.LOOKUP_LAUNCHES.count
    runner = LocalQueryRunner.tpch(scale=0.01, device=card)
    got = runner.execute(sql).rows
    assert B2.LOOKUP_LAUNCHES.count > before
    assert runner.execute(sql).rows == got
    want = LocalQueryRunner.tpch(scale=0.01, device="cpu").execute(sql).rows
    assert len(want) > 0
    _rows_close(got, want)


def _join_rows(device, max_build_rows, join_type, residual, null_aware):
    """A build of 400 rows and a probe of 1,000 in batches of 300, with
    duplicate and NULL keys, through HashBuild + LookupJoin on ``device``:
    the surviving probe rows."""
    import numpy as np

    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.config import EngineConfig
    from presto_tpu_torch.exec.context import (
        OperatorContext, QueryContext, TaskContext,
    )
    from presto_tpu_torch.exec.joinop import (
        HashBuildOperatorFactory, LookupJoinOperatorFactory,
    )
    from presto_tpu_torch.expr import build as B

    rng = np.random.default_rng(3)
    k1 = rng.integers(-50, 150, 400)
    kvalid = rng.random(400) > 0.1
    if null_aware:
        kvalid[:] = True                 # else NOT IN keeps no row
    payload = rng.uniform(-1, 1, 400)
    p1 = rng.integers(-80, 200, 1000)
    pvalid = rng.random(1000) > 0.1
    cfg = EngineConfig(device_join_probe_max_build_rows=max_build_rows)

    def batch(cols, lo, hi):
        return Batch(tuple(
            Column(t, torch.from_numpy(v[lo:hi]).to(device),
                   None if m is None else torch.from_numpy(m[lo:hi]).to(
                       device)) for t, v, m in cols), hi - lo)

    def ctx(name):
        return OperatorContext(TaskContext(QueryContext(cfg)), name)

    bf = HashBuildOperatorFactory([0], [T.BIGINT, T.DOUBLE])
    bop = bf.create(ctx("build"))
    bop.add_input(batch([(T.BIGINT, k1, kvalid), (T.DOUBLE, payload, None)],
                        0, 400))
    bop.finish()
    mode = bf.lookup.get().mode
    res = None
    if residual:
        res = B.comparison(">", B.ref(3, T.DOUBLE), B.call(
            "subtract", B.call("divide", B.cast(B.ref(0, T.BIGINT),
                                                T.DOUBLE),
                               B.const(1000.0, T.DOUBLE)),
            B.const(0.5, T.DOUBLE)))
    jf = LookupJoinOperatorFactory(bf, [1], [T.BIGINT, T.BIGINT], join_type,
                                   residual=res, null_aware=null_aware)
    jop = jf.create(ctx("probe"))
    probe = [(T.BIGINT, np.arange(1000), None), (T.BIGINT, p1, pvalid)]
    rows = []
    for lo in range(0, 1000, 300):
        jop.add_input(batch(probe, lo, min(lo + 300, 1000)))
        while (out := jop.get_output()) is not None:
            rows.extend(out.to_pylist())
    jop.close()
    return mode, rows


@pytest.mark.parametrize("join_type,residual,null_aware", [
    ("semi", False, False), ("anti", False, False), ("anti", False, True),
    ("semi", True, False), ("anti", True, False)])
@pytest.mark.parametrize("max_build_rows,tier", [(0, "single"),
                                                 (1 << 17, "hash")])
def test_semi_anti_tiers_on_cuda_match_cpu(card, max_build_rows, tier,
                                           join_type, residual, null_aware,
                                           monkeypatch):
    from presto_tpu_torch.exec import joinop

    # many chunks of residual pairs per probe batch
    monkeypatch.setattr(joinop, "RESIDUAL_CHUNK_PAIRS", 64)
    mode, got = _join_rows(card, max_build_rows, join_type, residual,
                           null_aware)
    again = _join_rows(card, max_build_rows, join_type, residual,
                       null_aware)[1]
    _mode, want = _join_rows("cpu", max_build_rows, join_type, residual,
                             null_aware)
    assert mode == tier
    assert got == again == want and len(want) > 0


@pytest.mark.parametrize("sql", [
    C.SQL_QUERIES["q11"], C.SQL_QUERIES["q15"],
    "select n_name from nation where n_nationkey in "
    "(select max(r_regionkey) from region) order by n_name",
    "select n_nationkey from nation where n_nationkey < 3 "
    "union all select count(*) from region",
    "select c, r_name from (select count(*) as c from nation) x, region "
    "order by r_name",
    "select r_name, (select count(*) from nation) from region "
    "order by r_name",
    "select n_name, r_name from nation n full join region r "
    "on n.n_regionkey = r.r_regionkey order by n_name, r_name",
    "select 1, 'a'"], ids=["q11", "q15", "in_global_aggregate",
                           "union_global_aggregate", "cross_global_left",
                           "scalar_in_select", "full_join", "select_1"])
def test_host_rows_meet_device_rows_on_cuda(card, sql):
    """A global aggregate's row comes out on the query's card, so where
    it meets other rows (a join build or probe, a cross join, a union, a
    scalar subquery) no operator stages it, and the CPU's rows come out."""
    got = LocalQueryRunner.tpch(scale=0.01, device=card).execute(sql).rows
    want = LocalQueryRunner.tpch(scale=0.01, device="cpu").execute(sql).rows
    assert len(want) > 0
    _rows_close(got, want)


@pytest.mark.parametrize("join_type,null_aware", [
    ("semi", False), ("anti", False), ("anti", True)])
@pytest.mark.parametrize("max_build_rows", [0, 1 << 17])  # single, hash
def test_semi_anti_probe_batch_reads_the_card_once(card, max_build_rows,
                                                   join_type, null_aware):
    """Without a residual a semi/anti probe batch blocks on the card once:
    the selected count (``torch.nonzero``).  CUDA's sync debug mode warns
    at every synchronizing call."""
    import warnings

    import numpy as np

    from presto_tpu_torch import types as T
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.config import EngineConfig
    from presto_tpu_torch.exec.context import (
        OperatorContext, QueryContext, TaskContext,
    )
    from presto_tpu_torch.exec.joinop import (
        HashBuildOperatorFactory, LookupJoinOperatorFactory,
    )

    cfg = EngineConfig(device_join_probe_max_build_rows=max_build_rows)

    def ctx(name):
        return OperatorContext(TaskContext(QueryContext(cfg)), name)

    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 5000, 4000)).to(card)
    bf = HashBuildOperatorFactory([0], [T.BIGINT])
    bop = bf.create(ctx("build"))
    bop.add_input(Batch((Column(T.BIGINT, keys),), 4000))
    bop.finish()
    jop = LookupJoinOperatorFactory(bf, [0], [T.BIGINT], join_type,
                                    null_aware=null_aware).create(ctx("probe"))
    probe = torch.from_numpy(rng.integers(0, 10000, 30000)).to(card)
    valid = torch.from_numpy(rng.random(30000) > 0.05).to(card)
    batch = Batch((Column(T.BIGINT, probe, valid),), 30000)
    jop.add_input(batch)                  # first batch: caches, histogram
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            jop.add_input(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert bf.lookup.get().mode == ("hash" if max_build_rows else "single")
