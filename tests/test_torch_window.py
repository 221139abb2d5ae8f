"""Window-function parity: presto_tpu_torch against presto_tpu.

Two levels.  Each function of ``presto_tpu_torch/ops/window.py`` takes the
same seeded numpy inputs as its counterpart in ``presto_tpu/ops/window.py``
(partitions of one row and of many, peer groups, NULLs, empty frames,
``N PRECEDING`` / ``N FOLLOWING`` frames, the min/max sentinels, and
int32, int64 (decimal storage) and double values).  Then every SQL case
of ``tests/test_window.py`` runs through both packages' LocalQueryRunner
at TPC-H SF0.001 (the port on the CPU), with the TopNRowNumber fusion's
fused and unfused forms.  Integers, keys and counts compare exactly,
doubles to 1e-9 relative; rows compare as sorted lists, since the feed
threads may hand a window its rows in another order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.localrunner import LocalQueryRunner as JaxRunner
from presto_tpu.ops import window as JW
from presto_tpu_torch.localrunner import LocalQueryRunner
from presto_tpu_torch.ops import window as W

# ---------------------------------------------------------------------------
# ops/window.py against the JAX package's functions
# ---------------------------------------------------------------------------

N = 301


def _layout(seed: int):
    """Sorted partition ids (one-row partitions included) and peer ids
    refining them, int32 as the window operator makes them."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < N:
        sizes.append(int(rng.choice([1, 1, 2, 3, 7, 20, 64])))
    seg = np.repeat(np.arange(len(sizes)), sizes)[:N].astype(np.int32)
    new_peer = rng.random(N) < 0.6
    new_peer[0] = True
    new_peer[1:] |= seg[1:] != seg[:-1]
    peer = (np.cumsum(new_peer) - 1).astype(np.int32)
    return seg, peer


def _values(kind: str, seed: int):
    rng = np.random.default_rng(seed + 100)
    if kind == "int32":
        v = rng.integers(-1000, 1000, N).astype(np.int32)
    elif kind == "decimal":      # scaled int64 storage
        v = rng.integers(-10**12, 10**12, N).astype(np.int64)
    else:
        v = (rng.standard_normal(N) * 1e6).astype(np.float64)
    valid = rng.random(N) > 0.2
    valid[:3] = False            # a null run at the start
    return v, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _same_masked(got, want):
    """(values, valid) pairs: validity exactly, values where valid."""
    gv, gok = got
    wv, wok = want
    _same(gok, wok)
    ok = np.asarray(wok)
    _same(gv.numpy()[ok], np.asarray(wv)[ok])


SEEDS = [0, 1, 2]
KINDS = ["int32", "decimal", "double"]


@pytest.mark.parametrize("seed", SEEDS)
def test_segments_and_ranking_match_jax(seed):
    seg, peer = _layout(seed)
    eq = np.concatenate([[True], seg[1:] == seg[:-1]])
    _same(W.segment_ids(_t(eq)), JW.segment_ids(_j(eq)))
    for got, want in zip(W._seg_bounds(_t(seg)), JW._seg_bounds(_j(seg))):
        _same(got, want)
    _same(W.row_number(_t(seg)), JW.row_number(_j(seg)))
    for name in ("rank", "dense_rank", "percent_rank", "cume_dist"):
        _same(getattr(W, name)(_t(seg), _t(peer)),
              getattr(JW, name)(_j(seg), _j(peer)))
    for buckets in (1, 3, 4, 50):
        _same(W.ntile(_t(seg), buckets), JW.ntile(_j(seg), buckets))


@pytest.mark.parametrize("kind", KINDS)
def test_segmented_scans_match_jax(kind):
    seg, _ = _layout(3)
    v, _valid = _values(kind, 3)
    for name in ("_seg_cumsum", "_seg_cummax", "_seg_cummin"):
        _same(getattr(W, name)(_t(seg), _t(v)),
              getattr(JW, name)(_j(seg), _j(v)))


def test_segmented_float_scan_gives_the_jax_bits():
    """The scan combines in jax.lax.associative_scan's tree, so float
    sums come out bit for bit, at every length from 1 to 70."""
    rng = np.random.default_rng(7)
    for n in range(1, 71):
        seg = np.sort(rng.integers(0, max(n // 5, 1), n)).astype(np.int32)
        v = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 9, n)
        got = W._seg_cumsum(_t(seg), _t(v)).numpy()
        want = np.asarray(JW._seg_cumsum(_j(seg), _j(v)))
        assert got.tobytes() == want.tobytes(), n


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offset", [1, 2, -1, -3])
def test_shift_in_partition_matches_jax(kind, offset):
    seg, _ = _layout(4)
    v, valid = _values(kind, 4)
    _same_masked(W.shift_in_partition(_t(seg), _t(v), _t(valid), offset),
                 JW.shift_in_partition(_j(seg), _j(v), _j(valid), offset))
    default = np.full(N, 7, v.dtype)
    _same_masked(
        W.shift_in_partition(_t(seg), _t(v), _t(valid), offset,
                             _t(default)),
        JW.shift_in_partition(_j(seg), _j(v), _j(valid), offset,
                              _j(default)))
    _same_masked(W.shift_in_partition(_t(seg), _t(v), None, offset),
                 JW.shift_in_partition(_j(seg), _j(v), None, offset))


@pytest.mark.parametrize("kind", KINDS)
def test_value_at_matches_jax(kind):
    v, valid = _values(kind, 5)
    idx = np.random.default_rng(5).integers(-3, N + 3, N)
    _same_masked(W.value_at(_t(v), _t(valid), _t(idx)),
                 JW.value_at(_j(v), _j(valid), _j(idx)))


# (unit, start, end, start_offset, end_offset): the frames the planner
# produces, empty ones included (3 preceding .. 1 preceding at a
# partition's first row; 1 following .. 3 following at its last)
FRAMES = [
    ("range", "unbounded_preceding", "current", None, None),
    ("rows", "unbounded_preceding", "current", None, None),
    ("range", "unbounded_preceding", "unbounded_following", None, None),
    ("rows", "current", "unbounded_following", None, None),
    ("range", "current", "unbounded_following", None, None),
    ("rows", "preceding", "current", 2, None),
    ("rows", "preceding", "preceding", 3, 1),
    ("rows", "following", "following", 1, 3),
    ("rows", "preceding", "following", 4, 2),
    ("rows", "current", "current", None, None),
]


@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: "-".join(
    str(x) for x in f))
def test_frames_match_jax(frame):
    seg, peer = _layout(6)
    unit, start, end, so, eo = frame
    lo, hi = W.frame_ends(_t(seg), _t(peer), unit, start, end, so, eo)
    jlo, jhi = JW.frame_ends(_j(seg), _j(peer), unit, start, end, so, eo)
    _same(lo, jlo)
    _same(hi, jhi)
    for kind in KINDS:
        v, valid = _values(kind, 6)
        if kind == "int32":
            v = v.astype(np.int64)   # sums run in int64, as the operator
        s, c = W.framed_sum_count(_t(seg), _t(v), _t(valid), lo, hi)
        js, jc = JW.framed_sum_count(_j(seg), _j(v), _j(valid), jlo, jhi)
        _same(c, jc)
        _same(s, js)
        for is_max in (False, True):
            _same_masked(
                W.framed_minmax(_t(seg), _t(peer), _t(v), _t(valid), unit,
                                start, end, is_max, lo, hi),
                JW.framed_minmax(_j(seg), _j(peer), _j(v), _j(valid), unit,
                                 start, end, is_max, jlo, jhi))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("is_max", [False, True])
def test_sparse_table_sentinels_match_jax(kind, is_max):
    """Frames of NULLs only keep the dtype's finfo/iinfo sentinel out of
    the result (valid False); every frame length up to the table's top
    level picks the same windows."""
    seg, _ = _layout(8)
    v, valid = _values(kind, 8)
    valid[10:40] = False
    rng = np.random.default_rng(8)
    lo = rng.integers(0, N, N)
    hi = np.minimum(lo + rng.integers(-1, N, N), N - 1)
    got = W.framed_minmax_range(_t(v), _t(valid), _t(lo), _t(hi), is_max)
    want = JW.framed_minmax_range(_j(v), _j(valid), _j(lo), _j(hi), is_max)
    _same_masked(got, want)
    _same(got[0], want[0])        # the sentinels too, where invalid
    assert not got[1][(lo >= 10) & (hi < 40)].any()


# ---------------------------------------------------------------------------
# SQL: every case of tests/test_window.py through both runners
# ---------------------------------------------------------------------------

SCALE = 0.001

SQL_CASES = {
    "row_number_rank_dense_rank": ["""
        select o_custkey, o_totalprice, o_orderkey,
               row_number() over (partition by o_custkey
                                  order by o_totalprice desc) rn,
               rank() over (partition by o_custkey
                            order by o_totalprice desc) rk,
               dense_rank() over (partition by o_custkey
                                  order by o_totalprice desc) dr
        from orders"""],
    "percent_rank_cume_dist": ["""
        select n_regionkey, n_nationkey,
               percent_rank() over (partition by n_regionkey
                                    order by n_nationkey) pr,
               cume_dist() over (partition by n_regionkey
                                 order by n_nationkey) cd
        from nation"""],
    "ntile": ["""
        select o_orderkey, ntile(4) over (order by o_orderkey) nt
        from orders limit 1000000"""],
    "lag_lead": ["""
        select o_custkey, o_orderkey, o_totalprice,
               lag(o_totalprice) over (partition by o_custkey
                                       order by o_orderkey) lg,
               lead(o_totalprice, 2) over (partition by o_custkey
                                           order by o_orderkey) ld,
               lag(o_totalprice, 1, -1.0) over (partition by o_custkey
                                                order by o_orderkey) lgd
        from orders"""],
    "first_last_nth": ["""
        select o_custkey, o_orderkey,
               first_value(o_orderkey) over (partition by o_custkey
                                             order by o_orderkey) fv,
               last_value(o_orderkey) over (partition by o_custkey
                    order by o_orderkey
                    rows between unbounded preceding
                    and unbounded following) lv,
               nth_value(o_orderkey, 2) over (partition by o_custkey
                                              order by o_orderkey) nv
        from orders"""],
    "running_sum_count_avg": ["""
        select o_custkey, o_orderkey, o_totalprice,
               sum(o_totalprice) over (partition by o_custkey
                                       order by o_orderkey) rsum,
               count(*) over (partition by o_custkey
                              order by o_orderkey) rcnt,
               avg(o_totalprice) over (partition by o_custkey
                                       order by o_orderkey) ravg
        from orders"""],
    "partition_total": ["""
        select n_regionkey, n_nationkey,
               sum(n_nationkey) over (partition by n_regionkey) tot,
               max(n_nationkey) over (partition by n_regionkey) mx,
               min(n_nationkey) over (partition by n_regionkey) mn
        from nation"""],
    "rows_frame_moving_sum": ["""
        select o_custkey, o_orderkey, o_totalprice,
               sum(o_totalprice) over (partition by o_custkey
                    order by o_orderkey
                    rows between 2 preceding and current row) ms
        from orders"""],
    "rows_frame_moving_minmax": ["""
        select o_custkey, o_orderkey, o_totalprice,
               min(o_totalprice) over (partition by o_custkey
                    order by o_orderkey
                    rows between 2 preceding and current row) mn,
               max(o_totalprice) over (partition by o_custkey
                    order by o_orderkey
                    rows between 3 preceding and 1 preceding) mx
        from orders"""],
    "range_frame_peers": ["""
        select l_orderkey, l_quantity,
               sum(l_quantity) over (order by l_quantity) s
        from lineitem where l_orderkey < 200"""],
    "windowed_aggregate_of_aggregate": ["""
        select o_orderpriority, count(*) c,
               sum(count(*)) over () total
        from orders group by o_orderpriority"""],
    "union_all_vs_distinct": [
        "select n_regionkey from nation union all "
        "select r_regionkey from region",
        "select n_regionkey from nation union select r_regionkey "
        "from region"],
    "union_type_coercion": [
        "select 1 x union all select 2.5 union all select 3"],
    "intersect": ["""
        select n_regionkey from nation where n_regionkey < 3
        intersect select r_regionkey from region"""],
    "except": ["""
        select r_regionkey from region
        except select n_regionkey from nation where n_regionkey < 2"""],
    "set_op_order_and_limit": ["""
        select n_name nm from nation union all select r_name from region
        order by nm desc limit 3"""],
    "union_in_subquery": ["""
        select count(*) from (select n_regionkey k from nation
                              union select 99 from region) t"""],
    "intersect_precedence": [
        "select 1 x union select 2 intersect select 2"],
    "rollup": ["""
        select n_regionkey, n_nationkey, count(*) c from nation
        where n_regionkey < 2
        group by rollup (n_regionkey, n_nationkey) order by 1, 2"""],
    "cube": ["""
        select n_regionkey, count(*) from nation
        group by cube (n_regionkey) order by 1"""],
    "grouping_sets_explicit": ["""
        select r_regionkey, r_name, count(*) from region
        group by grouping sets ((r_regionkey), (r_name), ())"""],
    "rollup_with_aggregates": ["""
        select l_returnflag, sum(l_quantity) q, count(*) c
        from lineitem group by rollup (l_returnflag) order by 1"""],
    "fused_matches_unfused": ["""
        select o_custkey, o_orderkey, rn from (
            select o_custkey, o_orderkey,
                   row_number() over (partition by o_custkey
                                      order by o_totalprice desc) rn
            from orders) t
        where rn <= 2"""],
    "rn_equals_one": ["""
        select o_custkey, o_orderkey from (
            select o_custkey, o_orderkey,
                   row_number() over (partition by o_custkey
                                      order by o_orderkey) rn
            from orders) t
        where rn = 1"""],
    # a window over a dictionary column, once a refusal of the port
    "row_number_over_varchar": [
        "select n_name, row_number() over (order by n_name) from nation"],
}

# the cases the TopNRowNumber fusion must take
FUSED = ("fused_matches_unfused", "rn_equals_one")


@pytest.fixture(scope="module")
def runners():
    return (JaxRunner.tpch(scale=SCALE),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu"))


def _key(row):
    return tuple((v is None, "" if v is None else str(type(v)), v
                  if v is not None else 0) for v in row)


def assert_rows_equal(got, want):
    """Rows as multisets: keys and counts exactly, doubles to 1e-9."""
    assert len(got) == len(want)
    got, want = sorted(got, key=_key), sorted(want, key=_key)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float) and not math.isnan(y):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0), (g, w)
            else:
                assert x == y and type(x) is type(y), (g, w)


def _operators(runner):
    return [s.operator for s in runner._last_task.operator_stats]


@pytest.mark.parametrize("case", sorted(SQL_CASES))
def test_window_sql_matches_jax(runners, case):
    jax_runner, runner = runners
    for sql in SQL_CASES[case]:
        want = jax_runner.execute(sql)
        got = runner.execute(sql)
        assert got.column_names == want.column_names
        assert [t.display() for t in got.column_types] == \
            [t.display() for t in want.column_types]
        assert len(want.rows) > 0
        assert_rows_equal(got.rows, want.rows)
    fused = any("TopNRowNumber" in op for op in _operators(runner))
    assert fused == (case in FUSED), _operators(runner)


@pytest.mark.parametrize("case", FUSED)
def test_topn_row_number_equals_the_plain_window(runners, case):
    """The fused operator's rows equal a plain WindowOperator's and a
    filter's: ``rn + 0`` keeps the fusion from taking the filter."""
    _, runner = runners
    sql = SQL_CASES[case][0]
    fused = runner.execute(sql).rows
    plain_sql = sql.replace("where rn <= 2", "where rn + 0 <= 2").replace(
        "where rn = 1", "where rn + 0 = 1")
    plain = runner.execute(plain_sql).rows
    ops = _operators(runner)
    assert not any("TopNRowNumber" in op for op in ops)
    assert any(op.endswith("WindowOperator") for op in ops), ops
    assert_rows_equal(fused, plain)


def test_partitions_larger_than_a_chunk_match_jax():
    """scan_batch_rows below the window's input makes the operator cut
    its rows into chunks of complete partitions, as the JAX package
    does; a partition wider than a chunk stays whole."""
    import dataclasses

    from presto_tpu.config import EngineConfig as JaxConfig
    from presto_tpu_torch.config import EngineConfig

    jax_runner = JaxRunner.tpch(scale=SCALE, config=dataclasses.replace(
        JaxConfig(), scan_batch_rows=1000))
    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu",
                                   config=EngineConfig(scan_batch_rows=1000))
    sql = """
        select l_returnflag, l_orderkey, l_linenumber,
               sum(l_extendedprice) over (partition by l_returnflag
                                          order by l_orderkey,
                                                   l_linenumber) s,
               rank() over (partition by l_returnflag
                            order by l_quantity) r
        from lineitem"""
    want = jax_runner.execute(sql).rows
    got = runner.execute(sql).rows
    assert len(got) > 4000
    assert_rows_equal(got, want)


class _SplittingSorter:
    """An OrderByOperator that hands over its sorted rows in batches of
    700, as a spilling sort's merge would, so partitions span batches."""

    batches = 0

    def __new__(cls, ctx, specs):
        from presto_tpu_torch.exec.sortop import OrderByOperator

        class Splitting(OrderByOperator):
            def finish(self):
                super().finish()
                if not self._outputs:
                    return
                out = self._outputs.pop().compact()
                for lo in range(0, out.num_rows, 700):
                    hi = min(lo + 700, out.num_rows)
                    self._outputs.append(out.take(torch.arange(lo, hi)))
                    cls.batches += 1

        return Splitting(ctx, specs)


@pytest.mark.parametrize("case", ["window", "topn"])
def test_every_sorted_batch_is_evaluated(monkeypatch, case):
    """The window operators drain their sorter: when it emits several
    batches, as a spilling sort would, every row still comes out, and
    the rows equal the JAX package's."""
    from presto_tpu_torch.config import EngineConfig
    from presto_tpu_torch.exec import windowop

    monkeypatch.setattr(windowop, "OrderByOperator", _SplittingSorter)
    _SplittingSorter.batches = 0
    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu",
                                   config=EngineConfig(scan_batch_rows=1000))
    sql = {
        "window": """
            select l_returnflag, l_orderkey, l_linenumber,
                   sum(l_extendedprice) over (partition by l_orderkey
                                              order by l_linenumber) s
            from lineitem""",
        "topn": """
            select * from (
                select l_orderkey, l_linenumber,
                       row_number() over (partition by l_orderkey
                                          order by l_linenumber desc) rn
                from lineitem) where rn <= 2""",
    }[case]
    got = runner.execute(sql).rows
    ops = _operators(runner)
    want_op = "TopNRowNumberOperator" if case == "topn" else \
        "WindowOperator"
    assert any(op.endswith(want_op) for op in ops), ops
    assert _SplittingSorter.batches > 3
    want = JaxRunner.tpch(scale=SCALE).execute(sql).rows
    assert len(got) > 1000
    assert_rows_equal(got, want)
