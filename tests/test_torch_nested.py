"""Nested types parity: presto_tpu_torch against presto_tpu on the CPU.

- ``batch.py``'s nested columns (ARRAY, MAP, ROW: lengths and flattened
  children): tests/test_nested.py's TestNestedBatch roundtrips (take,
  head, pad, concat, the device move), through both packages;
- the array, map and row functions of ``expr/arrayfns.py``: this slice's
  rows of tests/test_nested.py's TestNestedSql.CASES, and more of each
  function over table columns;
- UNNEST (every case of TestUnnest) and the collect aggregates (every
  case of TestCollectAggregates), plus map_agg, min_by/max_by and
  array_agg over TPC-H columns with one feed thread (the order of a
  group's rows is their arrival order);
- TestStatistics' corr, covar and regression, and the statistics over
  TPC-H columns: the port sums each group's rows in order where numpy
  sums pairwise, so doubles are held to 1e-9 relative (an exact 0 to 0);
- tests/tpcds_queries.py's Q72 (``date_diff``, ROADMAP C9) through both
  runners at tests/test_tpcds_conformance.py's scale;
- every function left for ROADMAP A6b refuses with a message naming it.

Each statement must give the same column names, types and rows, or the
same exception type and message.
"""

import numpy as np
import pytest
import torch
from test_torch_writes import _assert_same, _outcome

from presto_tpu import types as JT
from presto_tpu.batch import batch_from_pylist as jax_batch_from_pylist
from presto_tpu.config import EngineConfig as JaxConfig
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import batch_from_pylist, concat_batches
from presto_tpu_torch.config import EngineConfig
from presto_tpu_torch.localrunner import LocalQueryRunner

SCALE = 0.01

AB = "array(bigint)"
MV = "map(varchar, bigint)"
RW = "row(a bigint, b varchar)"


@pytest.fixture(scope="module")
def runners():
    return (JaxRunner.tpch(scale=SCALE),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu"))


@pytest.fixture(scope="module")
def serial_runners():
    """One feed thread on both sides: a group's rows arrive in scan
    order, so array_agg's element order and min_by's tie winner are
    fixed."""
    return (JaxRunner.tpch(scale=SCALE,
                           config=JaxConfig(task_concurrency=1)),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu",
                                  config=EngineConfig(task_concurrency=1)))


def _same(runners, sql, ordered=True, exact=True):
    want = _outcome(runners[0], sql)
    assert want[0] == "rows", want
    _assert_same(_outcome(runners[1], sql), want, sql, ordered, exact)


class TestNestedBatch:
    ROWS = [
        ([1, 2, 3], {"x": 1}, (10, "p")),
        ([], {"y": 2, "z": 3}, (20, "q")),
        (None, None, None),
        ([7], {}, (30, "r")),
    ]
    TYPES = (AB, MV, RW)

    def _both(self, rows=None):
        rows = self.ROWS if rows is None else rows
        port = batch_from_pylist([T.parse_type(t) for t in self.TYPES],
                                 rows, "cpu")
        jax = jax_batch_from_pylist([JT.parse_type(t) for t in self.TYPES],
                                    rows)
        return port, jax

    def test_roundtrip_take_head_pad(self):
        port, jax = self._both()
        assert port.to_pylist() == jax.to_pylist() == self.ROWS
        idx = np.array([3, 0])
        assert port.take(torch.from_numpy(idx)).to_pylist() == \
            jax.take(idx).to_pylist()
        assert port.head(2).to_pylist() == jax.head(2).to_pylist()
        assert port.pad_rows(16).compact().to_pylist() == \
            jax.pad_rows(16).compact().to_pylist() == self.ROWS

    def test_concat(self):
        port, jax = self._both()
        for b in (port, port.to_numpy()):
            got = concat_batches([b, b.head(1)])
            assert got.to_pylist() == self.ROWS + self.ROWS[:1]
        assert got.to_pylist() == jax.to_pylist() + jax.head(1).to_pylist()

    def test_device_move_keeps_children(self):
        port, _ = self._both()
        host = port.to_numpy()
        assert all(isinstance(c.values, np.ndarray)
                   for col in host.columns for c in (col,) + col.children)
        back = host.to_device("cpu")
        assert all(isinstance(k.values, torch.Tensor)
                   for col in back.columns for k in col.children)
        assert back.to_pylist() == self.ROWS
        assert port.size_bytes == host.size_bytes > 0

    def test_nested_of_nested(self):
        rows = [([["a"]], [[1, 2], [3]]), (None, []),
                ([[], ["b", "c"]], [[4]])]
        types = ["array(array(varchar))", "array(array(bigint))"]
        port = batch_from_pylist([T.parse_type(t) for t in types], rows,
                                 "cpu")
        jax = jax_batch_from_pylist([JT.parse_type(t) for t in types], rows)
        assert port.to_pylist() == jax.to_pylist() == rows
        idx = np.array([2, 2, 0])
        assert port.take(torch.from_numpy(idx)).to_pylist() == \
            jax.take(idx).to_pylist()
        assert concat_batches([port, port]).to_pylist() == rows + rows

    def test_parse_display_roundtrip(self):
        for t in (AB, MV, RW, "array(map(varchar, bigint))"):
            assert T.parse_type(t).display() == JT.parse_type(t).display()
            assert T.parse_type(T.parse_type(t).display()) == \
                T.parse_type(t)


# tests/test_nested.py::TestNestedSql.CASES of this slice (the rest are
# A6b: the refusals at the end), and each function over table columns
NESTED_SQL = [
    "select array[1,2,3]",
    "select cardinality(array[1,2,3]), array[1,2,3][2]",
    "select element_at(array[1,2], 5)",
    "select element_at(array[1,2], -1)",
    "select contains(array[1,2], 2), contains(array[1,2], 9)",
    "select array_position(array['a','b','c'], 'b')",
    "select array_min(array[3,1,2]), array_max(array[3,1,2])",
    "select split('a,b,c', ',')",
    "select split('a,b,c', ',', 2)",
    "select map(array['k1','k2'], array[1,2])['k2']",
    "select cardinality(map(array['a','b'], array[1,2]))",
    "select element_at(map(array['a'], array[1]), 'zz')",
    "select row(1, 'x')",
    "select row(1, 'x')[1]",
    "select cast(null as array(bigint)) is null",
    # beyond the reference's cases: NULL elements and arguments, strings,
    # doubles, empty arrays, nesting
    "select array[1, null, 3], array[1.5, 2.5]",
    "select array_min(array[3, null, 1]), array_max(array['b', 'a', 'c']),"
    " array_min(array['b', 'a', 'c'])",
    "select contains(array[1, null], 1), contains(array[1, 2], "
    "cast(null as bigint)), array_position(array[5, 6, 5], 5)",
    "select element_at(array[array[1], array[2, 3]], 2), "
    "array[array[1], array[2, 3]][2][1]",
    "select map(array[1, 2], array['x', 'y']), map(array[1, 1], "
    "array[10, 20])[1]",
    "select row(1, 'x', 2.5), row(null, 'y')",
    "select cast(null as map(varchar, bigint)), "
    "cast(null as row(a bigint))",
    "select n_nationkey, array[n_nationkey, n_regionkey], "
    "cardinality(array[n_name, n_comment]), array[n_name, 'x'][1] "
    "from nation order by 1",
    "select n_name, contains(array['ALGERIA', 'KENYA', 'PERU'], n_name), "
    "array_position(array[n_regionkey, n_nationkey], n_nationkey), "
    "array_max(array[n_nationkey, n_regionkey * 10]) "
    "from nation order by n_nationkey",
    "select n_name, map(array['k', 'r'], array[n_nationkey, "
    "n_regionkey])['r'], row(n_nationkey, n_name) from nation "
    "order by n_nationkey",
    "select o_orderkey, split(o_comment, ' '), split(o_orderpriority, '-',"
    " 2)[2] from orders order by o_orderkey limit 20",
    "select o_orderkey, cardinality(split(o_comment, ' ')), "
    "element_at(split(o_comment, ' '), -1) from orders "
    "where contains(split(o_comment, ' '), 'the') "
    "order by o_orderkey limit 20",
    "select typeof(array[1]), typeof(map(array[1], array['a'])), "
    "typeof(row(1, 'a'))",
]


@pytest.mark.parametrize("sql", NESTED_SQL, ids=[s[:60] for s in NESTED_SQL])
def test_nested_sql_matches_jax(runners, sql):
    _same(runners, sql)


# tests/test_nested.py::TestUnnest, every case
UNNEST = [
    "select * from unnest(array[1,2,3])",
    "select * from unnest(array['a','b']) with ordinality",
    "select * from unnest(map(array['k1','k2'], array[10,20]))",
    "select o_orderkey, tag from (select o_orderkey, array['p','q'] as "
    "tags from orders limit 2) cross join unnest(tags) as t(tag) "
    "order by o_orderkey, tag",
    "select * from unnest(array[row(1,'a'), row(2,'b')])",
    "select * from unnest(array[1,2,3], array['x','y'])",
    "select * from unnest(array[1,2], array[])",
    "select t.id, u.v from (values (1, array[7]), (2, array[]), (3, "
    "cast(null as array(bigint)))) t(id, arr) left join unnest(t.arr) as "
    "u(v) on true order by t.id",
    "select t.id, u.o from (values (1, array[7]), (2, array[])) t(id, arr)"
    " left join unnest(t.arr) with ordinality as u(v, o) on true "
    "order by t.id",
    "select array_agg(w) from (select w from unnest(split('a b c', ' ')) "
    "as t(w))",
    # over table columns: the replicated columns and the unnested ones
    "select o_orderpriority, count(*), sum(v), max(i) from orders cross "
    "join unnest(array[o_custkey, o_shippriority, o_orderkey]) with "
    "ordinality as t(v, i) group by o_orderpriority order by 1",
    "select w, count(*) from orders cross join unnest(split(o_comment, "
    "' ')) as t(w) group by w order by 2 desc, 1 limit 20",
    "select n_name, k, v from nation cross join unnest(map(array['a', "
    "'b'], array[n_nationkey, n_regionkey])) as t(k, v) "
    "order by n_name, k",
    "select n_nationkey, x, y, o from nation cross join unnest(array["
    "n_nationkey, n_regionkey], array[n_name]) with ordinality as "
    "t(x, y, o) order by 1, 4",
    "select n_nationkey, v, o from nation left join unnest(split(n_name, "
    "'A')) with ordinality as t(v, o) on true order by 1, 3",
]


@pytest.mark.parametrize("sql", UNNEST, ids=[s[:60] for s in UNNEST])
def test_unnest_matches_jax(runners, sql):
    _same(runners, sql)


def test_unnest_literal_answers(runners):
    """The card phase's small cases, against their literal answers."""
    port = runners[1]
    assert port.execute(UNNEST[6]).rows == [(1, None), (2, None)]
    assert port.execute(UNNEST[7]).rows == [(1, 7), (2, None), (3, None)]
    assert port.execute(UNNEST[8]).rows == [(1, 1), (2, None)]


# tests/test_nested.py::TestCollectAggregates, every case
COLLECT = [
    "select array_agg(x) from (values (1),(2),(3)) t(x)",
    "select k, array_agg(v) from (values (1,'a'),(1,'b'),(2,'c')) t(k,v) "
    "group by k order by k",
    "select array_agg(x) from (values (1),(null),(3)) t(x)",
    "select map_agg(k, v) from (values ('x',1),('y',2)) t(k,v)",
    "select min_by(name, price), max_by(name, price) from (values "
    "('a',3),('b',1),('c',9)) t(name,price)",
    "select o_orderpriority, cardinality(array_agg(o_orderkey)), count(*) "
    "from orders group by o_orderpriority order by 1",
    # no rows, NULLs, several aggregates beside plain ones
    "select array_agg(n_name), map_agg(n_nationkey, n_name), "
    "max_by(n_name, n_nationkey) from nation where n_nationkey < 0",
    "select k, array_agg(v), count(*), sum(v) from (values (1, null), "
    "(1, 2), (2, null)) t(k, v) group by k order by k",
    "select min_by(x, y), max_by(x, y) from (values ('a', null), "
    "('b', 2), ('c', 2), (null, 5)) t(x, y)",
    "select map_agg(k, v) from (values (1, 'a'), (2, null)) t(k, v)",
]


@pytest.mark.parametrize("sql", COLLECT, ids=[s[:60] for s in COLLECT])
def test_collect_matches_jax(runners, sql):
    _same(runners, sql)


COLLECT_TPCH = [
    "select n_regionkey, array_agg(n_name), map_agg(n_nationkey, n_name), "
    "min_by(n_name, n_nationkey), max_by(n_name, n_nationkey) from nation "
    "group by n_regionkey order by 1",
    "select o_orderpriority, array_agg(o_orderkey), map_agg(o_orderkey, "
    "o_custkey) from orders where o_orderdate >= date '1995-03-01' and "
    "o_orderdate < date '1995-03-08' group by o_orderpriority order by 1",
    "select o_orderstatus, min_by(o_orderkey, o_totalprice), "
    "max_by(o_orderkey, o_totalprice), min_by(o_clerk, o_orderdate), "
    "max_by(o_orderpriority, o_clerk) from orders group by o_orderstatus "
    "order by 1",
    "select array_agg(r_name), map_agg(r_name, r_regionkey) from region",
    "select l_returnflag, array_agg(l_shipdate) from lineitem where "
    "l_orderkey < 40 group by l_returnflag order by 1",
]


@pytest.mark.parametrize("sql", COLLECT_TPCH,
                         ids=[s[:60] for s in COLLECT_TPCH])
def test_collect_over_tpch_matches_jax(serial_runners, sql):
    _same(serial_runners, sql)


def test_array_agg_is_a_multiset_of_the_rows(runners):
    """Four feed threads: each group's array is its rows in some order."""
    sql = ("select o_orderpriority, array_agg(o_orderkey) from orders "
           "group by o_orderpriority order by 1")
    want = {k: sorted(v) for k, v in runners[0].execute(sql).rows}
    got = {k: sorted(v) for k, v in runners[1].execute(sql).rows}
    assert got == want


# tests/test_aggregates2.py::TestStatistics' corr, covar and regression,
# and the statistics over TPC-H columns
STATS = [
    "select corr(l_quantity, l_extendedprice) from lineitem",
    "select covar_samp(x, y), covar_pop(x, y) from (values (1.0,2.0),"
    "(2.0,4.0),(3.0,5.0)) t(x,y)",
    "select regr_slope(y, x), regr_intercept(y, x) from (values "
    "(1.0,10.0),(2.0,20.0),(3.0,30.0)) t(x,y)",
    "select o_orderpriority, corr(o_totalprice, o_custkey), "
    "covar_samp(o_totalprice, o_custkey), covar_pop(o_totalprice, "
    "o_custkey), regr_slope(o_totalprice, o_custkey), "
    "regr_intercept(o_totalprice, o_custkey) from orders "
    "group by o_orderpriority order by 1",
    "select corr(x, y), covar_samp(x, y), covar_pop(x, y), regr_slope(x, y)"
    ", regr_intercept(x, y) from (values (1.0, null), (2.0, 1.0)) t(x, y)",
    "select corr(x, y), regr_slope(x, y) from (values (1.0, 1.0), "
    "(2.0, 1.0)) t(x, y)",
]


def _stat_close(got, want, sql):
    assert len(got) == len(want), sql
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            if isinstance(y, float):
                # the port sums a group in row order, numpy pairwise
                # (at this scale the two differ by under 2e-14 relative)
                assert x == pytest.approx(y, rel=1e-9, abs=0.0), sql
            else:
                assert x == y, sql


@pytest.mark.parametrize("sql", STATS, ids=[s[:60] for s in STATS])
def test_statistics_match_jax(runners, sql):
    want = _outcome(runners[0], sql)
    got = _outcome(runners[1], sql)
    assert got[:3] == want[:3], sql
    _stat_close(got[3], want[3], sql)


def test_corr_matches_numpy(runners):
    from presto_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(scale=SCALE)
    h = conn.get_table("lineitem")
    b = next(iter(conn.page_source(conn.get_splits(h, 1)[0],
                                   ["l_quantity", "l_extendedprice"],
                                   1 << 22)))
    x = np.asarray(b.columns[0].values)[:b.num_rows].astype(float)
    y = np.asarray(b.columns[1].values)[:b.num_rows].astype(float)
    (got,) = runners[1].execute("select corr(l_quantity, l_extendedprice) "
                                "from lineitem").rows[0]
    assert abs(got - np.corrcoef(x, y)[0, 1]) < 1e-9


def test_tpcds_q72_matches_jax():
    """tests/tpcds_queries.py's Q72 (BASELINE.md config 5's text; it
    calls date_diff) at tests/test_tpcds_conformance.py's scale."""
    from tpcds_queries import QUERIES

    sql = QUERIES[72]
    _same((JaxRunner.tpch(scale=0.003),
           LocalQueryRunner.tpch(scale=0.003, device="cpu")), sql,
          exact=False)


def test_describe_output_and_ctas_of_nested(runners):
    script = [
        "prepare pn from select array[n_nationkey], map(array[n_name], "
        "array[n_regionkey]), row(n_nationkey, n_name) from nation",
        "describe output pn",
        "create table memory.nested_t as select n_nationkey, "
        "array[n_nationkey, n_regionkey] as a, split(n_comment, ' ') as w, "
        "map(array[n_name], array[n_regionkey]) as m from nation",
        "select n_nationkey, a, w, m from memory.nested_t "
        "order by 1",
        "select n_nationkey, x from memory.nested_t cross join "
        "unnest(a) as t(x) order by 1, 2",
        "show columns from memory.nested_t",
        "drop table memory.nested_t",
    ]
    for sql in script:
        _same(runners, sql)


REFUSED = [
    ("select transform(array[1,2,3], x -> x * 10)", "transform"),
    ("select array_sort(array['c','a','b'])", "array_sort"),
    ("select sequence(1, 5)", "sequence"),
    ("select map_filter(map(array['a','b'], array[1,2]), (k,v) -> v > 1)",
     "map_filter"),
    ("select map_from_entries(array[row('x', 1), row('y', 2)])",
     "map_from_entries"),
    ("select array[1,2] || array[3]", "concat"),
    ("select map_keys(map(array['k'], array[1]))", "map_keys"),
]


@pytest.mark.parametrize("sql,name", REFUSED, ids=[r[1] for r in REFUSED])
def test_a6b_functions_refuse_naming_their_item(runners, sql, name):
    with pytest.raises(NotImplementedError, match=rf"{name}.*ROADMAP A6b"):
        runners[1].execute(sql)
    # the reference runs them
    assert runners[0].execute(sql).rows


# An ARRAY, MAP or ROW value as a key: its ``values`` are lengths or
# placeholders, so key words built from them would merge rows that
# differ.  The port refuses each such key, naming A6b; the JAX package
# refuses a GROUP BY or DISTINCT over one (a ValueError) and orders or
# partitions by the array's length.
NESTED_KEYS = [
    "select distinct array[n_regionkey] from nation",
    "select distinct row(n_regionkey) from nation",
    "select a, count(*) from (select array[n_regionkey] a from nation) "
    "group by a",
    "select r, count(*) from (select row(n_regionkey) r from nation) "
    "group by r",
    "select map(array[n_regionkey], array[1]) m, count(*) from nation "
    "group by 1",
    "select a, array_agg(n_name) from (select array[n_regionkey] a, n_name "
    "from nation) group by a",
    "select array[n_regionkey] a from nation order by a limit 3",
    "select row(n_regionkey) r from nation order by r desc limit 3",
    "select n_name, row_number() over (partition by array[n_regionkey]) "
    "from nation",
    "select array[n_regionkey] a from nation union select array[1]",
    "select count(distinct array[n_regionkey]) from nation",
    "select min(array[n_regionkey]) from nation",
    "select arbitrary(row(n_regionkey)) from nation",
    "select max_by(n_name, array[n_regionkey]) from nation",
    "select approx_percentile(array[n_regionkey], 0.5) from nation",
    "select n_name, rank() over (order by row(n_regionkey)) from nation",
    "select count(*) from nation where array[n_regionkey] in "
    "(select array[r_regionkey] from region)",
    "select checksum(array[n_regionkey]) from nation",
]


@pytest.mark.parametrize("sql", NESTED_KEYS, ids=[s[:60] for s in NESTED_KEYS])
def test_nested_keys_refuse_naming_a6b(runners, sql):
    with pytest.raises(NotImplementedError,
                       match=r"comparing or hashing (array|row|map)\(.*"
                             r"ROADMAP A6b"):
        runners[1].execute(sql)


def test_key_builders_refuse_nested_types():
    from presto_tpu_torch.ops.hashing import row_hash
    from presto_tpu_torch.ops.keys import normalize_keys
    from presto_tpu_torch.ops.sort import sort_permutation

    typ = T.parse_type(AB)
    lengths = torch.tensor([1, 2], dtype=torch.int32)
    for build in (lambda: normalize_keys([(lengths, None, typ)], True),
                  lambda: sort_permutation(
                      [(lengths, None, typ, False, False)], 2),
                  lambda: row_hash([(lengths, None, typ)])):
        with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
            build()
