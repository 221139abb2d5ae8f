"""SQL parity: presto_tpu_torch against presto_tpu at TPC-H SF0.01.

The same SQL goes through both packages' LocalQueryRunner (the JAX one
with its default config; the port on the CPU, once with its default
config and once with the hash tiers forced: ``force_pages_hash`` and
``hash_groupby_min_rows=0``, the choices the port makes on cuda at
scale).  Rows must agree: keys and counts exactly, doubles to 1e-9
relative, and row order where the SQL has ORDER BY.  Besides TPC-H
queries the cases hold NOT IN's three-valued logic (a NULL in the
subquery, an empty subquery, NULL probe keys), NOT EXISTS, a correlated
EXISTS with a residual, RIGHT and FULL joins, UNION ALL across two
dictionaries, UNION, INTERSECT, EXCEPT, SELECT without FROM and scalar
subqueries of zero and two rows.  The EXPLAIN texts must be equal, and
the two TPC-H generators must give bit-equal lineitem columns.
"""

import dataclasses
import sys
import os

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tpch_queries import QUERIES  # noqa: E402

from presto_tpu.config import EngineConfig as JaxConfig  # noqa: E402
from presto_tpu.connectors.tpch import TpchConnector as JaxTpch  # noqa: E402
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner  # noqa: E402
from presto_tpu_torch.batch import batch_from_arrays  # noqa: E402
from presto_tpu_torch.config import EngineConfig  # noqa: E402
from presto_tpu_torch.connectors.tpch import TpchConnector  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402

SCALE = 0.01

DIRECT_DESC = """
select l_returnflag, l_shipmode, count(*) as n, sum(l_linenumber) as lines,
       sum(l_extendedprice) as price, min(l_quantity) as qmin,
       max(l_discount) as dmax, min(l_shipinstruct) as smin,
       avg(l_tax) as tax
from lineitem
where l_quantity > 5
group by l_returnflag, l_shipmode
order by l_returnflag desc, l_shipmode desc
"""

PARTKEY = """
select l_partkey, sum(l_quantity), count(*), min(l_shipdate),
       max(l_extendedprice)
from lineitem group by l_partkey
"""

# a join on a DOUBLE key: the JAX package takes PagesHash on every backend
DOUBLE_JOIN = """
select count(*), sum(l_extendedprice), min(ps_partkey)
from lineitem, partsupp where l_quantity = ps_supplycost
"""

LEFT_JOIN = """
select c_custkey, c_mktsegment, o_orderkey, o_totalprice
from customer left join orders on c_custkey = o_custkey
where c_custkey < 40
order by c_custkey, o_orderkey
"""

# C4: keys 1e-9 apart, far below a float32 ulp at these magnitudes
# (~1e-3), stay distinct groups and match only themselves
SUB_F32_GROUP = """
select l_orderkey + l_linenumber * 1e-9 as k, count(*), sum(l_quantity)
from lineitem where l_orderkey < 200
group by l_orderkey + l_linenumber * 1e-9
order by k
"""

SUB_F32_JOIN = """
select count(*), sum(a.q) from
  (select l_orderkey + l_linenumber * 1e-9 as k, l_quantity as q
   from lineitem where l_orderkey < 300) a,
  (select l_orderkey + l_linenumber * 1e-9 as k2 from lineitem
   where l_orderkey < 300) b
where a.k = b.k2
"""

# NOT IN / NOT EXISTS three-valued logic (nullif makes the NULLs)
NOT_IN_NULL_BUILD = """
select n_name from nation
where n_nationkey not in (select nullif(r_regionkey, 2) from region)
"""

NOT_IN_EMPTY = """
select n_name, nullif(n_nationkey, 3) from nation
where nullif(n_nationkey, 3) not in
      (select r_regionkey from region where r_regionkey > 100)
order by n_name
"""

NOT_IN_NULL_PROBE = """
select n_name from nation
where nullif(n_regionkey, 1) not in
      (select r_regionkey from region where r_regionkey < 2)
order by n_name
"""

NOT_EXISTS_NULL_PROBE = """
select n_name from (select n_name, nullif(n_regionkey, 1) as rk
                    from nation) x
where not exists (select * from region
                  where r_regionkey = x.rk and r_regionkey < 3)
order by n_name
"""

EXISTS_RESIDUAL = """
select o_orderkey from orders
where o_orderkey < 2000
  and exists (select * from lineitem where l_orderkey = o_orderkey
              and l_quantity * 4000 > o_totalprice)
order by o_orderkey
"""

RIGHT_JOIN_FILTER = """
select r.r_name, n.n_name from nation n right join region r
  on n.n_regionkey = r.r_regionkey and r.r_name = 'ASIA'
order by r.r_name, n.n_name
"""

FULL_JOIN = """
select n.n_name, r.r_name
from (select * from nation where n_regionkey < 3) n
full join (select * from region where r_regionkey > 0) r
  on n.n_regionkey = r.r_regionkey
order by n.n_name, r.r_name
"""

# one GROUP BY over a union whose name channel has two dictionaries
UNION_DICT_GROUPS = """
select name, k, count(*) from
  (select n_name as name, n_regionkey as k from nation
   union all select r_name, r_regionkey from region) t
group by name, k
"""

CASES = {
    "q1": (QUERIES[1], True),
    "q3": (QUERIES[3], True),
    "q5": (QUERIES[5], True),
    "q6": (QUERIES[6], True),
    "q10": (QUERIES[10], True),
    "count": ("select count(*) from lineitem", True),
    "direct_desc": (DIRECT_DESC, True),
    "direct_unordered": ("select l_linestatus, count(*), sum(l_quantity) "
                         "from lineitem group by l_linestatus", False),
    "partkey": (PARTKEY, False),
    "double_join": (DOUBLE_JOIN, True),
    "left_join": (LEFT_JOIN, True),
    "q13_left_join": (QUERIES[13], True),
    "sub_f32_group": (SUB_F32_GROUP, True),
    "sub_f32_join": (SUB_F32_JOIN, True),
    "not_in_null_build": (NOT_IN_NULL_BUILD, False),
    "not_in_empty": (NOT_IN_EMPTY, True),
    "not_in_null_probe": (NOT_IN_NULL_PROBE, True),
    "not_exists_null_probe": (NOT_EXISTS_NULL_PROBE, True),
    "exists_residual": (EXISTS_RESIDUAL, True),
    "right_join_filter": (RIGHT_JOIN_FILTER, True),
    "full_join": (FULL_JOIN, True),
    "full_join_count": ("select count(*) from nation n full join region r "
                        "on n.n_regionkey = r.r_regionkey", True),
    "union_all_dicts": ("select n_name from nation union all "
                        "select r_name from region", False),
    "union_dict_groups": (UNION_DICT_GROUPS, False),
    "union": ("select n_regionkey from nation union "
              "select r_regionkey from region order by 1", True),
    "intersect": ("select n_regionkey from nation intersect select "
                  "r_regionkey from region where r_regionkey < 3 "
                  "order by 1", True),
    "except": ("select n_regionkey from nation except select r_regionkey "
               "from region where r_regionkey < 3 order by 1", True),
    "select_1": ("select 1", True),
    "scalar_zero_rows": ("select count(*), min(n_name) from nation where "
                         "n_regionkey = (select r_regionkey from region "
                         "where r_name = 'NONE')", True),
}

# the hash tiers on both sides: GroupByHash from the first row (the JAX
# package runs it on the CPU too), PagesHash for every join of the port
HASH_CASES = ("q3", "q5", "q10", "partkey", "double_join", "left_join",
              "sub_f32_group", "not_in_null_probe", "not_exists_null_probe",
              "exists_residual")


@pytest.fixture(scope="module")
def runners():
    return JaxRunner.tpch(scale=SCALE), LocalQueryRunner.tpch(
        scale=SCALE, device="cpu")


@pytest.fixture(scope="module")
def hash_runners():
    jax_cfg = dataclasses.replace(JaxConfig(), hash_groupby_min_rows=0)
    cfg = EngineConfig(force_pages_hash=True, hash_groupby_min_rows=0)
    return (JaxRunner.tpch(scale=SCALE, config=jax_cfg),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu", config=cfg))


def _assert_rows_equal(got, want, ordered):
    assert len(got) == len(want)
    if not ordered:
        key = lambda r: tuple(str(x) for x in r)  # noqa: E731
        got, want = sorted(got, key=key), sorted(want, key=key)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0)
            else:
                assert x == y and type(x) is type(y)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rows_match_jax(runners, name):
    sql, ordered = CASES[name]
    jax_runner, torch_runner = runners
    want = jax_runner.execute(sql)
    got = torch_runner.execute(sql)
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == \
        [t.display() for t in want.column_types]
    _assert_rows_equal(got.rows, want.rows, ordered)


@pytest.mark.parametrize("name", HASH_CASES)
def test_hash_tier_rows_match_jax(hash_runners, name):
    sql, ordered = CASES[name]
    jax_runner, torch_runner = hash_runners
    want = jax_runner.execute(sql)
    got = torch_runner.execute(sql)
    tiers = {s.kernel_tier for s in torch_runner._last_task.operator_stats
             if s.kernel_tier}
    assert "hash" in tiers
    _assert_rows_equal(got.rows, want.rows, ordered)


def test_hash_overflow_seam_rows_match_jax():
    """A rehash ceiling below the group count: the first batch fails at
    the top of the ladder, the state carried so far is merged with the
    sort tier's, and no group is lost, doubled or made up."""
    knobs = dict(hash_groupby_min_rows=0, hash_groupby_init_slots=256,
                 hash_groupby_max_slots=1024)
    jax_runner = JaxRunner.tpch(
        scale=SCALE, config=dataclasses.replace(JaxConfig(), **knobs))
    torch_runner = LocalQueryRunner.tpch(
        scale=SCALE, device="cpu", config=EngineConfig(**knobs))
    got = torch_runner.execute(PARTKEY)
    tiers = {s.kernel_tier for s in torch_runner._last_task.operator_stats
             if s.kernel_tier}
    assert "hash+sort" in tiers
    _assert_rows_equal(got.rows, jax_runner.execute(PARTKEY).rows, False)


# each switch of the hash tiers turned off, on both sides: (knobs, query,
# the operator that must be absent or the tier the port must report)
SWITCHES_OFF = {
    "no_dynamic_filter": (dict(dynamic_filtering_enabled=False), "q5",
                          ("no_operator", "DynamicFilterOperator")),
    "no_hash_groupby": (dict(hash_groupby_enabled=False,
                             hash_groupby_min_rows=0), "partkey",
                        ("tier", "HashAggregationOperator", "sort")),
    "no_pages_hash": (dict(device_join_probe=False), "q3",
                      ("tier", "LookupJoinOperator", "sorted")),
}


@pytest.mark.parametrize("name", sorted(SWITCHES_OFF))
def test_switches_off_rows_match_jax(name):
    knobs, case, check = SWITCHES_OFF[name]
    sql, ordered = CASES[case]
    jax_runner = JaxRunner.tpch(
        scale=SCALE, config=dataclasses.replace(JaxConfig(), **knobs))
    # force_pages_hash asks for the accelerator's choice; the switch wins
    torch_runner = LocalQueryRunner.tpch(
        scale=SCALE, device="cpu",
        config=EngineConfig(force_pages_hash=True, **knobs))
    got = torch_runner.execute(sql)
    stats = torch_runner._last_task.operator_stats
    if check[0] == "no_operator":
        assert not [s for s in stats if s.operator.endswith(check[1])]
    else:
        tiers = {s.kernel_tier for s in stats
                 if s.operator.endswith(check[1])}
        assert tiers == {check[2]}
    _assert_rows_equal(got.rows, jax_runner.execute(sql).rows, ordered)


def test_double_key_join_without_pages_hash_raises():
    """A DOUBLE key has no integer id: with PagesHash switched off it
    needs the canonical tier, which the port does not have yet."""
    runner = LocalQueryRunner.tpch(
        scale=SCALE, device="cpu",
        config=EngineConfig(device_join_probe=False))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        runner.execute(DOUBLE_JOIN)


def test_sub_f32_keys_stay_distinct(runners):
    """C4: the port keys doubles by their exact float64 bits."""
    rows = runners[1].execute(SUB_F32_GROUP).rows
    assert len({r[0] for r in rows}) == len(rows) > 100
    assert all(r[1] == 1 for r in rows)
    n = runners[1].execute(
        "select count(*) from lineitem where l_orderkey < 300").rows[0][0]
    assert runners[1].execute(SUB_F32_JOIN).rows[0][0] == n


def test_limit_without_order_by(runners):
    sql = "select l_orderkey, l_partkey from lineitem limit 7"
    assert (len(runners[1].execute(sql).rows)
            == len(runners[0].execute(sql).rows) == 7)


def test_limit_releases_blocked_feeders():
    """A LIMIT satisfied early closes the local exchange: the feed threads,
    blocked on backpressure with splits left to scan, stop and are
    joined."""
    import threading

    cfg = EngineConfig(scan_batch_rows=256)      # many batches per feed
    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu", config=cfg)
    rows = runner.execute("select l_orderkey from lineitem limit 5").rows
    assert len(rows) == 5
    assert not [t.name for t in threading.enumerate()
                if ".feed" in t.name and t.is_alive()]


@pytest.mark.parametrize("q", [1, 6, 3, 4, 11, 16, 21, 22])
def test_explain_text_equal(runners, q):
    jax_runner, torch_runner = runners
    assert torch_runner.explain(QUERIES[q]) == jax_runner.explain(QUERIES[q])
    assert (torch_runner.execute("explain " + QUERIES[q]).rows
            == jax_runner.execute("explain " + QUERIES[q]).rows)


def _lineitem(conn):
    handle = conn.get_table("lineitem")
    names = [c.name for c in conn.table_schema(handle).columns]
    out = []
    for split in conn.get_splits(handle, 4):
        out.extend(conn.page_source(split, names, 1 << 20))
    return names, out


def test_generators_bit_equal():
    jnames, jbatches = _lineitem(JaxTpch(scale=SCALE))
    pnames, pbatches = _lineitem(TpchConnector(scale=SCALE))
    assert jnames == pnames
    assert len(jbatches) == len(pbatches)
    for jb, pb in zip(jbatches, pbatches):
        assert jb.num_rows == pb.num_rows
        for jc, pc in zip(jb.columns, pb.columns):
            jv, pv = np.asarray(jc.values), np.asarray(pc.values)
            assert jv.dtype == pv.dtype
            assert jv.tobytes() == pv.tobytes()
            assert (jc.valid is None) == (pc.valid is None)
            if jc.dictionary is not None:
                assert jc.dictionary.values == pc.dictionary.values


def test_batch_from_arrays_carries_jax_batches():
    """A JAX Batch, handed over as numpy arrays, becomes the same port
    Batch the port's own generator makes."""
    jnames, jbatches = _lineitem(JaxTpch(scale=SCALE))
    _pnames, pbatches = _lineitem(TpchConnector(scale=SCALE))
    jb, pb = jbatches[0], pbatches[0]
    carried = batch_from_arrays(
        [(c.type.display(), np.asarray(c.values),
          None if c.valid is None else np.asarray(c.valid),
          None if c.dictionary is None else c.dictionary.values)
         for c in jb.columns], device="cpu")
    assert carried.device == torch.device("cpu")
    assert carried.num_rows == pb.num_rows
    for cc, pc in zip(carried.columns, pb.columns):
        assert cc.type == pc.type
        assert torch.equal(cc.values, torch.from_numpy(pc.values))
    assert carried.to_pylist() == pb.to_pylist()


@pytest.mark.parametrize("sql", [
    "select x from nation cross join unnest(array[n_nationkey]) as t(x)",
    "set session task_concurrency = 2",
    "show tables",
    # a spatial predicate over a cross join (the spatial join is A10)
    "select count(*) from nation, region where "
    "st_contains(st_point(n_nationkey, 1), st_point(r_regionkey, 1))",
])
def test_unported_shapes_raise(runners, sql):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        runners[1].execute(sql)


def test_three_valued_row_counts(runners):
    """The parity cases above are not vacuous: NOT IN against a NULL in
    the subquery keeps no row, against an empty subquery every row (a NULL
    key too), and a NULL probe key drops its row from NOT IN but not from
    NOT EXISTS."""
    run = runners[1].execute
    assert run(NOT_IN_NULL_BUILD).rows == []
    rows = run(NOT_IN_EMPTY).rows
    assert len(rows) == 25 and sum(r[1] is None for r in rows) == 1
    # regions 0 and 1 hold 5 nations each: NOT IN keeps regions 2-4,
    # NOT EXISTS (< 3) also keeps region 1's NULL keys
    assert len(run(NOT_IN_NULL_PROBE).rows) == 15
    assert len(run(NOT_EXISTS_NULL_PROBE).rows) == 15


def test_union_dictionaries_stay_apart_on_the_hash_tier(runners,
                                                        hash_runners):
    """Names from two dictionaries reach one GROUP BY on the hash tier
    (keyed on codes): the union re-codes them into one dictionary, so
    ALGERIA (code 0 of nation) and AFRICA (code 0 of region) stay two
    groups.  Against the JAX package's default tiers."""
    torch_runner = hash_runners[1]
    got = torch_runner.execute(UNION_DICT_GROUPS).rows
    tiers = {s.kernel_tier for s in torch_runner._last_task.operator_stats
             if s.operator.endswith("HashAggregationOperator")}
    assert tiers == {"hash"}
    assert len(got) == 30
    _assert_rows_equal(got, runners[0].execute(UNION_DICT_GROUPS).rows,
                       False)


def test_scalar_subquery_of_two_rows_raises_as_jax(runners):
    sql = ("select count(*) from nation where n_regionkey = "
           "(select r_regionkey from region where r_regionkey < 2)")
    with pytest.raises(RuntimeError) as jax_err:
        runners[0].execute(sql)
    with pytest.raises(RuntimeError) as torch_err:
        runners[1].execute(sql)
    assert str(torch_err.value) == str(jax_err.value) == (
        "scalar subquery returned more than one row")


def test_no_device_and_no_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalQueryRunner.tpch(scale=SCALE)


def test_runner_device_is_explicit():
    r = LocalQueryRunner.tpch(scale=SCALE, device="cpu")
    assert r.device == torch.device("cpu")
