"""Sketch parity: presto_tpu_torch's XXH64, HyperLogLog and KLL against
presto_tpu's, and approx_distinct / approx_percentile through SQL.

- ``xxh64`` (the g++ build and the pure-Python fallback alike) equals
  ``presto_tpu.native.xxh64`` on seeded bytes of every length 0 to 100.
- ``HyperLogLog`` and ``KllSketch`` payloads are bit-equal to the JAX
  package's on the same numpy-seeded values (ints, floats, strings,
  bools, None), and after a merge of two payloads.
- Through both packages' LocalQueryRunner at TPC-H SF0.01 (the port on
  the CPU), with the tolerance each case states:
  - HLL estimates are exact at ``task_concurrency`` 1 and 4: the
    registers are a max over the values, which no order changes;
  - KLL quantiles are exact at 1; at 4 the feed threads order the
    batches, compaction depends on the order, and each side is held
    to the sketch's rank bound (rank error under 0.02 of the column's
    true rank, the bound of tests/test_kll.py).
"""

import numpy as np
import pytest
from test_torch_writes import _assert_same, _outcome

from presto_tpu import native as jax_native
from presto_tpu import sketch as JK
from presto_tpu.config import EngineConfig as JaxConfig
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner
from presto_tpu_torch import native
from presto_tpu_torch import sketch as PK
from presto_tpu_torch.config import EngineConfig
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.localrunner import LocalQueryRunner

SCALE = 0.01
RANK_BOUND = 0.02


def test_xxh64_matches_jax_native_and_pure():
    rng = np.random.default_rng(7)
    for n in range(101):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        seed = int(rng.integers(0, 1 << 63))
        want = jax_native.xxh64(data, seed)
        assert native.xxh64(data, seed) == want, n
        assert native._py_xxh64(data, seed) == want, n
        assert native.xxh64(data) == jax_native.xxh64(data), n


def test_xxh64_builds_natively_here():
    """g++ is on this host: the hash runs the built library."""
    assert native.available()


def _values(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "int":
        vals = [int(v) for v in rng.integers(-10**12, 10**12, n)]
    elif kind == "float":
        vals = [float(v) for v in rng.normal(size=n) * 1e3]
    elif kind == "str":
        vals = [f"s{int(v)}" for v in rng.integers(0, n // 3 + 1, n)]
    else:
        vals = [bool(v) for v in rng.integers(0, 2, n)]
    # a NULL every 17 values
    return [None if i % 17 == 5 else v for i, v in enumerate(vals)]


@pytest.mark.parametrize("kind", ["int", "float", "str", "bool"])
def test_hll_payload_bit_equal_jax(kind):
    a_vals, b_vals = _values(kind, 5000, 1), _values(kind, 3000, 2)
    payloads = []
    for K in (JK, PK):
        a, b = K.HyperLogLog(), K.HyperLogLog()
        a.add_many(a_vals)
        b.add_many(b_vals)
        merged = K.HyperLogLog.deserialize(a.serialize())
        merged.merge(K.HyperLogLog.deserialize(b.serialize()))
        payloads.append((a.serialize(), merged.serialize(),
                         merged.cardinality(),
                         K.hll_cardinality(b.serialize())))
    assert payloads[1] == payloads[0]


@pytest.mark.parametrize("kind", ["int", "float", "bool"])
def test_kll_payload_bit_equal_jax(kind):
    a_vals, b_vals = _values(kind, 20000, 3), _values(kind, 7000, 4)
    payloads = []
    for K in (JK, PK):
        a, b = K.KllSketch(), K.KllSketch(seed=5)
        a.add_many(a_vals)
        b.add_many(b_vals)
        merged = K.KllSketch.deserialize(a.serialize())
        merged.merge(K.KllSketch.deserialize(b.serialize()))
        payloads.append((a.serialize(), b.serialize(), merged.serialize(),
                         [merged.quantile(q) for q in (0.1, 0.5, 0.99)]))
    assert payloads[1] == payloads[0]


SKETCH_SQL = [
    # tests/test_aggregates2.py::TestHll and ::TestPercentile
    "select approx_distinct(l_orderkey), count(distinct l_orderkey) "
    "from lineitem",
    "select l_returnflag, approx_distinct(l_suppkey), count(distinct "
    "l_suppkey) from lineitem group by l_returnflag",
    "select approx_distinct(o_orderpriority) from orders",
    # a varbinary input: accumulated, never merged as a sketch
    "select approx_distinct(to_utf8(o_orderpriority)) from orders",
    "select approx_distinct(o_orderdate), approx_distinct(o_totalprice), "
    "approx_distinct(l_shipmode = 'AIR') from orders, lineitem where "
    "o_orderkey = l_orderkey and l_orderkey < 3000",
    # mixed with sum and count
    "select o_orderpriority, approx_distinct(o_custkey), sum(o_totalprice), "
    "count(*), min(o_orderdate), max(o_clerk) from orders group by 1",
    "select approx_distinct(n_name) from nation where n_nationkey > 99",
    "select r_name, approx_distinct(n_name) from nation, region where "
    "n_regionkey = r_regionkey group by r_name",
    # over a UNION the aggregation splits: partial sketches of a
    # varbinary input, merged as payloads at the final step
    "select approx_distinct(x) from (select to_utf8(n_name) x from nation "
    "union all select to_utf8(r_name) from region union all select "
    "to_utf8(n_name) from nation)",
]

PERCENTILE_SQL = [
    # tests/test_kll.py::test_sql_approx_percentile
    "select approx_percentile(l_quantity, 0.5) from tpch.lineitem",
    "select l_returnflag, approx_percentile(l_extendedprice, 0.9) from "
    "tpch.lineitem group by l_returnflag",
    "select approx_percentile(l_quantity, 0.5) from tpch.lineitem "
    "where 1=0",
    "select approx_percentile(l_quantity, 0.5), approx_percentile("
    "l_quantity, 0.9), approx_percentile(l_discount, 0.25) from lineitem",
    "select o_orderpriority, approx_percentile(o_totalprice, 0.5), "
    "approx_distinct(o_custkey), count(*) from orders group by 1",
    "select approx_percentile(l_orderkey, 0.75), approx_percentile("
    "l_suppkey, 0.01) from lineitem",
    # partial and final steps over a UNION (hll_merge, kll_merge)
    "select k, approx_distinct(x), approx_percentile(x, 0.5), count(*) "
    "from (select n_regionkey k, n_nationkey x from nation union all "
    "select r_regionkey, r_regionkey * 7 from region) group by k",
]


@pytest.fixture(scope="module")
def serial_runners():
    return (JaxRunner.tpch(scale=SCALE,
                           config=JaxConfig(task_concurrency=1)),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu",
                                  config=EngineConfig(task_concurrency=1)))


@pytest.fixture(scope="module")
def parallel_runners():
    return (JaxRunner.tpch(scale=SCALE,
                           config=JaxConfig(task_concurrency=4)),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu",
                                  config=EngineConfig(task_concurrency=4)))


@pytest.mark.parametrize("sql", SKETCH_SQL + PERCENTILE_SQL)
def test_sketch_sql_exact_at_task_concurrency_1(serial_runners, sql):
    """One feed thread: the batches reach the sketch in the same order in
    both packages, so HLL and KLL answers are equal (groups as sets: the
    host aggregation emits them in first-row order)."""
    jax, port = serial_runners
    _assert_same(_outcome(port, sql), _outcome(jax, sql), sql,
                 ordered=False)


@pytest.mark.parametrize("sql", SKETCH_SQL)
def test_hll_sql_exact_at_task_concurrency_4(parallel_runners, sql):
    """HLL: the same estimates whatever order the four feed threads
    give the batches."""
    jax, port = parallel_runners
    _assert_same(_outcome(port, sql), _outcome(jax, sql), sql,
                 ordered=False)


def _column(table: str, name: str):
    conn = TpchConnector(scale=SCALE)
    h = conn.get_table(table)
    out = []
    for split in conn.get_splits(h, 1):
        for b in conn.page_source(split, [name], 1 << 22):
            out.append(np.asarray(b.columns[0].values)[:b.num_rows])
    return np.concatenate(out).astype(np.float64)


@pytest.mark.parametrize("column,qs", [
    ("l_quantity", (0.5, 0.9)),
    ("l_extendedprice", (0.1, 0.5, 0.99)),
    ("l_orderkey", (0.25, 0.75)),
])
def test_kll_sql_within_rank_bound_at_task_concurrency_4(parallel_runners,
                                                         column, qs):
    """KLL at four feed threads: compaction depends on the batches'
    order, so each package's quantile is held to the rank bound (0.02) of
    the column's true rank, not to the other's bits."""
    vals = _column("lineitem", column)
    sql = "select " + ", ".join(
        f"approx_percentile({column}, {q})" for q in qs) + " from lineitem"
    for runner in parallel_runners:
        (row,) = runner.execute(sql).rows
        for q, got in zip(qs, row):
            got = float(got)
            rank = float((vals <= got + 1e-9).mean())
            below = float((vals < got - 1e-9).mean())
            assert below - RANK_BOUND <= q <= rank + RANK_BOUND, \
                (type(runner).__module__, column, q, got, below, rank)


def test_grouped_collect_aggregate_names_its_item(serial_runners):
    """A grouped aggregate over the collect state that the port does not
    run yet refuses, naming the ROADMAP item that owns it: the ml
    aggregates (A10), and array_agg grouped by an ARRAY key (A6b)."""
    _jax, port = serial_runners
    for sql, item in (
            ("select n_regionkey, learn_classifier(n_nationkey, "
             "map(array[1], array[cast(n_nationkey as double)])) "
             "from nation group by 1", "A10"),
            ("select a, array_agg(n_name) from (select array[n_regionkey] a,"
             " n_name from nation) group by a", "A6b")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            port.execute(sql)


def test_collect_aggregates_beside_sketch_path_match_jax(serial_runners):
    """The collect aggregates take the sketches' host aggregation; grouped
    and global, they give presto_tpu's rows with one feed thread."""
    jax, port = serial_runners
    for sql in ("select n_regionkey, array_agg(n_name) from nation "
                "group by 1",
                "select array_agg(n_name) from nation"):
        assert port.execute(sql).rows == jax.execute(sql).rows
