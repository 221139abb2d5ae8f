"""SQL parity: presto_tpu_torch against presto_tpu at TPC-H SF0.01.

The same SQL goes through both packages' LocalQueryRunner (the JAX one
with its default config; the port on the CPU).  Rows must agree: keys
and counts exactly, doubles to 1e-9 relative, and row order where the
SQL has ORDER BY.  The EXPLAIN texts must be equal, and the two TPC-H
generators must give bit-equal lineitem columns.
"""

import sys
import os

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tpch_queries import QUERIES  # noqa: E402

from presto_tpu.connectors.tpch import TpchConnector as JaxTpch  # noqa: E402
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner  # noqa: E402
from presto_tpu_torch.batch import batch_from_arrays  # noqa: E402
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

CASES = {
    "q1": (QUERIES[1], True),
    "q6": (QUERIES[6], True),
    "count": ("select count(*) from lineitem", True),
    "direct_desc": (DIRECT_DESC, True),
    "direct_unordered": ("select l_linestatus, count(*), sum(l_quantity) "
                         "from lineitem group by l_linestatus", False),
}


@pytest.fixture(scope="module")
def runners():
    return JaxRunner.tpch(scale=SCALE), LocalQueryRunner.tpch(
        scale=SCALE, device="cpu")


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


@pytest.mark.parametrize("q", [1, 6])
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
    "select count(*) from lineitem, orders where l_orderkey = o_orderkey",
    "select l_orderkey, count(*) from lineitem group by l_orderkey",
    "select l_orderkey from lineitem order by l_orderkey limit 3",
    "show tables",
])
def test_unported_shapes_raise(runners, sql):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        runners[1].execute(sql)


def test_no_device_and_no_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalQueryRunner.tpch(scale=SCALE)


def test_runner_device_is_explicit():
    r = LocalQueryRunner.tpch(scale=SCALE, device="cpu")
    assert r.device == torch.device("cpu")
