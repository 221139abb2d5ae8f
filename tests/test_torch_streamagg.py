"""Streaming aggregation parity: presto_tpu_torch against presto_tpu.

The cases of ``tests/test_streamagg.py`` run through both packages'
LocalQueryRunner at TPC-H SF0.01 (the port on the CPU): a GROUP BY on the
scan's sort key takes StreamingAggregationOperator in both, its rows
equal the JAX package's and the port's own hash/sort tiers', the carry
survives 64-row batches, a multi-key prefix streams, and a key that is
not a sort-order prefix does not.  TPC-H Q18's ``group by l_orderkey``
must stream in both packages.  Keys and counts compare exactly, doubles
to 1e-9 relative.
"""

import dataclasses
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tpch_queries import QUERIES  # noqa: E402

from presto_tpu.config import EngineConfig as JaxConfig  # noqa: E402
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner  # noqa: E402
from presto_tpu_torch.config import EngineConfig  # noqa: E402
from presto_tpu_torch.exec.streamagg import _read_host  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402

SCALE = 0.01


def _pair(streaming: bool, batch_rows: int = 4096):
    jcfg = dataclasses.replace(JaxConfig(),
                               streaming_aggregation_enabled=streaming,
                               task_concurrency=1,
                               scan_batch_rows=batch_rows)
    cfg = EngineConfig(streaming_aggregation_enabled=streaming,
                       task_concurrency=1, scan_batch_rows=batch_rows)
    return (JaxRunner.tpch(scale=SCALE, config=jcfg),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu", config=cfg))


@pytest.fixture(scope="module")
def on():
    return _pair(True)


@pytest.fixture(scope="module")
def off():
    return _pair(False)


def _rows_equal(a, b):
    a = sorted(a, key=repr)
    b = sorted(b, key=repr)
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            if isinstance(v, float):
                assert u == pytest.approx(v, rel=1e-9, abs=0.0), (x, y)
            else:
                assert u == v and type(u) is type(v), (x, y)


def _streams(runner) -> bool:
    return any("StreamingAggregation" in s.operator
               for s in runner._last_task.operator_stats)


def _same(pair, off_pair, sql, streams: bool):
    jax_runner, runner = pair
    want = jax_runner.execute(sql).rows
    assert _streams(jax_runner) == streams
    got = runner.execute(sql).rows
    assert _streams(runner) == streams
    assert len(want) > 0
    _rows_equal(got, want)
    # the port's own hash/sort tiers agree with its streaming tier
    _rows_equal(off_pair[1].execute(sql).rows, got)
    assert not _streams(off_pair[1])


def test_clustered_group_by(on, off):
    # l_orderkey is the lineitem sort key: the streaming path engages
    _same(on, off,
          "select l_orderkey, count(*), sum(l_quantity), "
          "min(l_extendedprice), max(l_discount) from lineitem "
          "group by l_orderkey", True)


def test_carry_across_tiny_batches(off):
    # 64-row batches make many groups straddle batch boundaries
    _same(_pair(True, batch_rows=64), off,
          "select l_orderkey, count(*), sum(l_extendedprice) "
          "from lineitem where l_orderkey < 500 group by l_orderkey", True)


def test_multi_key_prefix(on, off):
    _same(on, off,
          "select l_orderkey, l_linenumber, sum(l_quantity) "
          "from lineitem group by l_orderkey, l_linenumber", True)


def test_non_prefix_uses_hash(on, off):
    # l_partkey is not the sort key: the hash/sort tiers take it
    _same(on, off,
          "select l_partkey, count(*) from lineitem "
          "where l_partkey < 50 group by l_partkey", False)


def test_filtered_clustered(on, off):
    _same(on, off,
          "select o_orderkey, count(*) from orders "
          "where o_totalprice > 100000 group by o_orderkey", True)


def test_q18_streams_its_orderkey_group_by():
    """Q18's IN subquery (``group by l_orderkey having sum(l_quantity) >
    300``) streams in both packages at their default configs."""
    jax_runner = JaxRunner.tpch(scale=SCALE)
    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu")
    want = jax_runner.execute(QUERIES[18]).rows
    got = runner.execute(QUERIES[18]).rows
    ops = [s.operator for s in runner._last_task.operator_stats]
    jops = [s.operator for s in jax_runner._last_task.operator_stats]
    assert [o for o in ops if "StreamingAggregation" in o] == \
        [o for o in jops if "StreamingAggregation" in o]
    assert any("StreamingAggregation" in o for o in ops), ops
    assert got == want


def test_read_host_round_trips_every_dtype():
    """The one device read a batch makes packs tensors of several dtypes
    into int64 words and back, floats by their bits."""
    parts = [torch.tensor([3, -1], dtype=torch.int64),
             torch.tensor([-0.0, float("nan")], dtype=torch.float64),
             torch.tensor([1.5, -2.25], dtype=torch.float32),
             torch.tensor([7, -8], dtype=torch.int32),
             torch.tensor([True, False])]
    for got, want in zip(_read_host(parts), parts):
        assert got.dtype == want.numpy().dtype
        assert got.tobytes() == want.numpy().tobytes()
