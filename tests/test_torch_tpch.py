"""TPC-H parity: all 22 queries from presto_tpu_torch against presto_tpu at
SF0.01.

Each query goes through both packages' LocalQueryRunner: the JAX one with
its default config, the port on the CPU with its default config.  The
queries with semi and anti joins (Q4, Q16, Q18, Q20, Q21, Q22) run once
more with the port's hash tiers forced (``force_pages_hash``,
``hash_groupby_min_rows=0``: PagesHash serves every semi/anti build
through the claim loop, kernel B2's plain version) against the JAX
package with ``hash_groupby_min_rows=0``.  Rows must agree: keys and
counts exactly, doubles to 1e-9 relative, and in order (every query
orders its rows or returns one).  This file takes about three minutes
on one CPU core, most of it the JAX package's compiles.
"""

import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tpch_queries import QUERIES  # noqa: E402

from presto_tpu.config import EngineConfig as JaxConfig  # noqa: E402
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner  # noqa: E402
from presto_tpu_torch.config import EngineConfig  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402

SCALE = 0.01

# the queries whose plans hold a SemiJoinNode
SEMI_QUERIES = (4, 16, 18, 20, 21, 22)


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


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0)
            else:
                assert x == y and type(x) is type(y)


def _run(pair, q):
    jax_runner, torch_runner = pair
    want = jax_runner.execute(QUERIES[q])
    got = torch_runner.execute(QUERIES[q])
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == \
        [t.display() for t in want.column_types]
    assert len(want.rows) > 0
    _assert_rows_equal(got.rows, want.rows)
    return torch_runner


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_rows_match_jax(runners, q):
    _run(runners, q)


@pytest.mark.parametrize("q", SEMI_QUERIES)
def test_tpch_semi_joins_on_hash_tier_match_jax(hash_runners, q):
    torch_runner = _run(hash_runners, q)
    tiers = {s.kernel_tier for s in torch_runner._last_task.operator_stats
             if s.operator.endswith("LookupJoinOperator")}
    assert tiers == {"hash"}
