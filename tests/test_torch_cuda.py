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


@pytest.mark.parametrize("n,a,g", [(1 << 20, 19, 7), (1_000_003, 5, 32),
                                   (1, 1, 1), (0, 3, 2)])
def test_segment_sums_kernel_matches_plain(card, n, a, g):
    gen = torch.Generator(device=card).manual_seed(n)
    gid = torch.randint(0, g, (n,), generator=gen, device=card,
                        dtype=torch.int32)
    vals = torch.rand((n, a), generator=gen, device=card,
                      dtype=torch.float64) * 1e5
    before = S.LAUNCHES.count
    got = S.direct_segment_sums(gid, vals, g)
    again = S.direct_segment_sums(gid, vals, g)
    want = S.direct_segment_sums_reference(gid, vals, g)
    torch.cuda.synchronize()
    assert S.LAUNCHES.count == before + 2
    # both float64: only the order of the additions differs
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    assert float(err.max()) <= 1e-12 if n else torch.equal(got, want)
    # no float atomics: the same bits on every run
    assert torch.equal(got, again)


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
    storm, a full table): the claim loop's partition, found flags and
    ok, on every repeat."""
    before = (B2.INSERT_LAUNCHES.count, B2.LOOKUP_LAUNCHES.count)
    inserts, lookups = C.b2_checks(seed=3)
    assert [c["ok"] for c in inserts] == [True, False, True, True, False]
    assert lookups[0]["found"] > 0
    assert B2.INSERT_LAUNCHES.count > before[0]
    assert B2.LOOKUP_LAUNCHES.count > before[1]


def test_float_group_sums_bit_identical_on_every_tier(card):
    """C2: the direct (above 32 groups), sort and hash tiers give the
    same bits on a repeat (and agree with index_add_ to 1e-9)."""
    out = C.c2_checks(seed=5)
    assert set(out) == {"direct", "sort", "hash"}


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
