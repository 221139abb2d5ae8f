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
