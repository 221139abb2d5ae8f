"""presto_tpu_torch on a CUDA card: the hand-written kernels against
their plain PyTorch versions, and SQL on cuda against the same SQL on
the CPU.  Every test here needs the card and skips without one.

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

from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402
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
