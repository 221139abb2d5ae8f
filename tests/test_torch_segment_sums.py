"""B1, the direct GROUP BY segment sums: the port's plain version against
the JAX package's Pallas kernel (interpret mode) and numpy, the
wrapper's checks and dispatch.  The CUDA kernel itself is held against
the plain version on a card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from presto_tpu.ops import pallas_groupby as P
from presto_tpu_torch.ops import groupby as PG
from presto_tpu_torch.ops import segment_sums as S


@pytest.mark.parametrize("n,a,g", [(4096, 5, 8), (65536, 13, 8),
                                   (8192, 3, 31)])
def test_plain_matches_pallas_interpret(n, a, g):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    gid = rng.integers(0, g, n).astype(np.int32)
    vals = rng.uniform(0, 1e5, (n, a))
    hi = vals.astype(np.float32)
    lo = (vals - hi.astype(np.float64)).astype(np.float32)
    ref = np.asarray(P.direct_segment_sums_pallas(
        jnp.asarray(gid), jnp.asarray(hi), jnp.asarray(lo), g,
        interpret=True))
    got = S.direct_segment_sums(torch.from_numpy(gid),
                                torch.from_numpy(vals), g).numpy()
    # the JAX side's per-dot float32 rounding bounds the error (the
    # bound of tests/test_pallas.py); the port sums in float64
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1)
    assert err.max() < 1e-6


def test_plain_matches_numpy_ragged():
    rng = np.random.default_rng(1)
    n, a, g = 100_003, 5, 32
    gid = rng.integers(0, g, n).astype(np.int32)
    vals = rng.uniform(-1e5, 1e5, (n, a))
    want = np.zeros((g, a))
    np.add.at(want, gid, vals)
    got = S.direct_segment_sums(torch.from_numpy(gid),
                                torch.from_numpy(vals), g).numpy()
    # both float64; only the order of the additions differs
    err = np.abs(got - want) / np.maximum(np.abs(want), 1)
    assert err.max() <= 1e-12


@pytest.mark.parametrize("case", ["dtype", "shape", "n_seg", "range",
                                  "contiguous"])
def test_wrapper_rejects_bad_input(case):
    gid = torch.zeros(8, dtype=torch.int32)
    vals = torch.ones((8, 3), dtype=torch.float64)
    n_seg = 4
    if case == "dtype":
        vals = vals.float()
    elif case == "shape":
        gid = gid[:7]
    elif case == "n_seg":
        n_seg = 33
    elif case == "range":
        gid[3] = 4
    elif case == "contiguous":
        vals = torch.ones((3, 8), dtype=torch.float64).t()
    with pytest.raises((TypeError, ValueError)):
        S.direct_segment_sums(gid, vals, n_seg)


@pytest.mark.parametrize("doms,calls", [([3, 2], 1), ([5, 7], 0)])
def test_gate_routes_small_domains_to_the_kernel(monkeypatch, doms, calls):
    """n_seg <= 32 goes through direct_segment_sums on every device (the
    CPU takes its plain version inside it); larger domains do not."""
    seen = []
    real = PG.direct_segment_sums

    def spy(gid, vals, n_seg):
        seen.append(n_seg)
        return real(gid, vals, n_seg)

    monkeypatch.setattr(PG, "direct_segment_sums", spy)
    rng = np.random.default_rng(2)
    n = 300
    keys = [(torch.from_numpy(rng.integers(0, d, n).astype(np.int32)),
             None) for d in doms]
    vals = torch.from_numpy(rng.uniform(0, 10, n))
    PG.direct_grouped_aggregate(keys, doms, [("sum", vals, None)], n)
    assert len(seen) == calls
    if calls:
        assert seen[0] == doms[0] * doms[1] + 1
