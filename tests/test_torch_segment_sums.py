"""B1, the direct GROUP BY segment sums: the port's plain version against
the JAX package's Pallas kernel (interpret mode) and numpy, the
wrapper's checks and dispatch, and the direct tier on a Q1-shaped input
against the JAX package's.  The CUDA kernel itself is held against the
plain version on a card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu.ops import groupby as JG
from presto_tpu.ops import pallas_groupby as P
from presto_tpu_torch.ops import groupby as PG
from presto_tpu_torch.ops import segment_sums as S


def _columns(vals: np.ndarray):
    """The columns of a numpy ``[N, A]`` matrix, each its own contiguous
    float64 tensor, as the direct tier hands them to the kernel."""
    return [torch.from_numpy(np.ascontiguousarray(vals[:, j]))
            for j in range(vals.shape[1])]


@pytest.mark.parametrize("n,a,g", [(4096, 5, 8), (65536, 13, 8),
                                   (8192, 3, 31)])
def test_plain_matches_pallas_interpret(n, a, g):
    rng = np.random.default_rng(0)
    gid = rng.integers(0, g, n).astype(np.int32)
    vals = rng.uniform(0, 1e5, (n, a))
    hi = vals.astype(np.float32)
    lo = (vals - hi.astype(np.float64)).astype(np.float32)
    ref = np.asarray(P.direct_segment_sums_pallas(
        jnp.asarray(gid), jnp.asarray(hi), jnp.asarray(lo), g,
        interpret=True))
    got, bad = S.direct_segment_sums(torch.from_numpy(gid), _columns(vals),
                                     g)
    assert int(bad[0]) == 0
    # the JAX side's per-dot float32 rounding bounds the error (the
    # bound of tests/test_pallas.py); the port sums in float64
    err = np.abs(got.numpy() - ref) / np.maximum(np.abs(ref), 1)
    assert err.max() < 1e-6


def test_plain_matches_numpy_ragged():
    rng = np.random.default_rng(1)
    n, a, g = 100_003, 5, 32
    gid = rng.integers(0, g, n).astype(np.int32)
    vals = rng.uniform(-1e5, 1e5, (n, a))
    want = np.zeros((g, a))
    np.add.at(want, gid, vals)
    got, _bad = S.direct_segment_sums(torch.from_numpy(gid),
                                      _columns(vals), g)
    # both float64; only the order of the additions differs
    err = np.abs(got.numpy() - want) / np.maximum(np.abs(want), 1)
    assert err.max() <= 1e-12


@pytest.mark.parametrize("case", ["dtype", "shape", "n_seg", "range",
                                  "contiguous", "unequal_length",
                                  "column_dtype", "strided_column",
                                  "no_columns", "gid_dtype"])
def test_wrapper_rejects_bad_input(case):
    gid = torch.zeros(8, dtype=torch.int32)
    cols = [torch.ones(8, dtype=torch.float64) for _ in range(3)]
    n_seg = 4
    if case == "dtype":
        cols = [c.float() for c in cols]
    elif case == "shape":
        gid = gid[:7]
    elif case == "n_seg":
        n_seg = 33
    elif case == "range":
        gid[3] = 4
    elif case == "contiguous":
        # the columns of a row-major [N, A] matrix, as views
        cols = list(torch.ones((8, 3), dtype=torch.float64).unbind(1))
    elif case == "gid_dtype":
        gid = gid.long()
    elif case == "unequal_length":
        cols[1] = cols[1][:7]
    elif case == "column_dtype":
        cols[2] = cols[2].float()
    elif case == "strided_column":
        cols[0] = torch.ones(16, dtype=torch.float64)[::2]
    elif case == "no_columns":
        cols = []
    with pytest.raises((TypeError, ValueError)):
        S.direct_segment_sums(gid, cols, n_seg)


@pytest.mark.parametrize("doms,calls", [([3, 2], 1), ([5, 7], 0)])
def test_gate_routes_small_domains_to_the_kernel(monkeypatch, doms, calls):
    """n_seg <= 32 goes through direct_segment_sums on every device (the
    CPU takes its plain version inside it), with the columns as they are
    (no stacked matrix); larger domains do not."""
    seen = []
    real = PG.direct_segment_sums

    def spy(gid, cols, n_seg):
        seen.append((n_seg, [c.shape for c in cols]))
        return real(gid, cols, n_seg)

    monkeypatch.setattr(PG, "direct_segment_sums", spy)
    rng = np.random.default_rng(2)
    n = 300
    keys = [(torch.from_numpy(rng.integers(0, d, n).astype(np.int32)),
             None) for d in doms]
    vals = torch.from_numpy(rng.uniform(0, 10, n))
    PG.direct_grouped_aggregate(keys, doms, [("sum", vals, None)], n)
    assert len(seen) == calls
    if calls:
        # the float sum, its count and the group-present count
        assert seen[0] == (doms[0] * doms[1] + 1, [(n,)] * 3)


def test_direct_tier_on_q1_shape_matches_jax():
    """The direct tier on Q1's shape (two dictionary keys of 3 and 2
    codes, a WHERE mask, padded rows, the sums and avg decompositions of
    Q1, count(*), nulls in one value column) against the JAX package's:
    floats within 1e-12 relative, counts and the present groups exact."""
    rng = np.random.default_rng(4)
    cap, n_rows = 8192, 7777
    rf = rng.integers(0, 3, cap).astype(np.int32)
    ls = rng.integers(0, 2, cap).astype(np.int32)
    qty = rng.integers(1, 51, cap).astype(np.float64)
    price = rng.uniform(900.0, 105_000.0, cap)
    disc = rng.integers(0, 11, cap) / 100.0
    tax = rng.integers(0, 9, cap) / 100.0
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    disc_valid = rng.random(cap) > 0.05
    where = rng.random(cap) > 0.02
    aggs = [("sum", qty, None), ("sum", price, None),
            ("sum", disc_price, None), ("sum", charge, None),
            ("sum", qty, None), ("sum", price, None),
            ("sum", disc, disc_valid), ("count", None, None)]
    jpres, jres = JG.direct_grouped_aggregate(
        [(jnp.asarray(rf), None), (jnp.asarray(ls), None)], [3, 2],
        [(p, None if v is None else jnp.asarray(v),
          None if m is None else jnp.asarray(m)) for p, v, m in aggs],
        jnp.asarray(n_rows), live_mask=jnp.asarray(where))
    ppres, pres, bad = PG.direct_grouped_aggregate(
        [(torch.from_numpy(rf), None), (torch.from_numpy(ls), None)],
        [3, 2],
        [(p, None if v is None else torch.from_numpy(v),
          None if m is None else torch.from_numpy(m)) for p, v, m in aggs],
        n_rows, live_mask=torch.from_numpy(where))
    assert int(bad[0]) == 0
    present = np.asarray(jpres)
    assert present.sum() == 6
    np.testing.assert_array_equal(ppres.numpy(), present)
    for (prim, _v, _m), (jv, jc), (pv, pc) in zip(aggs, jres, pres):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        if prim == "sum":
            np.testing.assert_allclose(pv.numpy()[present],
                                       np.asarray(jv)[present],
                                       rtol=1e-12, atol=0.0)
        else:
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
