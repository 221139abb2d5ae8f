"""The port's direct and sort GROUP BY tiers and global aggregation
against the JAX package's, on the same numpy inputs: nullable keys, a
live mask, integer and float sums, counts, min/max, and domains on both
sides of the kernel gate (n_seg = 32).  Floats agree to 1e-9 relative,
the rest exactly.  Also the fixed-order float sums (hazard C2) and
double keys closer than a float32 ulp (hazard C4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu.ops import groupby as JG
from presto_tpu_torch.ops import groupby as PG


def _inputs(doms, nullable, cap, n_rows, seed):
    rng = np.random.default_rng(seed)
    keys = []
    for d, nl in zip(doms, nullable):
        codes = rng.integers(0, d, cap).astype(np.int32)
        valid = rng.random(cap) > 0.2 if nl else None
        keys.append((codes, valid))
    fvals = rng.uniform(-1e4, 1e4, cap)
    fvalid = rng.random(cap) > 0.1
    ivals = rng.integers(-(1 << 40), 1 << 40, cap).astype(np.int64)
    i32 = rng.integers(-1000, 1000, cap).astype(np.int32)
    aggs = [("sum", fvals, fvalid), ("sum", ivals, None),
            ("count", fvals, fvalid), ("min", i32, None),
            ("max", fvals, fvalid), ("min", fvals, None),
            ("max", ivals, None), ("count", None, None)]
    live = rng.random(cap) > 0.3
    return keys, aggs, live


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _close(got, want, floating):
    got, want = np.asarray(got), np.asarray(want)
    if floating:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("doms,nullable", [
    ([3, 2], [False, False]),          # Q1's shape: n_seg = 7
    ([4, 5], [True, False]),           # 5*5 + 1 = 26 <= 32: kernel gate
    ([6, 7], [False, True]),           # 6*8 + 1 = 49 > 32: index_add_
    ([40], [True]),                    # one nullable key, n_seg = 42
])
@pytest.mark.parametrize("masked", [False, True])
def test_direct_grouped_aggregate_matches_jax(doms, nullable, masked):
    cap, n_rows = 4096, 3900
    keys, aggs, live = _inputs(doms, nullable, cap, n_rows, len(doms))
    jpres, jres = JG.direct_grouped_aggregate(
        [(_jax(c), _jax(v)) for c, v in keys], doms,
        [(p, _jax(v), _jax(m)) for p, v, m in aggs], jnp.asarray(n_rows),
        live_mask=_jax(live) if masked else None)
    ppres, pres = PG.direct_grouped_aggregate(
        [(_torch(c), _torch(v)) for c, v in keys], doms,
        [(p, _torch(v), _torch(m)) for p, v, m in aggs], n_rows,
        live_mask=_torch(live) if masked else None)
    present = np.asarray(jpres)
    np.testing.assert_array_equal(ppres.numpy(), present)
    for (prim, vals, _m), (jv, jc), (pv, pc) in zip(aggs, jres, pres):
        np.testing.assert_array_equal(pc.numpy()[present],
                                      np.asarray(jc)[present])
        floating = vals is not None and vals.dtype.kind == "f"
        _close(pv.numpy()[present], np.asarray(jv)[present],
               floating and prim == "sum")
    slots = np.nonzero(present)[0]
    jkeys = JG.decode_direct_keys(jnp.asarray(slots),
                                  [v is not None for _c, v in keys], doms)
    pkeys = PG.decode_direct_keys(torch.from_numpy(slots),
                                  [v is not None for _c, v in keys], doms)
    for (jc, jv), (pc, pv) in zip(jkeys, pkeys):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        if jv is None:
            assert pv is None
        else:
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("masked", [False, True])
def test_global_aggregate_matches_jax(masked):
    cap, n_rows = 5000, 4321
    _keys, aggs, live = _inputs([2], [False], cap, n_rows, 7)
    aggs = [(p, v if v is not None else aggs[0][1], m)
            for p, v, m in aggs]
    jres = JG.global_aggregate(
        [(p, _jax(v), _jax(m)) for p, v, m in aggs], jnp.asarray(n_rows),
        live_mask=_jax(live) if masked else None)
    pres = PG.global_aggregate(
        [(p, _torch(v), _torch(m)) for p, v, m in aggs], n_rows,
        live_mask=_torch(live) if masked else None)
    for (prim, vals, _m), (jv, jc), (pv, pc) in zip(aggs, jres, pres):
        assert int(pc) == int(jc)
        _close(pv.numpy(), np.asarray(jv),
               vals.dtype.kind == "f" and prim == "sum")


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sort_tier_grouped_aggregate_matches_jax(nullable, masked):
    """The sort tier: the same groups in the same (key-word) order, the
    same representative rows, counts and integer results exactly, float
    sums to 1e-9 relative."""
    from presto_tpu import types as JT
    from presto_tpu_torch import types as T

    cap, n_rows = 4096, 3900
    rng = np.random.default_rng(21)
    k1 = rng.integers(-500, 500, cap).astype(np.int64)
    k1v = rng.random(cap) > 0.2 if nullable else None
    k2 = rng.uniform(-3, 3, cap).round(0)          # a DOUBLE key
    _keys, aggs, live = _inputs([2], [False], cap, n_rows, 21)
    jkeys = [(_jax(k1), _jax(k1v), JT.BIGINT), (_jax(k2), None, JT.DOUBLE)]
    pkeys = [(_torch(k1), _torch(k1v), T.BIGINT),
             (_torch(k2), None, T.DOUBLE)]
    jgi, jng, jres = JG.grouped_aggregate(
        jkeys, [(p, _jax(v), _jax(m)) for p, v, m in aggs],
        jnp.asarray(n_rows), 4096,
        live_mask=_jax(live) if masked else None)
    pgi, png, pres = PG.grouped_aggregate(
        pkeys, [(p, _torch(v), _torch(m)) for p, v, m in aggs], n_rows,
        live_mask=_torch(live) if masked else None)
    ng = int(jng)
    assert png == ng
    np.testing.assert_array_equal(pgi.numpy(), np.asarray(jgi)[:ng])
    for (prim, vals, _m), (jv, jc), (pv, pc) in zip(aggs, jres, pres):
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc)[:ng])
        floating = vals is not None and vals.dtype.kind == "f"
        _close(pv.numpy(), np.asarray(jv)[:ng], floating and prim == "sum")


def test_fixed_order_sums_are_row_order_sums():
    """The one fixed-order reduction: each group's sum is its rows added
    in row order, so it equals a sequential float64 loop bit for bit."""
    rng = np.random.default_rng(4)
    gid = rng.integers(0, 50, 3000)
    vals = rng.uniform(-1e6, 1e6, 3000) * 10.0 ** rng.integers(-8, 8, 3000)
    ids, sums = PG.fixed_order_segment_sums(_torch(gid), _torch(vals))
    want = {}
    for g, v in zip(gid.tolist(), vals.tolist()):
        want[g] = want.get(g, 0.0) + v
    assert ids.tolist() == sorted(want)
    assert sums.tolist() == [want[g] for g in sorted(want)]
    dense = PG.segment_sums(_torch(gid), _torch(vals), 60)
    assert dense[ids].tolist() == sums.tolist()
    assert float(dense[50:].abs().sum()) == 0.0


def test_sub_f32_double_keys_stay_distinct():
    """C4: doubles that differ by less than a float32 ulp are distinct
    group keys (the exact float64 bits key them, not a float32 cast)."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.ops import hashtable as H

    base = np.array([1000.0, 1000.0 + 1e-9, 1000.0 + 2e-9, -5.0,
                     -5.0 - 1e-12, 0.0])
    keys = np.tile(base, 3)
    assert len(set(np.float32(base).tolist())) < len(set(base.tolist()))
    _gi, ng, res = PG.grouped_aggregate(
        [(_torch(keys), None, T.DOUBLE)], [("count", None, None)],
        len(keys))
    assert ng == len(base) and res[0][0].tolist() == [3] * ng
    state = H.groupby_init(64, 2, [torch.float64], [True],
                           [("count", None)], "cpu")
    state, hng, ok = H.groupby_update(
        state, [(_torch(keys), None, T.DOUBLE)], [("count", None, None)],
        len(keys))
    assert ok and hng == len(base)
    tw, tc, starts, counts, perm, _null, ok = H.pages_hash_build(
        [(_torch(base), None, T.DOUBLE)], len(base), 64)
    lo, cnt, _live = H.pages_hash_probe((tw, tc, starts, counts),
                                        [(_torch(keys), None, T.DOUBLE)],
                                        len(keys))
    assert ok and cnt.tolist() == [1] * len(keys)
    assert perm[lo].tolist() == list(range(len(base))) * 3
