"""The port's direct GROUP BY tier and global aggregation against the JAX
package's, on the same numpy inputs: nullable keys, a live mask,
integer and float sums, counts, min/max, and domains on both sides of
the kernel gate (n_seg = 32).  Floats agree to 1e-9 relative, the rest
exactly."""

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
