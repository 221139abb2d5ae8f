"""The port's open-addressing hash tables (ops/hashtable.py, the CPU side
of kernel B2 in ops/probe_insert.py) against the JAX package's, on the
same numpy inputs.

- The hash and the slot/prefix split are bit-equal, negative keys and
  int64 extremes included.
- The claim loop is deterministic in both packages, so ``probe_insert``
  and ``probe_find`` agree slot for slot, and ``ok`` with them.
- The serial Pallas kernel (interpret mode) gives other slot ids; the
  group partition must agree.
- GroupByHash and PagesHash results agree: keys, counts and integer
  results exactly, float sums to 1e-9 relative.
- The hash-table cases of tests/test_pallas.py run again on the port.
"""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu import types as JT
from presto_tpu.ops import hashtable as JH
from presto_tpu_torch import types as T
from presto_tpu_torch.ops import hashtable as H
from presto_tpu_torch.ops import probe_insert as B2

_EDGES = np.array([0, 1, -1, 2**63 - 1, -2**63, -2**63 + 1, 2**62,
                   -2**62, 0x2545F4914F6CDD1D, -0x2545F4914F6CDD1D],
                  dtype=np.int64)


def _words(seed, n, k):
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(k):
        w = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                         endpoint=True)
        w[:len(_EDGES)] = _EDGES
        cols.append(w)
    return cols


@pytest.mark.parametrize("k", [1, 2, 3])
def test_hash_words_and_slot_prefix_bit_equal_jax(k):
    words = _words(k, 5000, k)
    jh = np.asarray(JH.hash_words([jnp.asarray(w) for w in words]))
    ph = H.hash_words([torch.from_numpy(w) for w in words])
    assert ph.dtype == torch.int64
    np.testing.assert_array_equal(ph.numpy().view(np.uint64), jh)
    for cap in (1, 64, 1 << 20):
        js, jp = JH.slot_and_prefix(jnp.asarray(jh), cap)
        ps, pp = H.slot_and_prefix(ph, cap)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        assert pp.dtype == torch.uint8
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


def _jax_insert(words, live, cap):
    tw = tuple(jnp.zeros(cap, jnp.int64) for _ in words)
    slot, tw, tp, tu, ok = JH.probe_insert(
        [jnp.asarray(w) for w in words], jnp.asarray(live), tw,
        jnp.zeros(cap, jnp.uint8), jnp.zeros(cap, bool))
    return np.asarray(slot), (tw, tp, tu), bool(ok)


def _port_insert(words, live, cap):
    keys = torch.from_numpy(np.stack(words, 1))
    tw, tc = H.empty_table(cap, len(words), "cpu")
    slot, ok = H.probe_insert(keys, torch.from_numpy(live), tw, tc)
    return slot.numpy(), (tw, tc), ok


@pytest.mark.parametrize("n,n_keys,k,cap,live_frac", [
    (2048, 700, 1, 2048, 1.0),       # the collision storm
    (3000, 900, 2, 4096, 0.8),       # two words, dead rows
    (1000, 1000, 1, 64, 1.0),        # a full table: ok is False
    (4096, 4096, 3, 8192, 0.9),      # all distinct, half full
])
def test_claim_loop_slot_for_slot_equal_jax(n, n_keys, k, cap, live_frac):
    rng = np.random.default_rng(n + k)
    ids = rng.integers(0, n_keys, n)
    table = _words(cap, n_keys, k)
    words = [w[ids] for w in table]
    live = rng.random(n) < live_frac
    jslot, jtable, jok = _jax_insert(words, live, cap)
    pslot, ptable, pok = _port_insert(words, live, cap)
    assert pok == jok == (cap != 64)
    np.testing.assert_array_equal(pslot, jslot)
    # the lookup walks agree too, on present and absent keys
    probe_ids = rng.integers(0, 2 * n_keys, 3000)
    extra = _words(cap + 1, n_keys, k)
    probe = [np.where(probe_ids < n_keys, t[probe_ids % n_keys],
                      e[probe_ids % n_keys]) for t, e in zip(table, extra)]
    plive = rng.random(3000) < 0.9
    jfs, jff = JH.probe_find([jnp.asarray(w) for w in probe],
                             jnp.asarray(plive), *jtable)
    pfs, pff = H.probe_find(torch.from_numpy(np.stack(probe, 1)),
                            torch.from_numpy(plive), *ptable)
    np.testing.assert_array_equal(pff.numpy(), np.asarray(jff))
    np.testing.assert_array_equal(pfs.numpy(), np.asarray(jfs))


def _canonical(keys, slots):
    """Relabel slots by first occurrence: equal arrays <=> the same group
    partition of the rows."""
    first = {}
    out = []
    for s in slots.tolist():
        out.append(first.setdefault(s, len(first)))
    assert len(set(map(tuple, keys.tolist()))) == len(first)
    return np.asarray(out)


def test_partition_equal_to_pallas_interpret():
    from presto_tpu.ops import pallas_hash as PH

    if not PH.available():
        pytest.skip("pallas unavailable in this jax")
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 700, 2048).astype(np.int64)
    twp, tpp, tup = PH.empty_table_i32(2048, 1)
    slot_p, _, _, _ = PH.pallas_probe_insert(
        [jnp.asarray(keys)], jnp.ones(2048, bool), twp, tpp, tup,
        interpret=True)
    tw, tc = H.empty_table(2048, 1, "cpu")
    slot_t, ok = B2.insert(torch.from_numpy(keys[:, None]), None, tw, tc)
    assert ok
    k2 = keys[:, None]
    np.testing.assert_array_equal(_canonical(k2, slot_t.numpy()),
                                  _canonical(k2, np.asarray(slot_p)))


def _jax_state_map(state, nkeys):
    n, key_outs, agg_outs = JH.groupby_extract(state)
    return _state_map(int(n), [(np.asarray(v), None if m is None
                                else np.asarray(m)) for v, m in key_outs],
                      [(np.asarray(a), np.asarray(c)) for a, c in agg_outs])


def _port_state_map(state):
    n, key_outs, agg_outs = H.groupby_extract(state)
    return _state_map(n, [(v.numpy(), None if m is None else m.numpy())
                          for v, m in key_outs],
                      [(a.numpy(), c.numpy()) for a, c in agg_outs])


def _state_map(n, key_outs, agg_outs):
    out = {}
    for i in range(n):
        key = tuple(int(v[i]) if (m is None or m[i]) else None
                    for v, m in key_outs)
        assert key not in out
        out[key] = tuple((a[i].item(), int(c[i])) for a, c in agg_outs)
    return out


def _assert_maps_equal(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        for (gv, gc), (wv, wc) in zip(got[key], w):
            assert gc == wc
            if isinstance(wv, float):
                assert gv == pytest.approx(wv, rel=1e-9, abs=0.0)
            else:
                assert gv == wv


def test_groupby_update_rehash_extract_equal_jax():
    rng = np.random.default_rng(13)
    specs = [("sum", np.float64), ("count", None), ("min", np.float64),
             ("max", np.int64), ("sum", np.int64)]
    jstate = JH.groupby_init(4096, 4, [np.dtype(np.int64),
                                       np.dtype(np.int32)], [True, True],
                             [(p, None if d is None else np.dtype(d))
                              for p, d in specs])
    pstate = H.groupby_init(4096, 4, [torch.int64, torch.int32],
                            [True, True],
                            [(p, None if d is None else
                              torch.from_numpy(np.zeros(1, d)).dtype)
                             for p, d in specs], "cpu")
    prims = [p for p, _d in specs]
    for batch, cap in ((0, None), (1, 8192), (2, None)):
        n = 3000
        k1 = rng.integers(-300, 300, n).astype(np.int64)
        k2 = rng.integers(0, 3, n).astype(np.int32)
        v1 = rng.random(n) > 0.1
        fv = rng.uniform(-1e3, 1e3, n)
        fvalid = rng.random(n) > 0.2
        iv = rng.integers(-1 << 40, 1 << 40, n).astype(np.int64)
        live = rng.random(n) > 0.15
        cols = [(k1, v1, "bigint"), (k2, None, "integer")]
        aggs = [("sum", fv, fvalid), ("count", None, None),
                ("min", fv, None), ("max", iv, fvalid), ("sum", iv, None)]
        jstate, jng, jok = JH.groupby_update(
            jstate, [(jnp.asarray(v), None if m is None else jnp.asarray(m),
                      JT.BIGINT if t == "bigint" else JT.INTEGER)
                     for v, m, t in cols],
            [(p, None if v is None else jnp.asarray(v),
              None if m is None else jnp.asarray(m)) for p, v, m in aggs],
            jnp.asarray(n - 7), live_mask=jnp.asarray(live))
        pstate, png, pok = H.groupby_update(
            pstate, [(torch.from_numpy(v), None if m is None
                      else torch.from_numpy(m),
                      T.BIGINT if t == "bigint" else T.INTEGER)
                     for v, m, t in cols],
            [(p, None if v is None else torch.from_numpy(v),
              None if m is None else torch.from_numpy(m))
             for p, v, m in aggs], n - 7, live_mask=torch.from_numpy(live))
        assert bool(jok) and pok and int(jng) == png
        if cap is not None:
            jstate, jok = JH.groupby_rehash(jstate, cap, prims)
            pstate, pok = H.groupby_rehash(pstate, cap, prims)
            assert bool(jok) and pok
    _assert_maps_equal(_port_state_map(pstate), _jax_state_map(jstate, 2))


def test_pages_hash_build_probe_equal_jax():
    rng = np.random.default_rng(11)
    bk = rng.integers(-300, 300, 1024)
    bvalid = rng.random(1024) > 0.1
    bk2 = rng.integers(0, 4, 1024)
    pk = rng.integers(-600, 600, 2048)
    pvalid = rng.random(2048) > 0.1
    pk2 = rng.integers(0, 4, 2048)
    jt = JH.pages_hash_build(
        [(jnp.asarray(bk), jnp.asarray(bvalid), JT.BIGINT),
         (jnp.asarray(bk2), None, JT.BIGINT)], jnp.asarray(1000), 2048)
    pt = H.pages_hash_build(
        [(torch.from_numpy(bk), torch.from_numpy(bvalid), T.BIGINT),
         (torch.from_numpy(bk2), None, T.BIGINT)], 1000, 2048)
    jtw, jtp, jtu, jstarts, jcounts, jperm, jnull, jok = jt
    ptw, ptc, pstarts, pcounts, pperm, pnull, pok = pt
    assert bool(jok) and pok and bool(jnull) == bool(pnull)
    np.testing.assert_array_equal(pstarts.numpy(), np.asarray(jstarts))
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(jperm))
    jlo, jcnt, jlive = JH.pages_hash_probe(
        (jtw, jtp, jtu, jstarts, jcounts),
        [(jnp.asarray(pk), jnp.asarray(pvalid), JT.BIGINT),
         (jnp.asarray(pk2), None, JT.BIGINT)], jnp.asarray(2000))
    plo, pcnt, plive = H.pages_hash_probe(
        (ptw, ptc, pstarts, pcounts),
        [(torch.from_numpy(pk), torch.from_numpy(pvalid), T.BIGINT),
         (torch.from_numpy(pk2), None, T.BIGINT)], 2000)
    np.testing.assert_array_equal(pcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(plo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(plive.numpy(), np.asarray(jlive))


# ---------------------------------------------------------------------------
# the hash-table cases of tests/test_pallas.py, on the port
# ---------------------------------------------------------------------------

def _oracle(keys, valid, vals):
    ref_sum = collections.defaultdict(float)
    ref_cnt = collections.defaultdict(int)
    for i, k in enumerate(keys):
        kk = int(k) if (valid is None or valid[i]) else None
        ref_sum[kk] += float(vals[i])
        ref_cnt[kk] += 1
    return ref_sum, ref_cnt


def _extract(state):
    n, key_outs, agg_outs = H.groupby_extract(state)
    kv, kvalid = key_outs[0]
    out = {}
    for i in range(n):
        kk = int(kv[i]) if kvalid is None or bool(kvalid[i]) else None
        out[kk] = tuple(float(acc[i]) for acc, _nn in agg_outs)
    return n, out


def _update(state, keys, valid, aggs, n):
    return H.groupby_update(
        state, [(torch.from_numpy(keys), None if valid is None
                 else torch.from_numpy(valid), T.BIGINT)],
        [(p, None if v is None else torch.from_numpy(v), None)
         for p, v in aggs], n)


def test_port_groupby_collision_storm():
    rng = np.random.default_rng(7)
    n = 8192
    keys = rng.integers(0, 4096, n)           # ~4096 groups, 8192 slots
    vals = rng.uniform(-100, 100, n)
    state = H.groupby_init(8192, 2, [torch.int64], [True],
                           [("sum", torch.float64), ("count", None)], "cpu")
    state, ng, ok = _update(state, keys, None,
                            [("sum", vals), ("count", None)], n)
    assert ok
    ref_sum, ref_cnt = _oracle(keys, None, vals)
    got_n, got = _extract(state)
    assert got_n == ng == len(ref_sum)
    for kk, s in ref_sum.items():
        assert got[kk][0] == pytest.approx(s, rel=1e-9, abs=1e-7)
        assert got[kk][1] == ref_cnt[kk]


def test_port_groupby_null_keys_form_one_group():
    rng = np.random.default_rng(3)
    n = 4096
    keys = rng.integers(0, 64, n)
    valid = rng.random(n) > 0.3
    vals = np.ones(n)
    state = H.groupby_init(1024, 2, [torch.int64], [True],
                           [("sum", torch.float64)], "cpu")
    state, ng, ok = _update(state, keys, valid, [("sum", vals)], n)
    assert ok
    ref_sum, _ = _oracle(keys, valid, vals)
    got_n, got = _extract(state)
    assert got_n == len(ref_sum)
    assert got[None][0] == ref_sum[None]


def test_port_groupby_rehash_boundary_carries_minmax_identities():
    n = 2048
    keys1 = np.arange(n) % 400
    vals1 = np.arange(n, dtype=np.float64) + 100.0
    state = H.groupby_init(1024, 2, [torch.int64], [True],
                           [("min", torch.float64), ("max", torch.float64)],
                           "cpu")
    state, ng, ok = _update(state, keys1, None,
                            [("min", vals1), ("max", vals1)], n)
    assert ok and ng == 400
    state, ok = H.groupby_rehash(state, 4096, ["min", "max"])
    assert ok
    keys2 = 1000 + (np.arange(n) % 400)
    vals2 = np.arange(n, dtype=np.float64) + 500.0
    state, ng, ok = _update(state, keys2, None,
                            [("min", vals2), ("max", vals2)], n)
    assert ok and ng == 800
    got_n, got = _extract(state)
    assert got_n == 800
    for keys, vals in ((keys1, vals1), (keys2, vals2)):
        for k in set(keys.tolist()):
            m = keys == k
            assert got[k] == (vals[m].min(), vals[m].max())


def test_port_insert_full_table_not_ok_accumulates_nothing():
    state = H.groupby_init(64, 2, [torch.int64], [True],
                           [("sum", torch.float64)], "cpu")
    keys = np.arange(1000)
    state2, _ng, ok = _update(state, keys, None, [("sum", np.ones(1000))],
                              1000)
    assert not ok
    assert float(state2[3][0][0].sum()) == 0.0
    assert int(state2[3][0][1].sum()) == 0


def test_failed_update_leaves_state_as_jax_does():
    """An insert that fails part-way leaves the table as it was: the keys
    it placed before the probe bound tripped are taken out again through
    its journal and are not extracted (the JAX package drops the failed
    state whole)."""
    specs = [("sum", np.float64), ("count", None)]
    jstate = JH.groupby_init(64, 2, [np.dtype(np.int64)], [True],
                             [(p, None if d is None else np.dtype(d))
                              for p, d in specs])
    pstate = H.groupby_init(64, 2, [torch.int64], [True],
                            [("sum", torch.float64), ("count", None)], "cpu")
    rng = np.random.default_rng(5)
    for n, hi, want_ok in ((40, 20, True), (1000, 1000, False)):
        keys = rng.integers(0, hi, n).astype(np.int64)
        vals = rng.uniform(-10, 10, n)
        jnew, _jng, jok = JH.groupby_update(
            jstate, [(jnp.asarray(keys), None, JT.BIGINT)],
            [("sum", jnp.asarray(vals), None), ("count", None, None)],
            jnp.asarray(n))
        ctrl_before = pstate[1].clone()
        pstate, png, pok = _update(pstate, keys, None,
                                   [("sum", vals), ("count", None)], n)
        assert bool(jok) == pok == want_ok
        if jok:
            jstate = jnew
        else:
            # undone through the insert's journal: the control words are
            # those from before the batch, the group count the state's
            assert torch.equal(pstate[1], ctrl_before)
        # the JAX caller keeps the old state when ok is False
        assert png == pstate[4] == int(JH.groupby_extract(jstate)[0])
        _assert_maps_equal(_port_state_map(pstate),
                           _jax_state_map(jstate, 1))


def test_port_prefix_reject_byte_is_slot_independent():
    h = H.hash_words([torch.arange(1 << 14, dtype=torch.int64)])
    slot, prefix = H.slot_and_prefix(h, 256)
    slot, prefix = slot.numpy(), prefix.numpy()
    for s in (0, 17, 255):
        ps = prefix[slot == s]
        assert len(ps) > 0
        assert len(np.unique(ps)) > len(ps) // 2
    pool = np.arange(1 << 14)
    same = pool[(slot == slot[0]) & (prefix == prefix[0])]
    if len(same) >= 2:
        keys = np.repeat(same[:2], 8).astype(np.int64)
        state = H.groupby_init(256, 2, [torch.int64], [True],
                               [("count", None)], "cpu")
        state, ng, ok = _update(state, keys, None, [("count", None)],
                                len(keys))
        assert ok and ng == 2


def test_port_pages_hash_duplicate_and_missing_probe_keys():
    rng = np.random.default_rng(11)
    bk = rng.integers(0, 300, 1024)
    bvalid = rng.random(1024) > 0.1
    pk = rng.integers(0, 600, 2048)
    pvalid = rng.random(2048) > 0.1
    tw, tc, starts, counts, perm, has_null, ok = H.pages_hash_build(
        [(torch.from_numpy(bk), torch.from_numpy(bvalid), T.BIGINT)],
        1000, 2048)
    assert ok and bool(has_null)
    lo, cnt, _live = H.pages_hash_probe(
        (tw, tc, starts, counts),
        [(torch.from_numpy(pk), torch.from_numpy(pvalid), T.BIGINT)], 2048)
    lo, cnt, perm = lo.numpy(), cnt.numpy(), perm.numpy()
    ref = collections.Counter(
        int(k) for k, v in zip(bk[:1000], bvalid[:1000]) if v)
    for i in range(2048):
        want = ref.get(int(pk[i]), 0) if pvalid[i] else 0
        assert cnt[i] == want, i
        for j in range(cnt[i]):
            assert bk[perm[lo[i] + j]] == pk[i]
            if j:                  # build rows of a key in input order
                assert perm[lo[i] + j] > perm[lo[i] + j - 1]


def _journal_case(case):
    """(keys [n, k], live, t_words, t_ctrl) for a journal test: the batch
    and the table it goes into."""
    rng = np.random.default_rng(17)
    if case == "collision_storm":
        keys = rng.integers(0, 700, 2048)[:, None]
        tw, tc = H.empty_table(2048, 1, "cpu")
    elif case == "null_keys":
        # (value, null flag) words as groupby_update keys a nullable column
        vals = rng.integers(0, 64, 4096)
        valid = rng.random(4096) > 0.3
        keys = np.stack([np.where(valid, vals, 0), (~valid).astype(np.int64)],
                        1)
        tw, tc = H.empty_table(1024, 2, "cpu")
    elif case == "rehash_boundary":
        # 400 keys inserted at 1,024 slots, carried into 4,096, then a batch
        # of 400 new keys and 200 of the old ones
        old = np.arange(400, dtype=np.int64)[:, None]
        tw0, tc0 = H.empty_table(1024, 1, "cpu")
        assert B2.insert(torch.from_numpy(old), None, tw0, tc0)[1]
        tw, tc = H.empty_table(4096, 1, "cpu")
        carried = tw0[H.used_slots(tc0)]
        assert B2.insert(carried, None, tw, tc)[1]
        keys = np.concatenate([1000 + np.arange(2048) % 400,
                               np.arange(2048) % 200])[:, None]
    else:                                       # a full table
        keys = np.arange(1000)[:, None]
        tw, tc = H.empty_table(64, 1, "cpu")
    keys = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64))
    live = torch.from_numpy(rng.random(keys.shape[0]) > 0.1)
    return keys, live, tw, tc


@pytest.mark.parametrize("case", ["collision_storm", "null_keys",
                                  "rehash_boundary", "full_table"])
def test_plain_journal_lists_the_slots_that_turned_used(case):
    """The CPU path's journal (the claim loop's winners): one row per slot
    the batch turned from EMPTY to ready, that row's own slot, the first
    row of its key; the count is the number of new keys placed."""
    keys, live, tw, tc = _journal_case(case)
    before = tc.clone()
    slot, ok, n_claimed, journal = B2.insert_claims(keys, live, tw, tc)
    assert ok == (case != "full_table")
    assert journal.dtype == torch.int32 and journal.shape == slot.shape
    turned = torch.nonzero((before == H.EMPTY)
                           & (tc != H.EMPTY)).squeeze(1)
    rows = torch.nonzero(journal >= 0).squeeze(1)
    assert n_claimed == rows.shape[0] == turned.shape[0]
    assert torch.equal(torch.sort(journal[rows].long()).values, turned)
    assert torch.equal(journal[rows], slot[rows])
    # independently of the table: the claiming rows are the first live
    # row of each key that is placed and was not in the table before
    held = {tuple(w) for w in tw[before != H.EMPTY].tolist()}
    first = {}
    for r, (key, lv, s) in enumerate(zip(map(tuple, keys.tolist()),
                                         live.tolist(), slot.tolist())):
        if lv and s != tc.shape[0] and key not in held:
            first.setdefault(key, r)
    assert sorted(first.values()) == rows.tolist()
    # the journal undoes the batch
    tc[journal[journal >= 0].long()] = H.EMPTY
    assert torch.equal(tc, before)


def test_lookup_ranges_plain_equals_the_probe_it_replaced():
    """The fused (lo, cnt) lookup's plain version gives what
    pages_hash_probe computed after its (slot, found) lookup: the hit
    rows' starts/counts at their slot, (0, 0) elsewhere."""
    rng = np.random.default_rng(23)
    bk = rng.integers(-300, 300, 1024)
    pk = rng.integers(-600, 600, 2048)
    pvalid = rng.random(2048) > 0.1
    tw, tc, starts, counts, _perm, _null, ok = H.pages_hash_build(
        [(torch.from_numpy(bk), None, T.BIGINT)], 1000, 2048)
    assert ok
    keys = torch.from_numpy(pk)[:, None].contiguous()
    live = torch.from_numpy(pvalid) & (torch.arange(2048) < 2000)
    slot, found = B2.lookup(keys, live, tw, tc)
    hit = live & found
    s = torch.where(hit, slot.to(torch.int64), 0)
    want_lo = torch.where(hit, starts[s].to(torch.int64), 0)
    want_cnt = torch.where(hit, counts[s].to(torch.int64), 0)
    lo, cnt = B2.lookup_ranges(keys, live, tw, tc, starts, counts)
    assert lo.dtype == cnt.dtype == torch.int64
    assert torch.equal(lo, want_lo) and torch.equal(cnt, want_cnt)
    assert int(cnt.sum()) > 0 and bool((cnt[~hit] == 0).all())
    plo, pcnt, plive = H.pages_hash_probe(
        (tw, tc, starts, counts),
        [(torch.from_numpy(pk), torch.from_numpy(pvalid), T.BIGINT)], 2000)
    assert torch.equal(plive, live)
    assert torch.equal(plo, want_lo) and torch.equal(pcnt, want_cnt)


def test_wrappers_check_their_inputs():
    tw, tc = H.empty_table(64, 1, "cpu")
    keys = torch.zeros((5, 1), dtype=torch.int64)
    with pytest.raises(TypeError):
        B2.insert(keys.to(torch.int32), None, tw, tc)
    with pytest.raises(TypeError):
        B2.insert(keys, None, tw[:, :0].contiguous(), tc)
    with pytest.raises(ValueError, match="power of two"):
        B2.lookup(keys, None, torch.zeros((48, 1), dtype=torch.int64),
                  torch.zeros(48, dtype=torch.int32))
    with pytest.raises(TypeError):
        B2.lookup(keys, torch.ones(4, dtype=torch.bool), tw, tc)
    starts = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(TypeError):
        B2.lookup_ranges(keys, None, tw, tc, starts, starts.long())
    with pytest.raises(TypeError):
        B2.lookup_ranges(keys, None, tw, tc, starts[:32], starts)
    slot, ok = B2.insert(keys, None, tw, tc)
    assert ok and B2.INSERT_LAUNCHES.count == 0   # CPU: the plain loop
    assert len(set(slot.tolist())) == 1
    assert B2.LOOKUP_LAUNCHES.count == 0
    assert B2.lookup_ranges(keys, None, tw, tc, starts, starts)[1].shape == (
        5,)
