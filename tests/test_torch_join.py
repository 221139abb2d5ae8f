"""The port's join kernels (ops/join.py) against the JAX package's on the
same numpy inputs, and its HashBuild + LookupJoin operators on every
LookupSource tier (``single``, ``packed``, ``hash``; the hash tier is
reached on the CPU through ``EngineConfig.force_pages_hash``) against a
nested-loop oracle: inner and left joins, duplicate and null keys.  Ids,
counts and row indices agree exactly; the joined rows exactly, in order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu import types as JT
from presto_tpu.ops import join as JJ
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.config import EngineConfig
from presto_tpu_torch.exec.context import (
    OperatorContext, QueryContext, TaskContext,
)
from presto_tpu_torch.exec.joinop import (
    HashBuildOperatorFactory, LookupJoinOperatorFactory,
)
from presto_tpu_torch.ops import join as PJ


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("typ,dictionary,want", [
    ("bigint", False, True), ("integer", False, True), ("date", False, True),
    ("boolean", False, True), ("double", False, False),
    ("varchar", True, True), ("decimal(12,2)", False, True)])
def test_single_word_joinable_equal_jax(typ, dictionary, want):
    from presto_tpu.types import parse_type as jparse
    from presto_tpu_torch.types import parse_type as pparse

    assert PJ.single_word_joinable(pparse(typ), dictionary) == want
    assert JJ.single_word_joinable(jparse(typ), dictionary) == want


@pytest.mark.parametrize("lo,hi", [(-5, 1000), (-2**62, 2**62 - 1),
                                   (-2**63, 2**63 - 1), (7, 7)])
def test_single_word_span_and_ids_equal_jax(lo, hi):
    rng = np.random.default_rng(abs(lo) % 97)
    n = 500
    b = rng.integers(lo, hi, n, dtype=np.int64, endpoint=True)
    b[:2] = (lo, hi)
    bvalid = rng.random(n) > 0.1
    bvalid[:2] = True
    p = np.concatenate([b[:200], rng.integers(lo, hi, 300, dtype=np.int64,
                                              endpoint=True)])
    pvalid = rng.random(n) > 0.1
    jbig = bool(JJ.single_word_span_too_big(
        (_j(b), _j(bvalid), JT.BIGINT), jnp.asarray(450)))
    pbig = PJ.single_word_span_too_big((_t(b), _t(bvalid), T.BIGINT), 450)
    assert pbig == jbig == (hi - lo >= 2**62)
    if jbig:
        return
    jb, jp = JJ.single_word_ids((_j(b), _j(bvalid), JT.BIGINT),
                                (_j(p), _j(pvalid), JT.BIGINT),
                                jnp.asarray(450), jnp.asarray(480))
    pb, pp = PJ.single_word_ids((_t(b), _t(bvalid), T.BIGINT),
                                (_t(p), _t(pvalid), T.BIGINT), 450, 480)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("span", [300, 1 << 40])   # dense path, search
def test_build_index_probe_counts_expand_equal_jax(span):
    rng = np.random.default_rng(span % 1000)
    cap_b, cap_p = 1024, 2048
    ids = rng.integers(0, span, cap_b).astype(np.int64)
    ids[rng.random(cap_b) < 0.1] = -2          # dead build rows
    probe = np.where(rng.random(cap_p) < 0.5, ids[rng.integers(0, cap_b,
                                                               cap_p)],
                     rng.integers(0, span, cap_p)).astype(np.int64)
    probe[rng.random(cap_p) < 0.1] = -1        # dead probe rows
    jsb, jperm = JJ.build_index(jnp.asarray(ids))
    psb, pperm = PJ.build_index(torch.from_numpy(ids))
    np.testing.assert_array_equal(psb.numpy(), np.asarray(jsb))
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(jperm))
    jlo, jcnt = JJ.probe_counts(jsb, jperm, jnp.asarray(probe))
    plo, pcnt = PJ.probe_counts(psb, pperm, torch.from_numpy(probe))
    np.testing.assert_array_equal(pcnt.numpy(), np.asarray(jcnt))
    hit = np.asarray(jcnt) > 0
    np.testing.assert_array_equal(plo.numpy()[hit], np.asarray(jlo)[hit])
    for inclusive in (False, True):
        np.testing.assert_array_equal(
            PJ._lower_bound(psb, torch.from_numpy(probe), inclusive).numpy(),
            np.asarray(JJ._lower_bound(jsb, jnp.asarray(probe), inclusive)))
    assert PJ._dense_scratch(cap_b, cap_p) == JJ._dense_scratch(cap_b,
                                                                cap_p)
    live = rng.random(cap_p) < 0.95
    for outer in (False, True):
        total = int(np.where(live, np.maximum(np.asarray(jcnt), 1), 0).sum()
                    if outer else np.asarray(jcnt).sum())
        out_cap = total + 5
        if outer:
            j = JJ.expand_matches_outer(jlo, jcnt, jnp.asarray(live), jperm,
                                        out_cap)
            p = PJ.expand_matches_outer(plo, pcnt, torch.from_numpy(live),
                                        pperm, out_cap)
        else:
            j = JJ.expand_matches(jlo, jcnt, jperm, out_cap)
            p = PJ.expand_matches(plo, pcnt, pperm, out_cap)
        assert int(j[4]) == p[4] == total
        for ja, pa in zip(j[:4], p[:4]):
            np.testing.assert_array_equal(pa.numpy()[:total],
                                          np.asarray(ja)[:total])
        np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def _ctx(config, name):
    return OperatorContext(TaskContext(QueryContext(config)), name)


def _batch(cols, n):
    return Batch(tuple(Column(t, _t(v), _t(m)) for t, v, m in cols), n)


def _run_join(config, build_cols, probe_cols, bkeys, pkeys, join_type,
              batch_rows=300):
    """Build from one batch, probe in batches; the joined rows."""
    bf = HashBuildOperatorFactory(bkeys, [t for t, _v, _m in build_cols])
    bop = bf.create(_ctx(config, "build"))
    nb = len(build_cols[0][1])
    bop.add_input(_batch(build_cols, nb))
    bop.finish()
    tier = bf.lookup.get().mode
    jf = LookupJoinOperatorFactory(bf, pkeys,
                                   [t for t, _v, _m in probe_cols],
                                   join_type=join_type)
    jop = jf.create(_ctx(config, "probe"))
    rows = []
    npr = len(probe_cols[0][1])
    for lo in range(0, npr, batch_rows):
        part = [(t, v[lo:lo + batch_rows],
                 None if m is None else m[lo:lo + batch_rows])
                for t, v, m in probe_cols]
        jop.add_input(_batch(part, min(batch_rows, npr - lo)))
        while (out := jop.get_output()) is not None:
            rows.extend(out.to_pylist())
    jop.finish()
    while (out := jop.get_output()) is not None:
        rows.extend(out.to_pylist())
    jop.close()
    return tier, rows


def _oracle(build_rows, probe_rows, bkeys, pkeys, join_type, nbuild_cols):
    out = []
    for pr in probe_rows:
        pk = tuple(pr[c] for c in pkeys)
        matched = False
        if None not in pk:
            for br in build_rows:
                if tuple(br[c] for c in bkeys) == pk:
                    out.append(tuple(pr) + tuple(br))
                    matched = True
        if join_type == "left" and not matched:
            out.append(tuple(pr) + (None,) * nbuild_cols)
    return out


def _rows(cols):
    n = len(cols[0][1])
    return [tuple(None if (m is not None and not m[i]) else
                  (float(v[i]) if t == T.DOUBLE else int(v[i]))
                  for t, v, m in cols) for i in range(n)]


@pytest.mark.parametrize("join_type", ["inner", "left"])
@pytest.mark.parametrize("shape,want_tier", [
    ("one_key", "single"), ("two_keys", "packed"),
    ("one_key_forced", "hash"), ("two_keys_forced", "hash"),
    ("double_key", "hash")])
def test_hash_build_lookup_join_tiers(shape, want_tier, join_type):
    rng = np.random.default_rng(len(shape))
    nb, npr = 400, 1000
    k1 = rng.integers(-50, 150, nb).astype(np.int64)      # duplicates
    k2 = rng.integers(0, 3, nb).astype(np.int64)
    kvalid = rng.random(nb) > 0.1                          # null keys
    payload = rng.uniform(-1, 1, nb)
    p1 = rng.integers(-80, 200, npr).astype(np.int64)
    p2 = rng.integers(0, 4, npr).astype(np.int64)
    pvalid = rng.random(npr) > 0.1
    pay2 = np.arange(npr, dtype=np.int64)
    if shape == "double_key":
        build = [(T.DOUBLE, k1 / 4.0, kvalid), (T.DOUBLE, payload, None)]
        probe = [(T.BIGINT, pay2, None), (T.DOUBLE, p1 / 4.0, pvalid)]
        bkeys, pkeys = [0], [1]
    else:
        build = [(T.BIGINT, k1, kvalid), (T.DOUBLE, payload, None),
                 (T.BIGINT, k2, None)]
        probe = [(T.BIGINT, pay2, None), (T.BIGINT, p1, pvalid),
                 (T.BIGINT, p2, None)]
        two = shape.startswith("two")
        bkeys = [0, 2] if two else [0]
        pkeys = [1, 2] if two else [1]
    config = EngineConfig(force_pages_hash=shape.endswith("forced"))
    tier, got = _run_join(config, build, probe, bkeys, pkeys, join_type)
    assert tier == want_tier
    want = _oracle(_rows(build), _rows(probe), bkeys, pkeys, join_type,
                   len(build))
    assert got == want


def test_empty_build_side():
    build = [(T.BIGINT, np.zeros(0, np.int64), None)]
    probe = [(T.BIGINT, np.arange(10, dtype=np.int64), None)]
    for join_type, want in (("inner", []),
                            ("left", [(i, None) for i in range(10)])):
        tier, got = _run_join(EngineConfig(), build, probe, [0], [0],
                              join_type)
        assert tier == "empty" and got == want


def test_lookup_join_refuses_what_is_not_ported():
    bf = HashBuildOperatorFactory([0], [T.BIGINT])
    with pytest.raises(NotImplementedError, match="ROADMAP A4"):
        LookupJoinOperatorFactory(bf, [0], [T.BIGINT], join_type="semi")

