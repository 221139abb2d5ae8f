"""The port's join kernels (ops/join.py) against the JAX package's on the
same numpy inputs, and its HashBuild + LookupJoin operators on every
LookupSource tier (``single``, ``packed``, ``hash``; the hash tier is
reached on the CPU through ``EngineConfig.force_pages_hash``) against a
nested-loop oracle: inner, left, semi, anti (NOT EXISTS) and null-aware
anti (NOT IN) joins, with and without a residual, duplicate and null keys,
and an empty build.  Ids, counts, masks and row indices agree exactly; the
joined rows exactly, in order.
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
from presto_tpu_torch.exec import joinop
from presto_tpu_torch.exec.joinop import (
    HashBuildOperatorFactory, LookupJoinOperatorFactory,
)
from presto_tpu_torch.expr import build as B
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
              batch_rows=300, **probe_kw):
    """Build from one batch, probe in batches; the joined rows.
    ``probe_kw``: the probe factory's residual and null_aware."""
    bf = HashBuildOperatorFactory(bkeys, [t for t, _v, _m in build_cols])
    bop = bf.create(_ctx(config, "build"))
    nb = len(build_cols[0][1])
    bop.add_input(_batch(build_cols, nb))
    bop.finish()
    tier = bf.lookup.get().mode
    jf = LookupJoinOperatorFactory(bf, pkeys,
                                   [t for t, _v, _m in probe_cols],
                                   join_type=join_type, **probe_kw)
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


def _oracle(build_rows, probe_rows, bkeys, pkeys, join_type, nbuild_cols,
            residual=None):
    """Nested loops over Python rows.  ``join_type`` also names the
    null-aware anti join (NOT IN: an empty build keeps every row, else a
    NULL probe key or any NULL build key drops the row); ``residual``
    (probe row, build row) -> bool filters the semi/anti pairs."""
    build_null = any(None in tuple(br[c] for c in bkeys)
                     for br in build_rows)
    out = []
    for pr in probe_rows:
        pk = tuple(pr[c] for c in pkeys)
        matched = False
        if None not in pk:
            for br in build_rows:
                if tuple(br[c] for c in bkeys) == pk and (
                        residual is None or residual(pr, br)):
                    if join_type in ("inner", "left"):
                        out.append(tuple(pr) + tuple(br))
                    matched = True
        if join_type == "left" and not matched:
            out.append(tuple(pr) + (None,) * nbuild_cols)
        elif join_type == "semi" and matched:
            out.append(tuple(pr))
        elif join_type == "anti" and not matched:
            out.append(tuple(pr))
        elif join_type == "anti_null_aware" and (
                not build_rows
                or (not matched and None not in pk and not build_null)):
            out.append(tuple(pr))
    return out


def _rows(cols):
    n = len(cols[0][1])
    return [tuple(None if (m is not None and not m[i]) else
                  (float(v[i]) if t == T.DOUBLE else int(v[i]))
                  for t, v, m in cols) for i in range(n)]


TIER_SHAPES = [
    ("one_key", "single"), ("two_keys", "packed"),
    ("one_key_forced", "hash"), ("two_keys_forced", "hash"),
    ("double_key", "hash")]


def _tier_inputs(shape):
    """Build and probe columns with duplicate and null keys: build
    [key, payload double, key2], probe [row number, key, key2] (a double
    key: build [key, payload], probe [row number, key])."""
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
    return build, probe, bkeys, pkeys


def _probe_kw(join_type):
    if join_type == "anti_null_aware":
        return "anti", {"null_aware": True}
    return join_type, {}


@pytest.mark.parametrize("join_type", ["inner", "left", "semi", "anti",
                                       "anti_null_aware"])
@pytest.mark.parametrize("shape,want_tier", TIER_SHAPES)
def test_hash_build_lookup_join_tiers(shape, want_tier, join_type):
    build, probe, bkeys, pkeys = _tier_inputs(shape)
    config = EngineConfig(force_pages_hash=shape.endswith("forced"))
    jt, kw = _probe_kw(join_type)
    tier, got = _run_join(config, build, probe, bkeys, pkeys, jt, **kw)
    assert tier == want_tier
    want = _oracle(_rows(build), _rows(probe), bkeys, pkeys, join_type,
                   len(build))
    assert got == want
    if join_type == "anti_null_aware":
        # the build keys hold NULLs: NOT IN keeps no row; without them it
        # keeps the unmatched rows with non-null keys
        assert got == []
        kvalid = build[0][2]
        live = [(t, v[kvalid], None if m is None else m[kvalid])
                for t, v, m in build]
        _tier, got = _run_join(config, live, probe, bkeys, pkeys, jt, **kw)
        want = _oracle(_rows(live), _rows(probe), bkeys, pkeys, join_type,
                       len(live))
        assert got == want and len(want) > 0


# residual over [probe..., build...]: build payload > probe row / 1000 - 0.5
def _residual(nprobe):
    return B.comparison(">", B.ref(nprobe + 1, T.DOUBLE), B.call(
        "subtract", B.call("divide", B.cast(B.ref(0, T.BIGINT), T.DOUBLE),
                           B.const(1000.0, T.DOUBLE)),
        B.const(0.5, T.DOUBLE)))


@pytest.mark.parametrize("max_pairs", [1 << 22, 16])   # one chunk, many
@pytest.mark.parametrize("join_type", ["semi", "anti"])
@pytest.mark.parametrize("shape,want_tier", TIER_SHAPES)
def test_residual_semi_anti_join(shape, want_tier, join_type, max_pairs,
                                 monkeypatch):
    """A correlated EXISTS / NOT EXISTS: the candidate pairs expanded (in
    chunks of probe rows when they outnumber ``max_pairs``), the residual
    evaluated over both sides, any passing pair keeps (semi) or drops
    (anti) its probe row; NOT EXISTS keeps null-key rows."""
    monkeypatch.setattr(joinop, "RESIDUAL_CHUNK_PAIRS", max_pairs)
    build, probe, bkeys, pkeys = _tier_inputs(shape)
    config = EngineConfig(force_pages_hash=shape.endswith("forced"))
    tier, got = _run_join(config, build, probe, bkeys, pkeys, join_type,
                          residual=_residual(len(probe)))
    assert tier == want_tier
    want = _oracle(_rows(build), _rows(probe), bkeys, pkeys, join_type,
                   len(build),
                   residual=lambda pr, br: br[1] > pr[0] / 1000.0 - 0.5)
    assert got == want
    plain = _oracle(_rows(build), _rows(probe), bkeys, pkeys, join_type,
                    len(build))
    assert got != plain       # the residual decided some rows


def test_empty_build_side():
    build = [(T.BIGINT, np.zeros(0, np.int64), None)]
    pvalid = np.arange(10) % 3 != 0                  # null probe keys
    probe = [(T.BIGINT, np.arange(10, dtype=np.int64), pvalid)]
    keys = [i if ok else None for i, ok in enumerate(pvalid)]
    everyone = [(k,) for k in keys]
    for join_type, want in (("inner", []),
                            ("left", [(k, None) for k in keys]),
                            ("semi", []), ("anti", everyone),
                            ("anti_null_aware", everyone)):
        jt, kw = _probe_kw(join_type)
        tier, got = _run_join(EngineConfig(), build, probe, [0], [0], jt,
                              **kw)
        assert tier == "empty" and got == want
        if jt in ("semi", "anti"):
            _tier, got = _run_join(EngineConfig(), build, probe, [0], [0],
                                   jt, residual=_residual(1), **kw)
            assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_semi_anti_masks_equal_jax(seed):
    rng = np.random.default_rng(seed)
    cap, cap_b = 257, 64
    counts = rng.integers(0, 3, cap).astype(np.int64)
    live = rng.random(cap) < 0.8
    in_row = np.arange(cap) < 250
    pvalids = [rng.random(cap) < 0.9, None]
    bvalid = rng.random(cap_b) < (0.97 if seed % 2 else 1.0)
    b_in_row = np.arange(cap_b) < 60
    np.testing.assert_array_equal(
        PJ.semi_mask(_t(counts), _t(live)).numpy(),
        np.asarray(JJ.semi_mask(_j(counts), _j(live), False)))
    # the build's flag as every build tier records it: a live row with a
    # NULL key
    has_null = torch.tensor(bool((b_in_row & ~bvalid).any()))
    for null_aware in (False, True):
        for n_build in (0, 60):
            want = np.asarray(JJ.anti_keep_from_parts(
                _j(counts), _j(live), _j(in_row), null_aware,
                [_j(v) for v in pvalids], jnp.int64(n_build),
                build_key_valids=[_j(bvalid)], build_in_row=_j(b_in_row)))
            got = PJ.anti_keep_from_parts(
                _t(counts), _t(live), _t(in_row), null_aware,
                [_t(v) for v in pvalids], n_build, has_null)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("join_type", ["inner", "semi"])
def test_probe_on_another_device_raises(join_type):
    """The build and the probe both lie on the query's device; a probe
    batch elsewhere raises rather than being copied to the build."""
    bf = HashBuildOperatorFactory([0], [T.BIGINT])
    bop = bf.create(_ctx(EngineConfig(), "build"))
    bop.add_input(_batch([(T.BIGINT, np.arange(4, dtype=np.int64), None)],
                         4))
    bop.finish()
    jop = LookupJoinOperatorFactory(bf, [0], [T.BIGINT],
                                    join_type=join_type).create(
        _ctx(EngineConfig(), "probe"))
    meta = Batch((Column(T.BIGINT, torch.empty(4, dtype=torch.int64,
                                               device="meta")),), 4)
    with pytest.raises(ValueError, match="meet a build"):
        jop.add_input(meta)


def test_lookup_join_refuses_what_is_not_ported():
    """Keys with no integer id and PagesHash switched off need the
    canonical tier (a union sort of both sides), not in the port yet."""
    bf = HashBuildOperatorFactory([0], [T.DOUBLE])
    bop = bf.create(_ctx(EngineConfig(device_join_probe=False), "build"))
    bop.add_input(_batch([(T.DOUBLE, np.arange(4.0), None)], 4))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        bop.finish()

