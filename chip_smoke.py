"""Smoke run of presto_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--scale 1.0] [--seed 0]

Phases (any failure exits non-zero; nothing is caught):

1. device and build: the card's name and power limit, then every kernel
   of ``presto_tpu_torch/csrc`` built with nvcc for sm_90a (one nvcc per
   source, in parallel), with the build seconds and ptxas report;
2. kernel against plain: each kernel's wrapper on tensors on the card at
   the shapes the main path gives it, held against its plain PyTorch
   version and against itself on a repeat, with CUDA-event times of the
   kernel, the plain version and one PyTorch library call, and the least
   time the card could take (``bound_ms``):
   - B1 (segment sums): within 1e-12 relative of the plain version, and
     bit-identical on a repeat;
   - B2 (probe-insert and lookup): the same group partition as the plain
     claim loop (same key -> same slot, distinct keys -> distinct slots),
     the same found flags, the same ``ok`` and as many claimed slots, on
     every repeat (slot ids may differ: atomics decide who wins a
     contended slot); the insert's journal is the slots it filled and
     undoes the batch; the fused lookup's (lo, cnt) equal their plain
     version.  Eight shapes: Q3's join build and probe, a GroupByHash
     batch into a small and a large table, a collision storm, a full
     table, SF10 partkey's last rung (2^22 slots, above the L2) and a
     GROUP BY batch with Q3's shape, the batch sizes and table loads
     taken from phase 3's ``b2_rows``.  B2's times, the lookup's of the
     (lo, cnt) mode the PagesHash probe runs: ``kernel_ms``, the
     device time of one launch from a CUDA graph of launches, and
     ``wrapper_ms``, the wrapper's call as the tiers make it (CUDA events
     around it, host included), with ``library_device_ms`` beside
     ``library_ms`` where the library call can be captured;
   - the float group sums of the direct (above B1's 32 groups), sort and
     hash tiers: bit-identical on a repeat;
3. SQL on the card, through ``presto_tpu_torch.localrunner.
   LocalQueryRunner`` on ``cuda`` at ``--scale``, rows held against a numpy
   oracle over the same generator columns (1e-9 relative for doubles,
   exact for keys, counts and row order), with the cold and warm wall
   seconds; each path runs with the launch counts set to 0 just before it
   and read just after:
   - TPC-H Q1 (B1 launched) and Q6;
   - TPC-H Q3 (B2 launched in insert mode when a join build or the GROUP
     BY took a hash tier, and in lookup mode exactly when a join build
     took PagesHash, as Q3's customer build does up to SF4; the GROUP BY
     on the hash tier from SF10) and the hash-tier GROUP BY ``l_partkey``
     (B2 launched in insert mode); for both, the join and aggregation
     inputs on cuda and every run gives the same bits.  Each path's
     counts are printed on their own (``b2_launches``); the kernels
     line's ``launches`` is Q3's (Q1's for B1), with every path's count
     beside it under ``launches_by_path``.  One more run of each, which
     no wall reads, records the rows of its B2 launches (``b2_rows``:
     mean, min and max of batch and live rows, and the table sizes).

Phase 2 calls the wrappers the hash tiers call (``B2.insert_claims``,
``B2.lookup``, ``B2.lookup_ranges``) for its checks.

The last lines are the kernels line ``{"kernels": [...]}``, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import time

# H100 SXM data sheet rates (the card's memory rate, float64 rate, and
# the float32 rate outside the tensor cores, taken for 32-bit integer ops)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT_OPS_PER_S = 67e12
L2_BYTES = 50e6
SECTOR = 32

# Q3's GROUP BY batch at SF10 as phase 3 of `python3 chip_smoke.py
# --scale 10` saw it (b2_rows, the q3 path's 933 insert launches): rows per
# batch and live rows (the mean; 36 to 65,601, every row live), and the
# table's slots (the most common).  The aggregation rehashes past half
# fill, so a 262,144-slot table holds 65,537 to 131,072 groups: the batch
# meets it at the middle of that range
Q3_GROUPBY_ROWS = 456
Q3_GROUPBY_LIVE = 456
Q3_GROUPBY_CAP = 262_144
Q3_GROUPBY_HELD = 98_304
# Q3's PagesHash probe at SF1 (b2_rows of `python3 chip_smoke.py`, the q3
# path's 32 lookups): o_custkey rows per batch, the mean (13,542 to 32,052)
Q3_PROBE_ROWS = 22_791

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07 and l_quantity < 24
"""


Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

# the inner aggregate of TPC-H Q17 and Q20: 200,000 groups per SF
PARTKEY = """
select l_partkey, sum(l_quantity), count(*) from lineitem
group by l_partkey
"""


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_ms_each(setup, fn, iters: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` runs, each after an
    untimed ``setup`` (a fresh table for an insert)."""
    import torch

    for _ in range(warmup):
        setup()
        fn()
    total = 0.0
    for _ in range(iters):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / iters


def graph_ms(step, iters: int, reset=None, replays: int = 3) -> float:
    """Device time of one ``step``: ``iters`` steps, each after ``reset``,
    captured in one CUDA graph and replayed between two CUDA events, less
    the same graph of the resets alone.  No host work between launches
    reaches the number (``cuda_ms`` and ``cuda_ms_each`` time the calls,
    host included)."""
    import torch

    def capture(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()               # lazy set-up and the allocator, uncaptured
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                body()
        return graph

    def replay_ms(graph) -> float:
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (replays * iters)

    if reset is None:
        return replay_ms(capture(step))

    def both():
        reset()
        step()
    return replay_ms(capture(both)) - replay_ms(capture(reset))


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_segment_sums(n: int, g: int, a: int, seed: int) -> dict:
    """B1 at one shape: kernel vs plain (<= 1e-12 relative), repeat
    bit-identity, and times."""
    import torch

    from presto_tpu_torch.ops import segment_sums as S

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.randint(0, g, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.rand((n, a), generator=gen, device="cuda",
                      dtype=torch.float64) * 1e5
    got = S.direct_segment_sums(gid, vals, g)
    again = S.direct_segment_sums(gid, vals, g)
    want = S.direct_segment_sums_reference(gid, vals, g)
    torch.cuda.synchronize()
    abs_err = float((got - want).abs().max())
    rel_err = float(((got - want).abs()
                     / want.abs().clamp(min=1.0)).max())
    if rel_err > 1e-12:
        raise AssertionError(f"segment_sums n={n} g={g} a={a}: relative "
                             f"error {rel_err} > 1e-12")
    if not torch.equal(got, again):
        raise AssertionError(f"segment_sums n={n} g={g} a={a}: two runs "
                             "differ")
    iters = 20 if n > 100_000 else 200
    gid64 = gid.long()
    ms = cuda_ms(lambda: S._launch(gid, vals, g), iters)
    plain_ms = cuda_ms(
        lambda: S.direct_segment_sums_reference(gid, vals, g), iters)
    library_ms = cuda_ms(
        lambda: torch.zeros((g, a), dtype=torch.float64,
                            device="cuda").index_add_(0, gid64, vals),
        iters)
    nbytes = n * (4 + 8 * a) + g * a * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * a / FP64_OPS_PER_S * 1e3
    return {"n": n, "g": g, "a": a, "max_abs_err": abs_err,
            "max_rel_err": rel_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _hash_ops(n: int, k: int) -> float:
    """Integer operations of the row hash: two multiply-xor-shift rounds
    per key word, a 64-bit multiply counted as four 32-bit ones."""
    return n * k * 2 * (4 + 3)


def _check_partition(keys, slot, placed, cap: int, label: str) -> int:
    """Rows in ``placed``: same key -> same slot, distinct keys ->
    distinct slots, every slot in [0, cap).  Returns the key count."""
    import torch

    s = slot[placed].long()
    if s.numel() and (int(s.min()) < 0 or int(s.max()) >= cap):
        raise AssertionError(f"{label}: slot outside [0, {cap})")
    uniq, inv = torch.unique(keys[placed], dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), -1, dtype=torch.int64,
                       device=keys.device).scatter_(0, inv, s)
    if not torch.equal(first[inv], s):
        raise AssertionError(f"{label}: one key got two slots")
    if torch.unique(s).numel() != uniq.shape[0]:
        raise AssertionError(f"{label}: two keys share a slot")
    return int(uniq.shape[0])


def b2_shapes(seed: int):
    """B2's phase-2 shapes: the main path's at SF1 (Q3's join build and
    probe, a GroupByHash batch into the first and a late rung of SF1
    partkey's ladder), the hard cases (a collision storm, a full table),
    SF10 partkey's last rung above the L2 and a GROUP BY batch with Q3's
    shape.  Each is a dict: ``label``, ``mode`` (insert or lookup), the
    int64 ``keys`` ``[n, k]``, ``live`` (None: every row), ``cap``, and
    ``prefill`` (keys in the table before the batch, or None); a lookup
    also has ``build``, the keys of its table."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int64)

    def zeros(n):
        return torch.zeros(n, dtype=torch.int64, device="cuda")

    # Q3's PagesHash build at SF1: ~30k distinct BIGINT customer keys
    # (c_custkey of the BUILDING segment) into 2 x its 32,768-row
    # capacity, probed by a batch of o_custkey of the path's mean size
    cust = torch.randperm(150_000, generator=gen, device="cuda")[:30_000]
    build = (cust + 1).to(torch.int64)[:, None].contiguous()
    probe = randint(1, 150_001, (Q3_PROBE_ROWS, 1))
    # a GroupByHash batch: 65,536 rows of (l_partkey, null flag) words
    part = torch.stack([randint(1, 200_001, (65_536,)), zeros(65_536)], 1)
    # the collision storm of tests/test_pallas.py: 2,048 rows, 700 keys
    storm = randint(0, 700, (2_048, 1))
    live_storm = torch.ones(2_048, dtype=torch.bool, device="cuda")
    # a full table: 1,000 distinct keys, 64 slots
    full = torch.arange(1_000, dtype=torch.int64, device="cuda")[:, None]
    # SF10 partkey's last rung (2^22 slots, 84 MB: above the L2): the
    # table holds 2,000,000 distinct keys (load 0.48) and a 65,536-row
    # batch draws from a domain 5 % larger, so most rows find their key
    # and some claim a slot
    domain = 2_100_000
    held = torch.randperm(domain, generator=gen, device="cuda")[:2_000_000]
    big_fill = torch.stack([held.to(torch.int64) + 1, zeros(2_000_000)], 1)
    big = torch.stack([randint(1, domain + 1, (65_536,)), zeros(65_536)], 1)
    # Q3's GROUP BY batch at SF10 (l_orderkey, o_orderdate,
    # o_shippriority), each key with its null-flag word as groupby_update
    # keys it: Q3_GROUPBY_LIVE live rows of a Q3_GROUPBY_ROWS-row batch,
    # lineitem's order, so about 4 consecutive rows share an l_orderkey,
    # into a table holding the Q3_GROUPBY_HELD groups of earlier batches
    # (lower order keys)
    def q3_keys(okey):
        out = zeros((okey.shape[0], 6))
        out[:, 0] = okey
        out[:, 2] = 8_036 + okey * 2_654_435_761 % 2_406  # 1992-01-01 + ...
        return out

    n_ord = -(-Q3_GROUPBY_LIVE // 4)
    okey = torch.sort(randint(30_000_001, 60_000_001, (n_ord,))).values
    q3k = zeros((Q3_GROUPBY_ROWS, 6))
    q3k[:Q3_GROUPBY_LIVE] = q3_keys(
        okey.repeat_interleave(4)[:Q3_GROUPBY_LIVE])
    q3_live = torch.arange(Q3_GROUPBY_ROWS, device="cuda") < Q3_GROUPBY_LIVE
    q3_held = torch.randperm(30_000_000, generator=gen,
                             device="cuda")[:Q3_GROUPBY_HELD] + 1
    q3_fill = q3_keys(q3_held.to(torch.int64))
    return [
        dict(label="q3_join_build", mode="insert", keys=build, live=None,
             cap=65_536, prefill=None),
        dict(label="groupby_batch_8192", mode="insert", keys=part,
             live=None, cap=8_192, prefill=None),
        dict(label="groupby_batch_524288", mode="insert", keys=part,
             live=None, cap=524_288, prefill=None),
        dict(label="collision_storm", mode="insert", keys=storm,
             live=live_storm, cap=2_048, prefill=None),
        dict(label="full_table", mode="insert", keys=full, live=None,
             cap=64, prefill=None),
        dict(label="groupby_batch_4194304", mode="insert", keys=big,
             live=None, cap=1 << 22, prefill=big_fill),
        dict(label="q3_groupby_batch", mode="insert", keys=q3k,
             live=q3_live, cap=Q3_GROUPBY_CAP, prefill=q3_fill),
        dict(label="q3_join_probe", mode="lookup", keys=probe, live=None,
             cap=65_536, build=build),
    ]


def b2_table(shape):
    """The table a shape's batch goes into: empty, or holding its
    ``prefill`` (inserted by the kernel).  Returns (t_words, t_ctrl)."""
    from presto_tpu_torch.ops import hashtable as H
    from presto_tpu_torch.ops import probe_insert as B2

    keys = shape["build"] if shape["mode"] == "lookup" else shape["prefill"]
    tw, tc = H.empty_table(shape["cap"], shape["keys"].shape[1], "cuda")
    if keys is not None:
        _slot, ok = B2.insert(keys, None, tw, tc)
        if not ok:
            raise AssertionError(f"{shape['label']}: the table's keys did "
                                 "not fit")
    return tw, tc


def l2_flush():
    """A step that evicts the 50 MB L2 (writes 128 MB)."""
    import torch

    junk = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    return junk.zero_


def b2_reset(shape, tw, tc):
    """A step that puts (tw, tc) back as ``b2_table`` left them, and
    flushes the L2 when the table is larger than it (the caller meets
    such a table cold: its previous batch touched a few MB of it)."""
    if shape["prefill"] is None:
        steps = [tw.zero_, tc.zero_]
    else:
        tw0, tc0 = tw.clone(), tc.clone()
        steps = [lambda: tw.copy_(tw0), lambda: tc.copy_(tc0)]
    if tc.shape[0] * (4 + 8 * tw.shape[1]) > L2_BYTES:
        steps.append(l2_flush())

    def reset():
        for step in steps:
            step()
    return reset


def check_probe_insert(shape, iters: int = 20) -> dict:
    """B2 insert at one shape, through the wrapper the hash tiers call
    (``B2.insert_claims``: its input checks and its one read of the
    status word), twice from the same table: the partition, ``ok``, the
    claimed slots against the plain claim loop's, and the journal undoes
    the batch.  Then the times: ``kernel_ms`` (device time of one launch,
    from a CUDA graph), ``wrapper_ms`` (the wrapper's call, CUDA events),
    the claim loop and ``torch.unique``."""
    import torch

    from presto_tpu_torch.ops import hashtable as H
    from presto_tpu_torch.ops import probe_insert as B2

    label, keys, live, cap = (shape["label"], shape["keys"], shape["live"],
                              shape["cap"])
    n, k = keys.shape
    tw, tc = b2_table(shape)
    tw0, tc0 = tw.clone(), tc.clone()
    live_all = (torch.ones(n, dtype=torch.bool, device="cuda")
                if live is None else live)
    oks = []
    for _ in range(2):
        tw.copy_(tw0)
        tc.copy_(tc0)
        slot, ok, n_claimed, journal = B2.insert_claims(keys, live, tw,
                                                        tc)
        claimed = journal[journal >= 0]
        if claimed.shape[0] != n_claimed:
            raise AssertionError(f"{label}: {n_claimed} claimed, "
                                 f"{claimed.shape[0]} in the journal")
        if bool((slot[~live_all] != cap).any()):
            raise AssertionError(f"{label}: a dead row got a slot")
        placed = live_all & (slot != cap)
        if ok and not bool(placed.eq(live_all).all()):
            raise AssertionError(f"{label}: ok but a live row unplaced")
        _check_partition(keys, slot, placed, cap, label)
        if not torch.equal(tw[slot[placed].long()], keys[placed]):
            raise AssertionError(f"{label}: a row's slot holds another key")
        new = torch.nonzero((tc0 == H.EMPTY) & (tc != H.EMPTY)).squeeze(1)
        if not torch.equal(torch.sort(claimed.long()).values, new):
            raise AssertionError(f"{label}: the journal is not the slots "
                                 "the batch filled")
        tc[claimed.long()] = H.EMPTY
        if not torch.equal(tc, tc0):
            raise AssertionError(f"{label}: the journal did not undo the "
                                 "batch")
        oks.append(ok)
    pw, pc = tw0.clone(), tc0.clone()
    pslot, pok = H.probe_insert(keys, live_all, pw, pc)
    if pok:
        _check_partition(keys, pslot, live_all, cap, label + " plain")
        plain_new = int(((tc0 == H.EMPTY) & (pc != H.EMPTY)).sum())
        if plain_new != claimed.shape[0]:
            raise AssertionError(f"{label}: {claimed.shape[0]} keys claimed "
                                 f"(kernel) != {plain_new} (plain)")
    if oks != [pok, pok]:
        raise AssertionError(f"{label}: ok {oks} (kernel) != {pok} (plain)")
    groups = int(claimed.shape[0])

    tw.copy_(tw0)
    pw.copy_(tw0)
    pc.copy_(tc0)
    reset = b2_reset(shape, tw, tc)
    kernel_ms = graph_ms(lambda: B2.launch_insert(keys, live, tw, tc),
                         iters, reset)
    wrapper_ms = cuda_ms_each(
        reset, lambda: B2.insert_claims(keys, live, tw, tc), iters)
    plain_ms = cuda_ms_each(
        b2_reset(shape, pw, pc), lambda: H.probe_insert(keys, live_all, pw,
                                                        pc),
        max(2, iters // 10), warmup=1)
    lk = keys[live_all]
    library_ms = cuda_ms(
        lambda: torch.unique(lk if k > 1 else lk[:, 0], dim=0 if k > 1
                             else None, return_inverse=True), iters)
    n_live = int(live_all.sum())
    table_bytes = cap * (4 + 8 * k)
    nbytes = (n * (8 * k + 4 + (0 if live is None else 1))
              + min(table_bytes, n_live * 2 * SECTOR)
              + groups * (4 + 8 * k))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = _hash_ops(n_live, k) / INT_OPS_PER_S * 1e3
    return {"shape": label, "n": n, "k": k, "cap": cap, "live": n_live,
            "prefilled": 0 if shape["prefill"] is None
            else int(shape["prefill"].shape[0]),
            "groups": groups, "ok": pok, "max_abs_err": 0.0,
            "ms": kernel_ms, "kernel_ms": kernel_ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": None,
            "library": "torch.unique(return_inverse=True)",
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def check_probe_lookup(shape, iters: int = 20) -> dict:
    """B2 lookup at one shape: the kernel's found flags and slots (through
    ``B2.lookup``, a check of the partition only) against the plain walk
    over the same table and against the true membership, twice, and the
    ranges (through ``B2.lookup_ranges``, the one mode the PagesHash probe
    calls) equal to their plain version.  Times, all of the ranges mode:
    ``kernel_ms`` (one (lo, cnt) launch, from a CUDA graph), ``wrapper_ms``
    (the ``lookup_ranges`` call, CUDA events), the plain version, and
    ``torch.searchsorted`` by events and from a graph."""
    import torch

    from presto_tpu_torch.ops import hashtable as H
    from presto_tpu_torch.ops import probe_insert as B2

    label, probe, build, cap = (shape["label"], shape["keys"],
                                shape["build"], shape["cap"])
    n, k = probe.shape
    tw, tc = b2_table(shape)
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    slot, found = B2.lookup(probe, live, tw, tc)
    slot2, found2 = B2.lookup(probe, live, tw, tc)
    pslot, pfound = H.probe_find(probe, live, tw, tc)
    torch.cuda.synchronize()
    truth = torch.isin(probe[:, 0], build[:, 0]) if k == 1 else None
    if not (torch.equal(found, pfound) and torch.equal(found, found2)):
        raise AssertionError(f"{label}: found flags differ from plain")
    if truth is not None and not torch.equal(found, truth):
        raise AssertionError(f"{label}: found flags differ from membership")
    if not (torch.equal(slot[found], pslot[found])
            and torch.equal(slot, slot2)):
        raise AssertionError(f"{label}: found slots differ from plain")
    # PagesHash ranges over the table: 1 to 4 build rows per key
    gen = torch.Generator(device="cuda").manual_seed(cap)
    counts = torch.where(
        tc != H.EMPTY, torch.randint(1, 5, (cap,), generator=gen,
                                     device="cuda", dtype=torch.int32), 0)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    got = B2.lookup_ranges(probe, live, tw, tc, starts, counts)
    want = B2.lookup_ranges_reference(probe, live, tw, tc, starts, counts)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: fused ranges differ from plain")
    kernel_ms = graph_ms(lambda: B2.launch_lookup(probe, live, tw, tc,
                                                  starts, counts), iters)
    wrapper_ms = cuda_ms(
        lambda: B2.lookup_ranges(probe, live, tw, tc, starts, counts), iters)
    plain_ms = cuda_ms(
        lambda: B2.lookup_ranges_reference(probe, live, tw, tc, starts,
                                           counts), max(2, iters // 10),
        warmup=1)
    sorted_build = torch.sort(build[:, 0]).values
    keys0 = probe[:, 0].contiguous()
    library_ms = cuda_ms(lambda: torch.searchsorted(sorted_build, keys0),
                         iters)
    library_device_ms = graph_ms(
        lambda: torch.searchsorted(sorted_build, keys0), iters)
    # keys and live in, (lo, cnt) out, the starts and counts of the slots
    # the found rows gather, and the table's sectors
    table_bytes = cap * (4 + 8 * k)
    gathered = int(torch.unique(slot[found]).numel())
    nbytes = (n * (8 * k + 1 + 16) + gathered * 8
              + min(table_bytes, n * 2 * SECTOR))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = _hash_ops(n, k) / INT_OPS_PER_S * 1e3
    return {"shape": label, "n": n, "k": k, "cap": cap,
            "build": int(build.shape[0]), "found": int(found.sum()),
            "max_abs_err": 0.0, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "library": "torch.searchsorted(sorted build keys)",
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def b2_checks(seed: int):
    """B2 at every phase-2 shape: (insert rows, lookup rows)."""
    inserts, lookups = [], []
    for shape in b2_shapes(seed):
        if shape["mode"] == "insert":
            inserts.append(check_probe_insert(shape))
        else:
            lookups.append(check_probe_lookup(shape))
    if [c["ok"] for c in inserts] != [True, False, True, True, False, True,
                                      True]:
        raise AssertionError(f"B2 ok flags {[c['ok'] for c in inserts]}")
    return inserts, lookups


def c2_checks(seed: int):
    """The float group sums of the direct (above 32 groups), sort and hash
    tiers: the same bits on a repeat, and within 1e-9 relative of a
    float64 ``index_add_``."""
    import torch

    from presto_tpu_torch import types as T
    from presto_tpu_torch.ops import groupby as G
    from presto_tpu_torch.ops import hashtable as H

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 1 << 21
    keys = torch.randint(0, 100_000, (n,), generator=gen, device="cuda",
                         dtype=torch.int64)
    vals = torch.rand(n, generator=gen, device="cuda",
                      dtype=torch.float64) * 1e5
    codes = (keys % 64).to(torch.int32)

    def direct():
        _present, res = G.direct_grouped_aggregate(
            [(codes, None)], [64], [("sum", vals, None)], n)
        return res[0][0], torch.arange(64, device="cuda")

    def sort():
        gi, _ng, res = G.grouped_aggregate(
            [(keys, None, T.BIGINT)], [("sum", vals, None)], n)
        return res[0][0], keys[gi]

    def hashed():
        state = H.groupby_init(1 << 18, 2, [torch.int64], [True],
                               [("sum", torch.float64)], "cuda")
        for lo in range(0, n, 1 << 16):       # batch by batch
            kc = [(keys[lo:lo + (1 << 16)], None, T.BIGINT)]
            ai = [("sum", vals[lo:lo + (1 << 16)], None)]
            state, _ng, ok = H.groupby_update(state, kc, ai, 1 << 16)
            if not ok:
                raise AssertionError("hash tier: the table did not fit")
        _n, key_outs, agg_outs = H.groupby_extract(state)
        order = torch.argsort(key_outs[0][0])
        return agg_outs[0][0][order], key_outs[0][0][order]

    out = {}
    for name, fn, ids in (("direct", direct, codes.long()),
                          ("sort", sort, keys), ("hash", hashed, keys)):
        a, ka = fn()
        b, kb = fn()
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(ka, kb)):
            raise AssertionError(f"C2 {name} tier: two runs differ")
        want = torch.zeros(int(ids.max()) + 1, dtype=torch.float64,
                           device="cuda").index_add_(0, ids, vals)[ka]
        rel = float(((a - want).abs() / want.abs().clamp(min=1.0)).max())
        if rel > 1e-9:
            raise AssertionError(f"C2 {name} tier: relative error {rel}")
        out[name] = {"groups": int(a.shape[0]), "max_rel_err": rel,
                     "bit_identical": True}
    return out


# --------------------------------------------------------------------------
# phase 3: SQL on the card against a numpy oracle
# --------------------------------------------------------------------------

def table_columns(scale: float, table: str, names):
    """The generator's columns of ``table`` as host numpy arrays (codes
    decoded to strings for dictionary columns)."""
    import numpy as np

    from presto_tpu_torch.batch import concat_batches
    from presto_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(scale=scale)
    handle = conn.get_table(table)
    batches = []
    for split in conn.get_splits(handle, 1):
        batches.extend(conn.page_source(split, names, 1 << 24))
    b = concat_batches(batches) if len(batches) > 1 else batches[0]
    out = {}
    for name, c in zip(names, b.columns):
        v = np.asarray(c.values)[:b.num_rows]
        if c.dictionary is not None:
            v = np.asarray(c.dictionary.values, dtype=object)[v]
        out[name] = v
    return out


def lineitem_columns(scale: float, names):
    return table_columns(scale, "lineitem", names)


def oracle_q1(cols):
    import numpy as np

    sel = cols["l_shipdate"] <= _days(1998, 12, 1) - 90
    rf, ls = cols["l_returnflag"][sel], cols["l_linestatus"][sel]
    qty, price = cols["l_quantity"][sel], cols["l_extendedprice"][sel]
    disc, tax = cols["l_discount"][sel], cols["l_tax"][sel]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    keys = sorted(set(zip(rf, ls)))
    rows = []
    for k in keys:
        m = (rf == k[0]) & (ls == k[1])
        cnt = int(m.sum())
        rows.append((k[0], k[1], qty[m].sum(), price[m].sum(),
                     disc_price[m].sum(), charge[m].sum(),
                     qty[m].sum() / cnt, price[m].sum() / cnt,
                     disc[m].sum() / cnt, cnt))
    return [tuple(float(x) if isinstance(x, np.floating) else x
                  for x in r) for r in rows]


def oracle_q6(cols):
    sd, disc = cols["l_shipdate"], cols["l_discount"]
    sel = ((sd >= _days(1994, 1, 1)) & (sd < _days(1995, 1, 1))
           & (disc >= 0.05) & (disc <= 0.07) & (cols["l_quantity"] < 24))
    return [(float((cols["l_extendedprice"][sel] * disc[sel]).sum()),)]


def oracle_q3(scale: float, li):
    """TPC-H Q3 over the generator's columns: numpy joins by sorted key
    search, the group sums by ``np.add.at``, the order and the limit."""
    import numpy as np

    cut = _days(1995, 3, 15)
    cu = table_columns(scale, "customer", ["c_custkey", "c_mktsegment"])
    od = table_columns(scale, "orders", ["o_orderkey", "o_custkey",
                                         "o_orderdate", "o_shippriority"])
    cust = np.sort(cu["c_custkey"][cu["c_mktsegment"] == "BUILDING"])
    osel = (od["o_orderdate"] < cut) & np.isin(od["o_custkey"], cust)
    okey = od["o_orderkey"][osel]
    order = np.argsort(okey)
    okey = okey[order]
    odate = od["o_orderdate"][osel][order]
    oprio = od["o_shippriority"][osel][order]
    lsel = li["l_shipdate"] > cut
    lkey = li["l_orderkey"][lsel]
    pos = np.clip(np.searchsorted(okey, lkey), 0, max(len(okey) - 1, 0))
    hit = (okey[pos] == lkey) if len(okey) else np.zeros(len(lkey), bool)
    rev = (li["l_extendedprice"][lsel] * (1.0 - li["l_discount"][lsel]))[hit]
    gpos = pos[hit]
    sums = np.zeros(len(okey))
    np.add.at(sums, gpos, rev)
    present = np.zeros(len(okey), bool)
    present[gpos] = True
    idx = np.nonzero(present)[0]
    idx = idx[np.lexsort((odate[idx], -sums[idx]))][:10]
    epoch = datetime.date(1970, 1, 1)
    return [(int(okey[i]), float(sums[i]),
             epoch + datetime.timedelta(days=int(odate[i])), int(oprio[i]))
            for i in idx]


def oracle_partkey(li):
    """``group by l_partkey`` sum(l_quantity), count(*), by key."""
    import numpy as np

    keys, inv = np.unique(li["l_partkey"], return_inverse=True)
    sums = np.zeros(len(keys))
    np.add.at(sums, inv, li["l_quantity"])
    cnt = np.bincount(inv, minlength=len(keys))
    return [(int(k), float(s), int(c)) for k, s, c in zip(keys, sums, cnt)]


def rows_match(got, want, label: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, want {len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        for c, (x, y) in enumerate(zip(g, w)):
            if isinstance(y, float):
                if abs(x - y) > 1e-9 * max(abs(y), 1e-300):
                    raise AssertionError(
                        f"{label} row {r} col {c}: {x!r} != {y!r}")
            elif x != y:
                raise AssertionError(f"{label} row {r} col {c}: {x!r} != "
                                     f"{y!r}")


class DeviceSpy:
    """Records the device of every tensor the named ops functions get,
    so a run can show its join and aggregation inputs were on the card."""

    def __init__(self):
        self.seen = []
        self._undo = []

    def wrap(self, module, name: str, label: str) -> None:
        real = getattr(module, name)

        def spy(*args, **kwargs):
            self._record(label, args)
            return real(*args, **kwargs)

        setattr(module, name, spy)
        self._undo.append((module, name, real))

    def _record(self, label, obj) -> None:
        import torch

        if isinstance(obj, torch.Tensor):
            self.seen.append((label, obj.device))
        elif isinstance(obj, (list, tuple)):
            for o in obj:
                self._record(label, o)

    def restore(self) -> None:
        for module, name, real in reversed(self._undo):
            setattr(module, name, real)
        self._undo = []

    def check(self, labels) -> None:
        bad = [(q, str(d)) for q, d in self.seen if d.type != "cuda"]
        missing = set(labels) - {q for q, _ in self.seen}
        if bad or missing:
            raise AssertionError(f"inputs not on cuda: {bad[:5]}, never "
                                 f"seen: {sorted(missing)}")
        self.seen = []


class B2Rows:
    """Records the rows of every B2 launch of a run (batch rows, live rows,
    table slots) by wrapping the wrappers the hash tiers call; live counts
    stay on the card until ``take`` reads them."""

    def __init__(self):
        self.calls = []
        self._undo = []

    def wrap(self, module, name: str, mode: str) -> None:
        import torch

        real = getattr(module, name)

        def spy(keys, live, t_words, t_ctrl, *rest):
            if keys.is_cuda and keys.shape[0] > 0:
                self.calls.append((mode, keys.shape[0], keys.shape[0]
                                   if live is None
                                   else torch.count_nonzero(live),
                                   t_ctrl.shape[0]))
            return real(keys, live, t_words, t_ctrl, *rest)

        setattr(module, name, spy)
        self._undo.append((module, name, real))

    def restore(self) -> None:
        for module, name, real in reversed(self._undo):
            setattr(module, name, real)
        self._undo = []

    def take(self) -> dict:
        """Per mode: launches, and the mean, min and max of the batch rows
        and the live rows, and the table sizes with their launch counts;
        then forget the calls."""
        out = {}
        for mode in sorted({c[0] for c in self.calls}):
            calls = [c for c in self.calls if c[0] == mode]
            rows = [c[1] for c in calls]
            live = [int(c[2]) for c in calls]
            caps = {}
            for c in calls:
                caps[c[3]] = caps.get(c[3], 0) + 1
            out[mode] = {
                "launches": len(calls),
                "rows": [sum(rows) / len(rows), min(rows), max(rows)],
                "live": [sum(live) / len(live), min(live), max(live)],
                "caps": {str(c): m for c, m in sorted(caps.items())}}
        self.calls = []
        return out


def timed(runner, sql: str):
    import torch

    t0 = time.perf_counter()
    res = runner.execute(sql)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def op_tiers(runner, operator: str):
    """The kernel tiers the last query's ``operator`` instances ran."""
    return sorted({s.kernel_tier for s in runner._last_task.operator_stats
                   if operator in s.operator})


def agg_tiers(runner):
    return op_tiers(runner, "HashAggregation")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="TPC-H scale factor of the SQL phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel phase's random inputs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from presto_tpu_torch import cuda_build
    from presto_tpu_torch.ops import groupby as G
    from presto_tpu_torch.ops import hashtable as H
    from presto_tpu_torch.ops import join as J
    from presto_tpu_torch.ops import probe_insert as B2
    from presto_tpu_torch.ops import segment_sums as S

    card = card_line()
    print(f"card: {card}", flush=True)

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{cuda_build.sources()}", flush=True)
    for name, log in cuda_build.build_logs.items():
        print(f"nvcc[{name}]: {log.strip()}", flush=True)

    # -- phase 2: kernels against their plain versions --------------------
    # Q1's shape at SF1 (2^23 padded rows, 7 segments, 19 sum/count
    # columns), a ragged shape at the gate, and the smallest
    shapes = [(1 << 23, 7, 19), (1_000_003, 32, 5), (1, 1, 1)]
    checks = [check_segment_sums(n, g, a, args.seed + i)
              for i, (n, g, a) in enumerate(shapes)]
    for c in checks:
        print("segment_sums " + json.dumps(c), flush=True)
    inserts, lookups = b2_checks(args.seed)
    for c in inserts:
        print("probe_insert " + json.dumps(c), flush=True)
    for c in lookups:
        print("probe_lookup " + json.dumps(c), flush=True)
    print("c2 " + json.dumps(c2_checks(args.seed)), flush=True)

    # -- phase 3: SQL on the card -----------------------------------------
    from presto_tpu_torch.localrunner import LocalQueryRunner

    runner = LocalQueryRunner.tpch(scale=args.scale)
    if runner.device.type != "cuda":
        raise AssertionError(f"runner on {runner.device}")
    t0 = time.perf_counter()
    names = ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
             "l_orderkey", "l_partkey"]
    cols = lineitem_columns(args.scale, names)
    want = {"q1": oracle_q1(cols), "q6": oracle_q6(cols),
            "q3": oracle_q3(args.scale, cols),
            "partkey": oracle_partkey(cols)}
    n_rows = len(cols["l_shipdate"])
    del cols
    print(f"oracle: {n_rows} lineitem rows in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    sqls = {"q1": Q1, "q6": Q6, "q3": Q3, "partkey": PARTKEY}
    key_sorted = {"partkey"}       # no ORDER BY: compare in key order
    walls = {}
    results = {}

    def run(label):
        res, wall = timed(runner, sqls[label])
        rows = (sorted(res.rows) if label in key_sorted else res.rows)
        rows_match(rows, want[label], label)
        walls.setdefault(label, []).append(wall)
        results.setdefault(label, []).append(rows)
        return res

    # the B1 path: cold Q1, then Q6, each with the counts set to 0 just
    # before it (Q6's global sum launches no kernel of the port)
    spy = DeviceSpy()
    spy.wrap(G, "direct_grouped_aggregate", "q1")
    spy.wrap(G, "global_aggregate", "q6")
    for label in ("q1", "q6"):
        S.LAUNCHES.reset()
        B2.INSERT_LAUNCHES.reset()
        B2.LOOKUP_LAUNCHES.reset()
        run(label)
        if label == "q1":
            b1_launches = S.LAUNCHES.count
        spy.check([label])
    spy.restore()
    if b1_launches < 1:
        raise AssertionError("Q1 ran without launching segment_sums")

    # this slice's paths, each cold with the counts set to 0 just before
    # it and read just after: Q3, then the hash-tier GROUP BY
    spy.wrap(H, "pages_hash_build", "join")
    spy.wrap(H, "pages_hash_probe", "join")
    spy.wrap(J, "probe_counts", "join")
    spy.wrap(H, "groupby_update", "aggregation")
    spy.wrap(G, "grouped_aggregate", "aggregation")
    b2_launches = {}
    tiers = {}
    for label, inputs in (("q3", ["join", "aggregation"]),
                          ("partkey", ["aggregation"])):
        S.LAUNCHES.reset()
        B2.INSERT_LAUNCHES.reset()
        B2.LOOKUP_LAUNCHES.reset()
        run(label)
        b2_launches[label] = {"insert": B2.INSERT_LAUNCHES.count,
                              "lookup": B2.LOOKUP_LAUNCHES.count}
        tiers[label] = agg_tiers(runner)
        if label == "q3":
            join_tiers = op_tiers(runner, "LookupJoin")
        spy.check(inputs)
    spy.restore()
    # Q3's customer build (30,000 rows per SF) takes PagesHash up to the
    # 2^17-row bound of device_join_probe_max_build_rows: at SF1, not SF10
    if args.scale <= 1 and "hash" not in join_tiers:
        raise AssertionError(f"Q3's joins ran on {join_tiers}")
    q3_hash = "hash" in join_tiers or tiers["q3"] == ["hash"]
    if ((b2_launches["q3"]["insert"] > 0) != q3_hash
            or (b2_launches["q3"]["lookup"] > 0) != ("hash" in join_tiers)):
        raise AssertionError(f"Q3's B2 launches {b2_launches['q3']}; join "
                             f"tiers {join_tiers}, GROUP BY {tiers['q3']}")
    if b2_launches["partkey"]["insert"] < 1:
        raise AssertionError("the partkey GROUP BY ran without launching "
                             "probe_insert")
    if tiers["partkey"] != ["hash"]:
        raise AssertionError(f"partkey GROUP BY ran on {tiers['partkey']}")
    if args.scale >= 10 and tiers["q3"] != ["hash"]:
        raise AssertionError(f"Q3 GROUP BY at SF{args.scale} ran on "
                             f"{tiers['q3']}")
    print("b2_launches " + json.dumps({
        "by_path": b2_launches, "agg_tiers": tiers,
        "q3_join_tiers": join_tiers}), flush=True)

    for label in ("q1", "q6", "q3", "partkey"):
        for _ in range(2):
            run(label)
    # the rows of each B2 launch, from one more run of each path that no
    # wall reads (the recorder's live counts are launches of their own)
    b2_rows = B2Rows()
    b2_rows.wrap(B2, "insert_claims", "insert")
    b2_rows.wrap(B2, "lookup_ranges", "lookup")
    b2_shape = {}
    for label in ("q3", "partkey"):
        res = runner.execute(sqls[label])
        rows = sorted(res.rows) if label in key_sorted else res.rows
        rows_match(rows, want[label], label)
        results[label].append(rows)
        b2_shape[label] = b2_rows.take()
    b2_rows.restore()
    print("b2_rows " + json.dumps(b2_shape), flush=True)
    for label in ("q3", "partkey"):
        # C2: the same bits on every run, whatever slot ids B2 handed out
        first = results[label][0]
        if any(r != first for r in results[label][1:]):
            raise AssertionError(f"{label}: runs differ in their bits")
    for label, w in walls.items():
        warm = min(w[1:])
        print("sql " + json.dumps({
            "query": label, "scale": args.scale, "rows": n_rows,
            "cold_s": w[0], "warm_s": warm,
            "warm_rows_per_s": n_rows / warm, "card": card}), flush=True)

    def entry(name, source, replaces, launches, c):
        """``launches``: {path: count of that path's own run}; the key
        ``launches`` is the count on this slice's main path (Q3), or Q1's
        for B1.  B2's ``ms`` is ``kernel_ms``, its device time from a CUDA
        graph (the lookup's in the (lo, cnt) mode the path runs), with
        ``wrapper_ms`` (the call) and ``library_device_ms`` beside it."""
        main = launches.get("q3", launches.get("q1"))
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": main,
               "launches_by_path": launches,
               "max_abs_err": c["max_abs_err"], "ms": c["ms"],
               "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
               "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
        for key in ("shape", "kernel_ms", "wrapper_ms",
                    "library_device_ms"):
            if key in c:
                out[key] = c[key]
        return out

    kernels = [
        entry("direct_segment_sums",
              "presto_tpu_torch/csrc/segment_sums.cu",
              "presto_tpu/ops/pallas_groupby.py:48", {"q1": b1_launches},
              checks[0]),
        entry("probe_insert", "presto_tpu_torch/csrc/probe_insert.cu",
              "presto_tpu/ops/pallas_hash.py:44",
              {p: c["insert"] for p, c in b2_launches.items()}, inserts[0]),
        entry("probe_lookup", "presto_tpu_torch/csrc/probe_insert.cu",
              "presto_tpu/ops/pallas_hash.py:44",
              {p: c["lookup"] for p, c in b2_launches.items()}, lookups[0]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
