"""Smoke run of presto_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--scale 1.0] [--seed 0] [--ds-scale 1.0]

Phases (any failure exits non-zero; nothing is caught):

1. device and build: the card's name and power limit, then every kernel
   of ``presto_tpu_torch/csrc`` built with nvcc for sm_90a (one nvcc per
   source, in parallel), with the build seconds and ptxas report;
2. kernel against plain: each kernel's wrapper on tensors on the card at
   the shapes the main path gives it, held against its plain PyTorch
   version and against itself on a repeat, with CUDA-event times of the
   kernel, the plain version and one PyTorch library call, and the least
   time the card could take (``bound_ms``):
   - B1 (segment sums, ``B1_SHAPES``: Q1's at SF1, the gate's 32
     segments at a ragged N, one row, the edges of the 8-, 16- and
     32-segment builds, a column off 16 bytes): within 1e-12 relative of
     each group's pairwise sum (``torch.sum``) and within the float64
     error bound of two summations (2 n u sum|x|) of the plain version,
     bit-identical on a repeat, and out-of-range group ids counted in the
     status word and left out of the sums;
     ``kernel_ms`` (device time from a CUDA graph) and ``wrapper_ms``
     (the call) as for B2, and ``library_mm_ms`` (a float64 one-hot
     ``torch.mm``) beside ``library_ms`` (``index_add_``);
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
   - the float group sums of the direct (above B1's 32 groups), sort,
     hash and clustered (streaming) tiers, and a window's partition sums:
     bit-identical on a repeat;
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
     mean, min and max of batch and live rows, and the table sizes);
4. the queries of ``SQL_QUERIES`` on the card (TPC-H Q4, Q11, Q15, Q16,
   Q18, Q20, Q21, Q22: semi and anti joins, NOT IN, a correlated EXISTS
   and NOT EXISTS with a residual, cross joins against scalar
   subqueries), each against its numpy oracle (rows whose ORDER BY
   columns tie compared as sets), one cold and two warm runs giving the
   same bits, the semi/anti probes' inputs on cuda, and each query's own
   B1 and B2 launches and join tiers on its ``sql`` line; Q4 must launch
   B1 (its GROUP BY takes the direct tier), Q18 and Q20 B2's insert and
   lookup (their semi builds take PagesHash).  These counts join the
   kernels line's ``launches_by_path``.  One more run of each query,
   which no wall reads, keeps a copy of the inputs of each kernel's
   largest launch and of B2's insert into the fullest table (each insert
   with its table as it was before).  Q18's IN subquery must stream its
   GROUP BY (``q18_streaming`` line);
6. TPC-DS at ``--ds-scale`` (``DS_QUERIES``: BASELINE.md's config 5, Q72
   and Q95, then the window queries Q98, Q51, Q47, Q44 and Q67, the
   suite's text with ``DS_VARIANTS``) as phase 4 runs its queries, each
   against an oracle that uses none of the port's operators (Q72 in
   numpy, the rest in sqlite3 filled from the generator's columns); the
   ``sql`` lines add the window operator's, TopNRowNumber's and the
   streaming aggregation's host reads; its kept inputs go to phase 5
   under ``ds_<query>`` paths.  It runs before phase 5's checks;
7. tables on the card, on phase 3's runner at ``--scale``: lineitem,
   orders and customer copied into the memory catalog by CTAS (each
   returns the generator's row count, every stored batch compact on
   cuda; ``ctas`` lines with the wall, rows/s and bytes on the card);
   phase 3's Q1, Q6 and Q3 over them as phase 4 runs its queries
   (``mem_q1``, ``mem_q6``, ``mem_q3`` paths against phase 3's oracles;
   Q1 must launch B1), their warm walls beside phase 3's over tpch
   (``memory_vs_tpch``); INSERT of the 'R' rows, a DELETE of twice as
   many that reads the card at most once a stored batch, Q1 without the
   'R' group, a rolled-back INSERT (``dml``); ANALYZE against numpy's row
   count, ndv of l_returnflag and l_orderkey and l_shipdate's low and
   high, copying no column to the host (``analyze``); and a CTAS into
   the blackhole sink (``blackhole``).  Its kept inputs go to phase 5;
   it runs before phase 5's checks;
8. the rest of the statements and the sketches, on phase 3's runner at
   ``--scale``: SHOW CATALOGS, ``information_schema.columns`` of tpch
   (the generator's 61 columns) and ``system.nodes``, their batches on
   cuda (``catalogs``); a view of Q1 and an EXECUTE of Q3 prepared with
   its segment and dates as parameters, as phase 4 runs its queries
   (``view_q1``, ``exec_q3`` paths against phase 3's oracles, each with
   Q1's or Q3's own launches; DESCRIBE OUTPUT gives Q3's four columns);
   EXPLAIN ANALYZE of Q1 and Q3, every operator's rows those of a plain
   run's task stats in the same call, the output operator's the
   oracle's row count, the plain run's launches (``explain_analyze``
   lines, kept inputs as ``ea_q1``, ``ea_q3``); approx_distinct and
   approx_percentile over orders by priority and approx_distinct over
   lineitem, one feed thread, within 3 standard errors of numpy's exact
   distinct counts and the KLL rank bound, the same bits on two runs
   and on the CPU runner, xxh64 built with g++ (``sketch``,
   ``sketch_check``); GRANT/REVOKE under GrantAwareAccessControl and
   CALL system.runtime.kill_query (``access``).  Its kept inputs go to
   phase 5; it runs before phase 5's checks;
9. nested types, on phase 3's runner at ``--scale`` (``NESTED_QUERIES``):
   UNNEST of a three-element ARRAY constructor over orders WITH
   ORDINALITY grouped by priority (4.5M unnested rows at SF1; must launch
   B1), the words of ``split(o_comment, ' ')`` unnested and counted (the
   top 20), ``array_agg`` and ``map_agg`` over one month of orders by
   priority (arrays compared as multisets: four feed threads fix no
   order; maps exactly), ``cardinality(array_agg(o_orderkey))`` against
   ``count(*)`` over all of orders, corr/covar_samp/covar_pop/
   regr_slope/regr_intercept and min_by/max_by over orders by priority
   (numpy's two-pass values to 1e-9 relative, an intercept within its
   float64 bound), and ``checksum`` of three lineitem columns, bit-equal
   to the port's ``row_hash`` summed on the CPU over the generator's
   batches; each through ``run_paths`` against oracles in numpy and
   Python, then once more with one feed thread under CUDA's sync debug
   mode: at most one read of the card an UNNEST batch, the output
   batches' tensors on cuda, the copies of host tensors to the card
   counted (``nested`` lines); then one checksum per flat type at SF0.01
   equal to the CPU runner's and the tiny UNNEST cases (LEFT JOIN UNNEST
   of an empty and a NULL array, ``unnest(array[1,2], array[])``)
   against their literal answers (``nested_small``).  Its kept inputs go
   to phase 5; it runs before phase 5's checks;
5. each kernel at the inputs phases 4, 6, 7, 8 and 9 kept for each path, held
   against its plain version and timed as in phase 2 (``segment_sums``,
   ``probe_insert`` and ``probe_lookup`` lines with a ``path``, and under
   ``by_path`` in the kernels line); a path that launched a kernel and
   kept no inputs for it fails.

Phase 2 calls the wrappers the hash tiers call (``B2.insert_claims``,
``B2.lookup``, ``B2.lookup_ranges``) for its checks.

The last lines are the kernels line ``{"kernels": [...]}``, the card's
``name, power.limit`` and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

# H100 SXM data sheet rates (the card's memory rate; its float64 add rate
# outside the tensor cores, the data sheet's 34 TFLOP/s counting an FMA as
# two operations; and the float32 rate outside the tensor cores, taken for
# 32-bit integer ops)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 17e12
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


# TPC-H queries with semi and anti joins, a cross join against a scalar
# subquery, or both (the TPC-H spec's text with its validation parameters)
SQL_QUERIES = {
    "q4": """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (select * from lineitem
              where l_orderkey = o_orderkey
                and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
""",
    "q11": """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
    select sum(ps_supplycost * ps_availqty) * 0.0001
    from partsupp, supplier, nation
    where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
      and n_name = 'GERMANY')
order by value desc
""",
    "q15": """
with revenue as (
    select l_suppkey as supplier_no,
           sum(l_extendedprice * (1 - l_discount)) as total_revenue
    from lineitem
    where l_shipdate >= date '1996-01-01'
      and l_shipdate < date '1996-01-01' + interval '3' month
    group by l_suppkey)
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue)
order by s_suppkey
""",
    "q16": """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (select s_suppkey from supplier
                         where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
    "q18": """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey
                     having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
""",
    "q20": """
select s_name, s_address
from supplier, nation
where s_suppkey in (
        select ps_suppkey from partsupp
        where ps_partkey in (select p_partkey from part
                             where p_name like 'forest%')
          and ps_availqty > (select 0.5 * sum(l_quantity)
                             from lineitem
                             where l_partkey = ps_partkey
                               and l_suppkey = ps_suppkey
                               and l_shipdate >= date '1994-01-01'
                               and l_shipdate < date '1994-01-01'
                                               + interval '1' year))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name
""",
    "q21": """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
  and exists (select * from lineitem l2
              where l2.l_orderkey = l1.l_orderkey
                and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select * from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey
                    and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
""",
    "q22": """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (select substring(c_phone, 1, 2) as cntrycode, c_acctbal
      from customer
      where substring(c_phone, 1, 2) in
                ('13', '31', '23', '29', '30', '18', '17')
        and c_acctbal > (select avg(c_acctbal) from customer
                         where c_acctbal > 0.00
                           and substring(c_phone, 1, 2) in
                               ('13', '31', '23', '29', '30', '18', '17'))
        and not exists (select * from orders
                        where o_custkey = c_custkey)
     ) as custsale
group by cntrycode
order by cntrycode
""",
}

# each query's ORDER BY columns: rows whose sort keys tie may come in any
# order, so the comparison takes each run of ties as a set
SQL_ORDER_COLUMNS = {"q4": [0], "q11": [1], "q15": [0], "q16": [3, 0, 1, 2],
                     "q18": [4, 3], "q20": [0], "q21": [1, 0], "q22": [0]}


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

def b1_inputs(n: int, g: int, a: int, seed: int, odd: bool = False):
    """B1's inputs: int32 group ids in [0, g) and ``a`` float64 columns,
    each its own allocation as the direct tier makes them; with ``odd``
    the first column lies at an odd 8-byte offset (not 16-byte aligned)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gid = torch.randint(0, g, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    cols = [torch.rand(n, generator=gen, device="cuda",
                       dtype=torch.float64) * 1e5 for _ in range(a)]
    if odd:
        shifted = torch.empty(n + 1, dtype=torch.float64, device="cuda")[1:]
        cols[0] = shifted.copy_(cols[0])
    return gid, cols


def _rel_err(got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def _pairwise_sums(gid, cols, g: int):
    """Each group's sum of each column by ``torch.sum`` (a tree reduction,
    accurate to about log2(n) rounding errors), the sums of the columns'
    magnitudes, and each group's rows."""
    import torch

    sums = torch.zeros((g, len(cols)), dtype=torch.float64,
                       device=gid.device)
    mags = torch.zeros_like(sums)
    rows = torch.zeros(g, dtype=torch.float64, device=gid.device)
    for s in range(g):
        m = gid == s
        rows[s] = m.sum()
        for j, c in enumerate(cols):
            x = torch.where(m, c, 0.0)
            sums[s, j] = x.sum()
            mags[s, j] = x.abs().sum()
    return sums, mags, rows


def _sums_agree(label: str, got, plain, gid, cols, g: int) -> float:
    """B1's sums ``got`` within 1e-12 relative of each group's pairwise
    sum, and within the float64 error bound of two summations of each
    group's rows in any order (2 n u sum|x|, u = 2^-53) of the plain
    version ``plain``, which adds a group's rows one after another
    (``index_add_``) and on Q1's columns strays about 3e-12 from the
    pairwise sums.  Returns the relative error against them."""
    pairwise, mags, rows = _pairwise_sums(gid, cols, g)
    rel = _rel_err(got, pairwise)
    if rel > 1e-12:
        raise AssertionError(f"segment_sums {label}: relative error {rel} "
                             "> 1e-12 against the pairwise sums")
    slack = 2.0 * rows[:, None] * 2.0 ** -53 * mags
    over = float(((got - plain).abs() - slack).max())
    if over > 0:
        raise AssertionError(f"segment_sums {label}: {over} beyond the "
                             "float64 bound of the plain version")
    return rel


def check_segment_sums(label: str, gid, cols, g: int) -> dict:
    """B1 on ``gid`` and ``cols`` (``g`` segments), through the wrapper the
    direct tier calls: in agreement with the plain version and within
    1e-12 relative of the pairwise sums (``_sums_agree``), bit-identical
    on a repeat, a status word of 0, and with some group ids out of
    range, those rows counted in the status word and left out of the
    sums.  Then the times:
    ``kernel_ms`` (device time of one launch of the C entry, from a CUDA
    graph), ``wrapper_ms`` (``direct_segment_sums`` as the direct tier
    calls it, CUDA events, host included), the plain version,
    ``index_add_`` and a float64 one-hot ``torch.mm`` (the TPU kernel's
    formulation on cuBLAS) over the stacked columns."""
    import torch

    from presto_tpu_torch.ops import segment_sums as S

    n, a = gid.shape[0], len(cols)
    odd = any(c.data_ptr() % 16 for c in cols)
    got, bad = S.direct_segment_sums(gid, cols, g)
    again, bad2 = S.direct_segment_sums(gid, cols, g)
    want = S.direct_segment_sums_reference(gid, cols, g)
    torch.cuda.synchronize()
    rel_err = _rel_err(got, want)
    pairwise_err = _sums_agree(label, got, want, gid, cols, g)
    if not torch.equal(got, again):
        raise AssertionError(f"segment_sums {label}: two runs differ")
    if int(bad[0]) != 0 or int(bad2[0]) != 0:
        raise AssertionError(f"segment_sums {label}: status "
                             f"{int(bad[0])}, {int(bad2[0])} for ids in "
                             "range")
    # every (n // 5)-th row out of range, alternately n_seg and -1
    idx = torch.arange(0, n, max(1, n // 5), device="cuda")
    gid_bad = gid.clone()
    gid_bad[idx[0::2]] = g
    gid_bad[idx[1::2]] = -1
    ok = (gid_bad >= 0) & (gid_bad < g)
    got_bad, n_bad = S.direct_segment_sums(gid_bad, cols, g)
    want_bad = S.direct_segment_sums_reference(
        torch.where(ok, gid_bad, 0), [torch.where(ok, c, 0.0) for c in cols],
        g)
    if int(n_bad[0]) != idx.numel():
        raise AssertionError(f"segment_sums {label}: status {int(n_bad[0])}"
                             f", {idx.numel()} rows out of range")
    _sums_agree(f"{label} with rows out of range", got_bad, want_bad,
                gid_bad, cols, g)
    del gid_bad, ok, got_bad, want_bad

    iters = 20 if n > 100_000 else 200
    bufs = S.buffers(gid, cols, g)
    kernel_ms = graph_ms(lambda: S.launch(gid, cols, g, *bufs), iters)
    wrapper_ms = cuda_ms(lambda: S.direct_segment_sums(gid, cols, g), iters)
    plain_ms = cuda_ms(
        lambda: S.direct_segment_sums_reference(gid, cols, g), iters)
    stacked = torch.stack(cols, 1)
    gid64 = gid.long()
    library_ms = cuda_ms(
        lambda: torch.zeros((g, a), dtype=torch.float64,
                            device="cuda").index_add_(0, gid64, stacked),
        iters)
    one_hot = (gid[None, :] == torch.arange(g, device="cuda",
                                            dtype=torch.int32)[:, None]
               ).to(torch.float64)
    library_mm_ms = cuda_ms(lambda: torch.mm(one_hot, stacked), iters)
    del stacked, one_hot
    nbytes = n * (4 + 8 * a) + g * a * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * a / FP64_OPS_PER_S * 1e3
    per, blocks = S._grid(gid, a, g)
    return {"shape": label, "n": n, "g": g, "a": a, "odd_column": odd,
            "launches_per_call": -(-a // per), "blocks": blocks,
            "max_abs_err": float((got - want).abs().max()),
            "max_rel_err": rel_err, "max_rel_err_pairwise": pairwise_err,
            "bit_identical": True,
            "status_rows": int(n_bad[0]),
            "ms": kernel_ms, "kernel_ms": kernel_ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_mm_ms": library_mm_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# B1's phase-2 shapes: (label, n, n_seg, columns, odd-offset column).
# Q1's at SF1 (2^23 padded rows, 7 segments, 19 sum/count columns) first;
# the gate's largest n_seg at a ragged N; the smallest; the edges of the
# 8-, 16- and 32-segment builds at Q1's N and A; a column off 16 bytes
B1_SHAPES = [
    ("q1_sf1", 1 << 23, 7, 19, False),
    ("gate_ragged", 1_000_003, 32, 5, False),
    ("smallest", 1, 1, 1, False),
    ("q1_n_seg_8", 1 << 23, 8, 19, False),
    ("q1_n_seg_9", 1 << 23, 9, 19, False),
    ("q1_n_seg_16", 1 << 23, 16, 19, False),
    ("q1_n_seg_17", 1 << 23, 17, 19, False),
    ("q1_odd_column", 1 << 23, 7, 19, True),
]


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
    """The table a shape's batch goes into: a copy of its ``table`` (one
    a query path held), or empty, or holding its ``prefill`` (inserted by
    the kernel).  Returns (t_words, t_ctrl)."""
    from presto_tpu_torch.ops import hashtable as H
    from presto_tpu_torch.ops import probe_insert as B2

    if shape.get("table") is not None:
        return tuple(t.clone() for t in shape["table"])
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
    if shape["prefill"] is None and shape.get("table") is None:
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
            "prefilled": int((tc0 != H.EMPTY).sum()),
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
    live = shape["live"]
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device="cuda")
    slot, found = B2.lookup(probe, live, tw, tc)
    slot2, found2 = B2.lookup(probe, live, tw, tc)
    pslot, pfound = H.probe_find(probe, live, tw, tc)
    torch.cuda.synchronize()
    truth = (torch.isin(probe[:, 0], build[:, 0]) & live if k == 1
             else None)
    if not (torch.equal(found, pfound) and torch.equal(found, found2)):
        raise AssertionError(f"{label}: found flags differ from plain")
    if truth is not None and not torch.equal(found, truth):
        raise AssertionError(f"{label}: found flags differ from membership")
    if not (torch.equal(slot[found], pslot[found])
            and torch.equal(slot, slot2)):
        raise AssertionError(f"{label}: found slots differ from plain")
    if shape.get("ranges") is not None:       # the path's own
        starts, counts = shape["ranges"]
    else:
        # PagesHash ranges over the table: 1 to 4 build rows per key
        gen = torch.Generator(device="cuda").manual_seed(cap)
        counts = torch.where(
            tc != H.EMPTY, torch.randint(1, 5, (cap,), generator=gen,
                                         device="cuda", dtype=torch.int32),
            0)
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
              + min(table_bytes, int(live.sum()) * 2 * SECTOR))
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
    """The float group sums of the direct (above 32 groups), sort, hash
    and clustered (streaming) tiers, and a window's partition sums (the
    segmented scan): the same bits on a repeat, and within 1e-9 relative
    of a float64 ``index_add_``."""
    import torch

    from presto_tpu_torch import types as T
    from presto_tpu_torch.ops import groupby as G
    from presto_tpu_torch.ops import hashtable as H
    from presto_tpu_torch.ops import window as W

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 1 << 21
    keys = torch.randint(0, 100_000, (n,), generator=gen, device="cuda",
                         dtype=torch.int64)
    vals = torch.rand(n, generator=gen, device="cuda",
                      dtype=torch.float64) * 1e5
    codes = (keys % 64).to(torch.int32)

    def direct():
        _present, res, _bad = G.direct_grouped_aggregate(
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

    order = torch.argsort(keys, stable=True)
    skeys, svals = keys[order], vals[order]
    starts = torch.ones(n, dtype=torch.bool, device="cuda")
    starts[1:] = skeys[1:] != skeys[:-1]
    first = torch.nonzero(starts).squeeze(1)

    def clustered():
        first_pos, ng, res = G.clustered_aggregate(
            [(skeys, None, T.BIGINT)], [("sum", svals, None)], n, n)
        g = int(ng)
        return res[0][0][:g], skeys[first_pos[:g]]

    def window():
        seg = W.segment_ids(~starts)
        lo, hi = W.frame_ends(seg, seg, "range", "unbounded_preceding",
                              "unbounded_following")
        total, _cnt = W.framed_sum_count(seg, svals, None, lo, hi)
        return total[first], skeys[first]

    out = {}
    for name, fn, ids in (("direct", direct, codes.long()),
                          ("sort", sort, keys), ("hash", hashed, keys),
                          ("clustered", clustered, keys),
                          ("window", window, keys)):
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


def _date(days) -> datetime.date:
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))


def _like(values, pattern: str):
    """SQL LIKE over a numpy array of strings."""
    import re

    import numpy as np

    rx = re.compile("".join(".*" if c == "%" else "." if c == "_"
                            else re.escape(c) for c in pattern), re.S)
    return np.fromiter((rx.fullmatch(v) is not None for v in values),
                       dtype=bool, count=len(values))


def _lookup(keys, wanted):
    """Positions of ``wanted`` in the unsorted unique ``keys`` (every
    wanted key present)."""
    import numpy as np

    order = np.argsort(keys, kind="stable")
    return order[np.searchsorted(keys[order], wanted)]


def _sums_by(keys, values):
    """Sorted unique ``keys`` and the sum of ``values`` for each."""
    import numpy as np

    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq))
    np.add.at(sums, inv, values)
    return uniq, sums


def _nation_key(scale: float, name: str) -> int:
    na = table_columns(scale, "nation", ["n_nationkey", "n_name"])
    return int(na["n_nationkey"][na["n_name"] == name][0])


def oracle_q4(scale: float, li):
    import numpy as np

    od = table_columns(scale, "orders", ["o_orderkey", "o_orderdate",
                                         "o_orderpriority"])
    late = np.unique(li["l_orderkey"][li["l_commitdate"]
                                      < li["l_receiptdate"]])
    sel = ((od["o_orderdate"] >= _days(1993, 7, 1))
           & (od["o_orderdate"] < _days(1993, 10, 1))
           & np.isin(od["o_orderkey"], late))
    prio, cnt = np.unique(od["o_orderpriority"][sel], return_counts=True)
    return [(str(p), int(c)) for p, c in zip(prio, cnt)]


def oracle_q11(scale: float):
    import numpy as np

    ps = table_columns(scale, "partsupp", ["ps_partkey", "ps_suppkey",
                                           "ps_availqty", "ps_supplycost"])
    su = table_columns(scale, "supplier", ["s_suppkey", "s_nationkey"])
    supp = su["s_suppkey"][su["s_nationkey"]
                           == _nation_key(scale, "GERMANY")]
    sel = np.isin(ps["ps_suppkey"], supp)
    value = ps["ps_supplycost"][sel] * ps["ps_availqty"][sel]
    keys, sums = _sums_by(ps["ps_partkey"][sel], value)
    keep = sums > value.sum() * 0.0001
    keys, sums = keys[keep], sums[keep]
    order = np.lexsort((keys, -sums))
    return [(int(keys[i]), float(sums[i])) for i in order]


def oracle_q15(scale: float, li):
    import numpy as np

    sd = li["l_shipdate"]
    sel = (sd >= _days(1996, 1, 1)) & (sd < _days(1996, 4, 1))
    keys, sums = _sums_by(li["l_suppkey"][sel],
                          li["l_extendedprice"][sel]
                          * (1.0 - li["l_discount"][sel]))
    top = np.nonzero(sums == sums.max())[0]
    su = table_columns(scale, "supplier", ["s_suppkey", "s_name",
                                           "s_address", "s_phone"])
    pos = _lookup(su["s_suppkey"], keys[top])
    return [(int(keys[t]), str(su["s_name"][p]), str(su["s_address"][p]),
             str(su["s_phone"][p]), float(sums[t]))
            for t, p in zip(top, pos)]


def oracle_q16(scale: float):
    import numpy as np

    pa = table_columns(scale, "part", ["p_partkey", "p_brand", "p_type",
                                       "p_size"])
    ps = table_columns(scale, "partsupp", ["ps_partkey", "ps_suppkey"])
    su = table_columns(scale, "supplier", ["s_suppkey", "s_comment"])
    bad = su["s_suppkey"][_like(su["s_comment"], "%Customer%Complaints%")]
    psel = ((pa["p_brand"] != "Brand#45")
            & ~_like(pa["p_type"], "MEDIUM POLISHED%")
            & np.isin(pa["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
    pos = _lookup(pa["p_partkey"], ps["ps_partkey"])
    keep = psel[pos] & ~np.isin(ps["ps_suppkey"], bad)
    groups = {}
    for p, sk in zip(pos[keep], ps["ps_suppkey"][keep]):
        key = (str(pa["p_brand"][p]), str(pa["p_type"][p]),
               int(pa["p_size"][p]))
        groups.setdefault(key, set()).add(int(sk))
    rows = [k + (len(v),) for k, v in groups.items()]
    return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))


def oracle_q18(scale: float, li):
    import numpy as np

    keys, qty = _sums_by(li["l_orderkey"], li["l_quantity"])
    big = qty > 300
    od = table_columns(scale, "orders", ["o_orderkey", "o_custkey",
                                         "o_orderdate", "o_totalprice"])
    cu = table_columns(scale, "customer", ["c_custkey", "c_name"])
    opos = _lookup(od["o_orderkey"], keys[big])
    order = np.lexsort((od["o_orderdate"][opos],
                        -od["o_totalprice"][opos]))[:100]
    cpos = _lookup(cu["c_custkey"], od["o_custkey"][opos])
    return [(str(cu["c_name"][cpos[i]]), int(od["o_custkey"][opos[i]]),
             int(od["o_orderkey"][opos[i]]),
             _date(od["o_orderdate"][opos[i]]),
             float(od["o_totalprice"][opos[i]]), float(qty[big][i]))
            for i in order]


def oracle_q20(scale: float, li):
    import numpy as np

    pa = table_columns(scale, "part", ["p_partkey", "p_name"])
    forest = pa["p_partkey"][_like(pa["p_name"], "forest%")]
    sd = li["l_shipdate"]
    sel = (sd >= _days(1994, 1, 1)) & (sd < _days(1995, 1, 1))
    span = int(li["l_suppkey"].max()) + 1
    keys, qty = _sums_by(li["l_partkey"][sel] * span
                         + li["l_suppkey"][sel], li["l_quantity"][sel])
    ps = table_columns(scale, "partsupp", ["ps_partkey", "ps_suppkey",
                                           "ps_availqty"])
    pk = ps["ps_partkey"] * span + ps["ps_suppkey"]
    pos = np.clip(np.searchsorted(keys, pk), 0, len(keys) - 1)
    # no lineitem rows: the scalar subquery is NULL and the row drops
    found = keys[pos] == pk
    ok = (np.isin(ps["ps_partkey"], forest) & found
          & (ps["ps_availqty"] > 0.5 * qty[pos]))
    su = table_columns(scale, "supplier", ["s_suppkey", "s_name",
                                           "s_address", "s_nationkey"])
    s_sel = ((su["s_nationkey"] == _nation_key(scale, "CANADA"))
             & np.isin(su["s_suppkey"], ps["ps_suppkey"][ok]))
    return sorted((str(n), str(a)) for n, a in
                  zip(su["s_name"][s_sel], su["s_address"][s_sel]))


def oracle_q21(scale: float, li):
    import numpy as np

    ok, sk = li["l_orderkey"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    uniq, inv = np.unique(ok, return_inverse=True)
    big = np.iinfo(np.int64).max
    lo, hi = np.full(len(uniq), big), np.full(len(uniq), -1)
    np.minimum.at(lo, inv, sk)
    np.maximum.at(hi, inv, sk)
    late_lo, late_hi = np.full(len(uniq), big), np.full(len(uniq), -1)
    np.minimum.at(late_lo, inv[late], sk[late])
    np.maximum.at(late_hi, inv[late], sk[late])
    od = table_columns(scale, "orders", ["o_orderkey", "o_orderstatus"])
    status = od["o_orderstatus"][_lookup(od["o_orderkey"], ok)]
    su = table_columns(scale, "supplier", ["s_suppkey", "s_name",
                                           "s_nationkey"])
    saudi = su["s_suppkey"][su["s_nationkey"]
                            == _nation_key(scale, "SAUDI ARABIA")]
    # exists: the order has a line of another supplier; not exists: no
    # late line of another supplier (l1 is late itself)
    other = ~((lo[inv] == sk) & (hi[inv] == sk))
    no_late_other = (late_lo[inv] == sk) & (late_hi[inv] == sk)
    sel = (late & (status == "F") & np.isin(sk, saudi) & other
           & no_late_other)
    names = su["s_name"][_lookup(su["s_suppkey"], sk[sel])]
    name, cnt = np.unique(names, return_counts=True)
    rows = [(str(n), int(c)) for n, c in zip(name, cnt)]
    return sorted(rows, key=lambda r: (-r[1], r[0]))[:100]


def oracle_q22(scale: float):
    import numpy as np

    cu = table_columns(scale, "customer", ["c_custkey", "c_phone",
                                           "c_acctbal"])
    od = table_columns(scale, "orders", ["o_custkey"])
    code = np.asarray([p[:2] for p in cu["c_phone"]], dtype=object)
    incode = np.isin(code, ["13", "31", "23", "29", "30", "18", "17"])
    bal = cu["c_acctbal"]
    pos = (bal > 0.0) & incode
    avg = bal[pos].sum() / pos.sum()
    sel = incode & (bal > avg) & ~np.isin(cu["c_custkey"],
                                          np.unique(od["o_custkey"]))
    codes, sums = _sums_by(code[sel].astype(str), bal[sel])
    cnt = np.unique(code[sel].astype(str), return_counts=True)[1]
    return [(str(c), int(n), float(v)) for c, n, v in zip(codes, cnt, sums)]


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


def _by(*cols):
    """ORDER BY columns (index, descending) -> the key of one row."""
    return lambda r: tuple(r[c] for c, _ in cols), [d for _, d in cols]


def _tie(a, b) -> bool:
    for x, y in zip(a, b):
        if isinstance(y, float) and isinstance(x, float):
            if abs(x - y) > 1e-9 * max(abs(y), 1e-300):
                return False
        elif x != y:
            return False
    return True


def _exact(r):
    return tuple(str(x) for x in r if not isinstance(x, float))


def _row_close(g, w) -> bool:
    try:
        rows_match([g], [w], "")
    except AssertionError:
        return False
    return True


def rows_match_limit(got, want, key, label: str, limit=None) -> None:
    """``want``: every oracle row in ORDER BY order.  Runs of rows whose
    ORDER BY values tie compare as sets; where the LIMIT cuts a run, the
    port's rows of it must be among the oracle's."""
    n = len(want) if limit is None else min(limit, len(want))
    if len(got) != n:
        raise AssertionError(f"{label}: {len(got)} rows, want {n}")
    i = 0
    while i < n:
        j = i + 1
        while j < len(want) and _tie(key(want[j]), key(want[i])):
            j += 1
        if j <= n:
            rows_match(sorted(got[i:j], key=_exact),
                       sorted(want[i:j], key=_exact),
                       f"{label} rows {i}-{j}")
        else:
            pool = list(want[i:j])
            for g in got[i:n]:
                hit = next((p for p in pool if _row_close(g, p)), None)
                if hit is None:
                    raise AssertionError(f"{label}: {g!r} is not among the "
                                         f"{len(pool)} tied oracle rows")
                pool.remove(hit)
        i = j


class DeviceSpy:
    """Records the device of every tensor the named ops functions get (a
    batch's and a column's too, children included), so a run can show
    its join and aggregation inputs and its output were on the card;
    and counts the calls of the functions that read the device to the
    host (``count``: the window operator's partition starts,
    TopNRowNumber's kept rows, the streaming aggregation's one read a
    batch)."""

    def __init__(self):
        self.seen = []
        self.reads = {}
        self._undo = []

    def count(self, module, name: str, label: str) -> None:
        real = getattr(module, name)

        def counted(*args, **kwargs):
            self.reads[label] = self.reads.get(label, 0) + 1
            return real(*args, **kwargs)

        setattr(module, name, counted)
        self._undo.append((module, name, real))

    def take_reads(self) -> dict:
        out, self.reads = self.reads, {}
        return out

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
        elif hasattr(obj, "columns"):                   # a Batch
            self._record(label, obj.columns)
        elif hasattr(obj, "children"):                  # a Column
            for a in (obj.values, obj.valid):
                if a is not None and not isinstance(a, torch.Tensor):
                    self.seen.append((label, torch.device("cpu")))
            self._record(label, [obj.values, obj.valid, obj.children])

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


def launch_rows(args):
    return (args[0].shape[0],)


def insert_load(args):
    """An insert's (keys the table held before it, rows)."""
    from presto_tpu_torch.ops import hashtable as H

    return (int((args[3] != H.EMPTY).sum()), args[0].shape[0])


class PathInputs:
    """Keeps a copy of the inputs of one launch a kernel in a run, the one
    ``score`` ranks highest (default: the most rows), by wrapping the
    wrappers the tiers call: B1's ``direct_segment_sums`` as
    ops/groupby.py calls it, B2's ``insert_claims`` (the table copied
    before the insert fills it) and ``lookup_ranges`` (with the PagesHash
    ranges).  ``take`` hands them over as {kernel: (score, args)} and
    forgets them."""

    def __init__(self):
        self.kept = {}
        self._undo = []

    def wrap(self, module, name: str, kernel: str,
             score=launch_rows) -> None:
        real = getattr(module, name)

        def copy(obj):
            if isinstance(obj, (list, tuple)):
                return type(obj)(copy(o) for o in obj)
            return obj.clone() if hasattr(obj, "clone") else obj

        def spy(*args):
            if args[0].is_cuda and args[0].shape[0] > 0:
                rank = score(args)
                if kernel not in self.kept or rank > self.kept[kernel][0]:
                    self.kept[kernel] = (rank, copy(args))
            return real(*args)

        setattr(module, name, spy)
        self._undo.append((module, name, real))

    def restore(self) -> None:
        for module, name, real in reversed(self._undo):
            setattr(module, name, real)
        self._undo = []

    def take(self) -> dict:
        out, self.kept = self.kept, {}
        return out


def path_checks(inputs: dict) -> dict:
    """Each kernel at the inputs ``PathInputs`` kept on each query path
    (its largest launch; for B2's insert also the launch into the
    fullest table, under ``<path>_loaded``, where that is another
    launch), held against its plain version and timed as in phase 2:
    {kernel: {path: check row}}."""
    from presto_tpu_torch.ops import hashtable as H

    out = {"b1": {}, "insert": {}, "lookup": {}}
    for path, kept in inputs.items():
        if "b1" in kept:
            gid, cols, g = kept["b1"][1]
            out["b1"][path] = check_segment_sums(path, gid, cols, g)
        inserts = [(path, kept.get("insert"))]
        if "insert_loaded" in kept:
            (held, rows), _args = kept["insert_loaded"]
            largest = kept["insert"][1]
            if (rows, held) != (largest[0].shape[0],
                                int((largest[3] != H.EMPTY).sum())):
                inserts.append((f"{path}_loaded", kept["insert_loaded"]))
        for label, pick in inserts:
            if pick is None:
                continue
            keys, live, tw, tc = pick[1]
            out["insert"][label] = check_probe_insert(dict(
                label=label, mode="insert", keys=keys, live=live,
                cap=tc.shape[0], prefill=None, table=(tw, tc)))
        if "lookup" in kept:
            keys, live, tw, tc, starts, counts = kept["lookup"][1]
            out["lookup"][path] = check_probe_lookup(dict(
                label=path, mode="lookup", keys=keys, live=live,
                cap=tc.shape[0], build=tw[tc != H.EMPTY], table=(tw, tc),
                ranges=(starts, counts)))
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


def semi_oracles(scale: float, li) -> dict:
    return {"q4": oracle_q4(scale, li), "q11": oracle_q11(scale),
            "q15": oracle_q15(scale, li), "q16": oracle_q16(scale),
            "q18": oracle_q18(scale, li), "q20": oracle_q20(scale, li),
            "q21": oracle_q21(scale, li), "q22": oracle_q22(scale)}


# paths whose cold run must launch a kernel: Q4's GROUP BY takes the
# direct tier (5 priorities: B1); the semi builds of Q18 and Q20 hold well
# under device_join_probe_max_build_rows, so they take PagesHash (B2
# insert and lookup)
SEMI_MUST_LAUNCH = {"q4": ("b1",), "q18": ("insert", "lookup"),
                    "q20": ("insert", "lookup")}


def scanned_rows(runner, scale: float, sql: str) -> int:
    """The rows of every tpch, tpcds or memory table scan in the query's
    plan, the first two catalogs generated at ``scale``."""
    import re

    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector

    conns = {"tpch": TpchConnector(scale=scale),
             "tpcds": TpcdsConnector(scale=scale),
             "memory": runner.registry.get("memory")}
    return sum(int(conns[c].table_statistics(conns[c].get_table(t))
                   .row_count)
               for c, t in re.findall(
                   r"TableScan (tpch|tpcds|memory)\.(\w+)",
                   runner.explain(sql)))


def run_paths(runner, queries: dict, card: str, scale: float, modules,
              compare, spy: "DeviceSpy", spy_inputs: dict,
              must_launch: dict, scanned, warm=None,
              order_free=(), cold=None) -> tuple:
    """One phase of SQL paths on the card: for each query of ``queries``
    (label -> SQL), a cold run with the launch counts set to 0 just
    before it and read just after, then two warm runs; every run's rows
    held against the oracle by ``compare(label, rows)``, the same bits on
    every run, the inputs ``spy`` watches on cuda (``spy_inputs``: the
    labels each query must show), the kernels ``must_launch`` names
    launched.  One more run of each, which no wall reads, keeps the
    inputs of each kernel's largest launch and of B2's insert into the
    fullest table (``PathInputs``).  Each query prints a ``sql`` line:
    its walls, the rows of every table scan of its plan (``scanned``),
    its launches, join and aggregation tiers, and the host reads
    ``spy`` counted in its cold run.  The paths of ``order_free`` keep
    only the oracle's check on every run: their rows follow the order in
    which the feed threads' rows arrive (a collected array, the sums over
    it).  Returns the launches and the kept inputs by path, and puts each
    query's warm wall in ``warm`` and its cold wall in ``cold`` when
    given."""
    S, B2, H, J, G = modules
    launches, kept = {}, {}
    keep = PathInputs()
    for label, sql in queries.items():
        S.LAUNCHES.reset()
        B2.INSERT_LAUNCHES.reset()
        B2.LOOKUP_LAUNCHES.reset()
        spy.take_reads()
        res, wall = timed(runner, sql)
        launches[label] = {"b1": S.LAUNCHES.count,
                           "insert": B2.INSERT_LAUNCHES.count,
                           "lookup": B2.LOOKUP_LAUNCHES.count}
        reads = spy.take_reads()
        stats = runner._last_task.operator_stats
        join_tiers = [s.kernel_tier for s in stats
                      if "LookupJoin" in s.operator]
        aggs = [f"{s.operator.rsplit('.', 1)[-1]}:{s.kernel_tier}"
                for s in stats if "Aggregation" in s.operator]
        spy.check(spy_inputs[label])
        walls = [wall]
        results = [res.rows]
        for _ in range(2):
            res, wall = timed(runner, sql)
            walls.append(wall)
            results.append(res.rows)
        spy.check(spy_inputs[label])
        keep.wrap(G, "direct_segment_sums", "b1")
        keep.wrap(B2, "insert_claims", "insert")
        keep.wrap(B2, "insert_claims", "insert_loaded", insert_load)
        keep.wrap(B2, "lookup_ranges", "lookup")
        results.append(runner.execute(sql).rows)
        keep.restore()
        spy.seen = []
        kept[label] = keep.take()
        for rows in results:
            compare(label, rows)
        if label not in order_free and any(r != results[0]
                                           for r in results[1:]):
            raise AssertionError(f"{label}: runs differ in their bits")
        for kind in must_launch.get(label, ()):
            if launches[label][kind] < 1:
                raise AssertionError(f"{label} ran without a {kind} launch: "
                                     f"{launches[label]}, joins "
                                     f"{join_tiers}")
        n_rows = scanned(sql)
        if warm is not None:
            warm[label] = min(walls[1:])
        if cold is not None:
            cold[label] = walls[0]
        print("sql " + json.dumps({
            "query": label, "scale": scale, "rows": n_rows,
            "result_rows": len(results[0]), "cold_s": walls[0],
            "warm_s": min(walls[1:]),
            "warm_rows_per_s": n_rows / min(walls[1:]),
            "join_tiers": join_tiers, "agg_tiers": aggs,
            "launches": launches[label], "host_reads": reads,
            "card": card}), flush=True)
    return launches, kept


def semi_phase(runner, scale: float, card: str, want: dict,
               modules) -> tuple:
    """Phase 4: the queries of ``SQL_QUERIES`` on the card against their
    numpy oracles (ties in the ORDER BY columns compared as sets), the
    semi and anti probes' inputs on cuda (``run_paths``).  Q18's
    ``group by l_orderkey`` must take the streaming aggregation, as the
    JAX package plans it.  Returns the launches and kept inputs by path."""
    S, B2, H, J, G = modules
    spy = DeviceSpy()
    for name in ("semi_mask", "anti_keep_from_parts", "any_pair_passes"):
        spy.wrap(J, name, "semi")
    spy.wrap(H, "pages_hash_probe", "join")
    spy.wrap(J, "probe_counts", "join")
    spy.wrap(G, "clustered_aggregate", "streaming")
    # every plan probes a hash join on the card; the semi/anti masks run
    # in all but Q11 and Q15 (no semi join, a scalar subquery); Q18
    # streams its IN subquery's GROUP BY
    inputs = {label: (["join"] if label in ("q11", "q15") else
                      ["join", "semi"]) + (["streaming"] if label == "q18"
                                           else [])
              for label in SQL_QUERIES}

    def compare(label, rows):
        key = _by(*[(c, False) for c in SQL_ORDER_COLUMNS[label]])[0]
        rows_match_limit(rows, want[label], key, label)

    out = run_paths(runner, SQL_QUERIES, card, scale, modules, compare, spy,
                    inputs, SEMI_MUST_LAUNCH,
                    lambda sql: scanned_rows(runner, scale, sql))
    spy.restore()
    return out


# --------------------------------------------------------------------------
# phase 6: TPC-DS on the card against sqlite3 and numpy oracles
# --------------------------------------------------------------------------

# BASELINE.md's config 5 (Q72, Q95), then the window queries, in the order
# phase 6 runs them; the SQL is the suite's (tests/tpcds_suite)
DS_QUERIES = ("q72", "q95", "q98", "q51", "q47", "q44", "q67")
DS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "tpcds_suite")


# Three predicates of the suite's text select no row of this generator at
# any scale: its d_month_seq counts months from 1990 (0..155) where the
# TPC-DS spec counts from 1900, so Q51's and Q67's months 1200..1211 become
# 108..119 (1999); and ss_addr_sk is never NULL, so Q44's threshold (the
# average over store 4's sales without an address) is taken over its sales
# with one.  Phase 6 runs the suite's text with these replacements, its
# oracles the same
DS_VARIANTS = {
    "q51": [("BETWEEN 1200 AND (1200 + 11)", "BETWEEN 108 AND (108 + 11)")],
    "q67": [("BETWEEN 1200 AND (1200 + 11)", "BETWEEN 108 AND (108 + 11)")],
    "q44": [('("ss_addr_sk" IS NULL)', '("ss_addr_sk" IS NOT NULL)')],
}


def ds_sql(label: str) -> str:
    with open(os.path.join(DS_DIR, f"{label}.sql")) as f:
        sql = f.read()
    for old, new in DS_VARIANTS.get(label, ()):
        if old not in sql:
            raise AssertionError(f"{label}: no {old!r} in the suite's text")
        sql = sql.replace(old, new)
    return sql


def ds_columns(scale: float, table: str, names):
    """The tpcds generator's columns of ``table`` on the host: {name:
    (values, valid or None, type)}, dictionary codes decoded to str."""
    import numpy as np

    from presto_tpu_torch.batch import concat_batches
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    conn = TpcdsConnector(scale=scale)
    handle = conn.get_table(table)
    batches = [b for s in conn.get_splits(handle, 1)
               for b in conn.page_source(s, names, 1 << 25)]
    b = concat_batches(batches) if len(batches) > 1 else batches[0]
    out = {}
    for name, c in zip(names, b.columns):
        v = np.asarray(c.values)[:b.num_rows]
        if c.dictionary is not None:
            v = np.asarray(c.dictionary.values, dtype=object)[v]
        valid = None if c.valid is None else np.asarray(c.valid)[:b.num_rows]
        out[name] = (v, valid, c.type)
    return out


# the columns the sqlite oracles read, and the indexes that keep sqlite's
# nested-loop joins off full scans
DS_SQLITE_TABLES = {
    "date_dim": ["d_date_sk", "d_date", "d_year", "d_moy", "d_qoy",
                 "d_month_seq"],
    "item": ["i_item_sk", "i_item_id", "i_item_desc", "i_category",
             "i_class", "i_current_price", "i_brand", "i_product_name"],
    "store": ["s_store_sk", "s_store_name", "s_company_name", "s_store_id"],
    "customer_address": ["ca_address_sk", "ca_state"],
    "web_site": ["web_site_sk", "web_company_name"],
    "web_returns": ["wr_order_number"],
    "web_sales": ["ws_order_number", "ws_warehouse_sk", "ws_ship_date_sk",
                  "ws_ship_addr_sk", "ws_web_site_sk", "ws_ext_ship_cost",
                  "ws_net_profit", "ws_item_sk", "ws_sold_date_sk",
                  "ws_sales_price"],
    "store_sales": ["ss_item_sk", "ss_sold_date_sk", "ss_store_sk",
                    "ss_sales_price", "ss_ext_sales_price", "ss_net_profit",
                    "ss_addr_sk", "ss_quantity"],
}
DS_SQLITE_INDEXES = [
    ("date_dim", "d_date_sk"), ("date_dim", "d_date"),
    ("date_dim", "d_month_seq"), ("item", "i_item_sk"),
    ("store", "s_store_sk"), ("customer_address", "ca_address_sk"),
    ("web_site", "web_site_sk"), ("web_returns", "wr_order_number"),
    ("web_sales", "ws_order_number"), ("web_sales", "ws_sold_date_sk"),
    ("web_sales", "ws_ship_date_sk"), ("store_sales", "ss_sold_date_sk"),
    ("store_sales", "ss_store_sk"),
]


def ds_sqlite(scale: float):
    """An in-memory sqlite3 database filled from the generator's columns
    (DATE as ISO text, DOUBLE as REAL, NULL where a value is invalid)."""
    import sqlite3

    import numpy as np

    db = sqlite3.connect(":memory:")
    for table, names in DS_SQLITE_TABLES.items():
        cols = ds_columns(scale, table, names)
        lists, decl = [], []
        for n in names:
            v, valid, typ = cols[n]
            if typ.name == "date":
                v = (np.datetime64("1970-01-01")
                     + v.astype("timedelta64[D]")).astype(str)
            lst = v.tolist()
            if valid is not None:
                lst = [x if ok else None for x, ok in zip(lst,
                                                          valid.tolist())]
            lists.append(lst)
            kind = ("TEXT" if typ.name in ("varchar", "char", "date")
                    else "REAL" if typ.name in ("double", "real", "decimal")
                    else "INTEGER")
            decl.append(f"{n} {kind}")
        db.execute(f"create table {table} ({', '.join(decl)})")
        db.executemany(f"insert into {table} values "
                       f"({', '.join('?' * len(names))})", zip(*lists))
    for table, col in DS_SQLITE_INDEXES:
        db.execute(f"create index ix_{table}_{col} on {table}({col})")
    db.commit()
    return db


_Q67_KEYS = ["i_category", "i_class", "i_brand", "i_product_name",
             "d_year", "d_qoy", "d_moy", "s_store_id"]

# each query in sqlite's dialect, with the suite's semantics: DATE
# arithmetic on ISO text, DECIMAL literals as REAL, Q51's FULL JOIN as a
# LEFT JOIN and an anti join, Q67's ROLLUP as its nine grouping levels,
# Q95's self-join on order numbers as the orders with two warehouses.
# No LIMIT: the comparison takes the ORDER BY in Python (NULLs last) and
# compares the rows a LIMIT cuts from a run of ties as a subset
DS_ORACLE_SQL = {
    "q95": """
WITH wh2 AS (
  SELECT ws_order_number FROM web_sales GROUP BY ws_order_number
  HAVING count(DISTINCT ws_warehouse_sk) > 1)
SELECT count(DISTINCT ws1.ws_order_number), sum(ws_ext_ship_cost),
       sum(ws_net_profit)
FROM web_sales ws1, date_dim, customer_address, web_site
WHERE d_date BETWEEN '1999-02-01' AND '1999-04-02'
  AND ws1.ws_ship_date_sk = d_date_sk
  AND ws1.ws_ship_addr_sk = ca_address_sk AND ca_state = 'IL'
  AND ws1.ws_web_site_sk = web_site_sk AND web_company_name = 'pri'
  AND ws1.ws_order_number IN (SELECT ws_order_number FROM wh2)
  AND ws1.ws_order_number IN (SELECT wr_order_number FROM web_returns
                              WHERE wr_order_number IN wh2)""",
    "q98": """
SELECT i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price),
       sum(ss_ext_sales_price) * 100
         / sum(sum(ss_ext_sales_price)) OVER (PARTITION BY i_class)
FROM store_sales, item, date_dim
WHERE ss_item_sk = i_item_sk AND i_category IN ('Sports', 'Books', 'Home')
  AND ss_sold_date_sk = d_date_sk
  AND d_date BETWEEN '1999-02-22' AND '1999-03-24'
GROUP BY i_item_id, i_item_desc, i_category, i_class, i_current_price""",
    "q51": ["""
CREATE TEMP TABLE web_v1 AS
  SELECT ws_item_sk item_sk, d_date,
         sum(sum(ws_sales_price)) OVER (PARTITION BY ws_item_sk
           ORDER BY d_date ROWS BETWEEN UNBOUNDED PRECEDING
           AND CURRENT ROW) cume_sales
  FROM web_sales, date_dim
  WHERE ws_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 108 AND 119
    AND ws_item_sk IS NOT NULL
  GROUP BY ws_item_sk, d_date""", """
CREATE TEMP TABLE store_v1 AS
  SELECT ss_item_sk item_sk, d_date,
         sum(sum(ss_sales_price)) OVER (PARTITION BY ss_item_sk
           ORDER BY d_date ROWS BETWEEN UNBOUNDED PRECEDING
           AND CURRENT ROW) cume_sales
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_month_seq BETWEEN 108 AND 119
    AND ss_item_sk IS NOT NULL
  GROUP BY ss_item_sk, d_date""",
        "CREATE INDEX ix_web_v1 ON web_v1(item_sk, d_date)",
        "CREATE INDEX ix_store_v1 ON store_v1(item_sk, d_date)", """
WITH j AS (
  SELECT web.item_sk w_item, web.d_date w_date, web.cume_sales web_sales,
         store.item_sk s_item, store.d_date s_date,
         store.cume_sales store_sales
  FROM web_v1 web LEFT JOIN store_v1 store
    ON web.item_sk = store.item_sk AND web.d_date = store.d_date
  UNION ALL
  SELECT NULL, NULL, NULL, store.item_sk, store.d_date, store.cume_sales
  FROM store_v1 store LEFT JOIN web_v1 web
    ON web.item_sk = store.item_sk AND web.d_date = store.d_date
  WHERE web.item_sk IS NULL)
SELECT * FROM (
  SELECT item_sk, d_date, web_sales, store_sales,
         max(web_sales) OVER (PARTITION BY item_sk ORDER BY d_date
           ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) web_cumulative,
         max(store_sales) OVER (PARTITION BY item_sk ORDER BY d_date
           ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
           store_cumulative
  FROM (SELECT CASE WHEN w_item IS NOT NULL THEN w_item ELSE s_item END
                 item_sk,
               CASE WHEN w_date IS NOT NULL THEN w_date ELSE s_date END
                 d_date,
               web_sales, store_sales FROM j) x) y
WHERE web_cumulative - store_cumulative
      > -1e-9 * abs(store_cumulative)"""],
    "q47": ["""
CREATE TEMP TABLE v1 AS
  SELECT i_category, i_brand, s_store_name, s_company_name, d_year, d_moy,
         sum(ss_sales_price) sum_sales,
         avg(sum(ss_sales_price)) OVER (PARTITION BY i_category, i_brand,
           s_store_name, s_company_name, d_year) avg_monthly_sales,
         rank() OVER (PARTITION BY i_category, i_brand, s_store_name,
           s_company_name ORDER BY d_year, d_moy) rn
  FROM item, store_sales, date_dim, store
  WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
    AND ss_store_sk = s_store_sk
    AND (d_year = 1999 OR (d_year = 1998 AND d_moy = 12)
         OR (d_year = 2000 AND d_moy = 1))
  GROUP BY i_category, i_brand, s_store_name, s_company_name, d_year,
           d_moy""",
        "CREATE INDEX ix_v1 ON v1(i_category, i_brand, s_store_name, "
        "s_company_name, rn)", """
SELECT v1.i_category, v1.i_brand, v1.s_store_name, v1.s_company_name,
       v1.d_year, v1.d_moy, v1.avg_monthly_sales, v1.sum_sales,
       v1_lag.sum_sales psum, v1_lead.sum_sales nsum
FROM v1, v1 v1_lag, v1 v1_lead
WHERE v1.i_category = v1_lag.i_category
  AND v1.i_category = v1_lead.i_category
  AND v1.i_brand = v1_lag.i_brand AND v1.i_brand = v1_lead.i_brand
  AND v1.s_store_name = v1_lag.s_store_name
  AND v1.s_store_name = v1_lead.s_store_name
  AND v1.s_company_name = v1_lag.s_company_name
  AND v1.s_company_name = v1_lead.s_company_name
  AND v1.rn = v1_lag.rn + 1 AND v1.rn = v1_lead.rn - 1
  AND v1.d_year = 1999 AND v1.avg_monthly_sales > 0
  AND abs(v1.sum_sales - v1.avg_monthly_sales) / v1.avg_monthly_sales
      > 0.1"""],
    "q44": """
WITH ranked AS (
  SELECT ss_item_sk item_sk, avg(ss_net_profit) rank_col
  FROM store_sales WHERE ss_store_sk = 4 GROUP BY ss_item_sk
  HAVING avg(ss_net_profit) > 0.9 * (
    SELECT avg(ss_net_profit) FROM store_sales
    WHERE ss_store_sk = 4 AND ss_addr_sk IS NOT NULL
    GROUP BY ss_store_sk)),
asceding AS (
  SELECT * FROM (SELECT item_sk, rank() OVER (ORDER BY rank_col ASC) rnk
                 FROM ranked) WHERE rnk < 11),
descending AS (
  SELECT * FROM (SELECT item_sk, rank() OVER (ORDER BY rank_col DESC) rnk
                 FROM ranked) WHERE rnk < 11)
SELECT asceding.rnk, i1.i_product_name, i2.i_product_name
FROM asceding, descending, item i1, item i2
WHERE asceding.rnk = descending.rnk AND i1.i_item_sk = asceding.item_sk
  AND i2.i_item_sk = descending.item_sk""",
    "q67": """
WITH base AS (
  SELECT i_category, i_class, i_brand, i_product_name, d_year, d_qoy,
         d_moy, s_store_id, coalesce(ss_sales_price * ss_quantity, 0) v
  FROM store_sales, date_dim, store, item
  WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
    AND ss_store_sk = s_store_sk AND d_month_seq BETWEEN 108 AND 119),
dw1 AS ({levels})
SELECT * FROM (
  SELECT *, rank() OVER (PARTITION BY i_category ORDER BY sumsales DESC) rk
  FROM dw1) WHERE rk <= 100""".replace("{levels}", "\n  UNION ALL\n  ".join(
        "SELECT " + ", ".join(_Q67_KEYS[:k] + [f"NULL {c}" for c in
                                                _Q67_KEYS[k:]])
        + ", sum(v) sumsales FROM base"
        + (" GROUP BY " + ", ".join(_Q67_KEYS[:k]) if k else "")
        for k in range(8, -1, -1))),
}


# each query's ORDER BY over its output row, as (key of a row, descending
# flags), and its LIMIT
DS_ORDER = {
    "q72": (_by((5, True), (0, False), (1, False), (2, False)), 100),
    "q95": (_by((0, False)), 100),
    "q98": (_by((2, False), (3, False), (0, False), (1, False),
                (6, False)), None),
    "q51": (_by((0, False), (1, False)), 100),
    "q47": ((lambda r: (r[7] - r[6], r[2]), [False, False]), 100),
    "q44": (_by((0, False)), 100),
    "q67": (_by(*[(c, False) for c in range(10)]), 100),
}


def presto_sorted(rows, key, desc):
    """Rows in ORDER BY order with NULLs last, ascending or descending."""
    import functools

    def cmp(a, b):
        for x, y, d in zip(key(a), key(b), desc):
            if x == y:
                continue
            if x is None:
                return 1
            if y is None:
                return -1
            return (-1 if x < y else 1) * (-1 if d else 1)
        return 0

    return sorted(rows, key=functools.cmp_to_key(cmp))


# rows an oracle returns that the port may leave out: Q51 keeps a row
# where web_cumulative > store_cumulative, two running float sums that
# are often the same cents added in another order, so a row whose two
# sums agree to 1e-9 may fall either side of the test (the oracle's SQL
# returns those rows too)
DS_OPTIONAL = {"q51": lambda r: abs(r[4] - r[5]) <= 1e-9 * abs(r[5])}


def rows_match_optional(got, want, optional, label: str, limit) -> None:
    """``want``: every oracle row in ORDER BY order (no ties), those that
    ``optional`` marks possibly absent from the port's rows.  The port's
    rows must be the oracle's in order, leaving out optional ones only,
    and cut at the LIMIT."""
    j = 0
    rest = []
    for i, w in enumerate(want):
        if j == len(got):
            rest = want[i:]
            break
        if _row_close(got[j], w):
            j += 1
        elif not optional(w):
            raise AssertionError(f"{label}: row {j} is {got[j]!r}, want "
                                 f"{w!r}")
    if j < len(got):
        raise AssertionError(f"{label}: row {j} {got[j]!r} is not the "
                             "oracle's")
    if len(got) < limit and not all(optional(w) for w in rest):
        raise AssertionError(f"{label}: {len(got)} rows, the oracle has "
                             "more")


def oracle_q72(scale: float):
    """TPC-DS Q72 in numpy: catalog sales of 1999 shipped more than five
    days after the sale, to 'D' bill-to demographics with buy potential
    '>10000', each met with the inventory of its item in its sale week
    holding fewer units than it sold; LEFT joins to promotion and to the
    catalog returns of the same item and order (each matching return
    repeats the row).  Counted by (item desc, warehouse, week)."""
    import numpy as np

    cs = ds_columns(scale, "catalog_sales", [
        "cs_sold_date_sk", "cs_ship_date_sk", "cs_bill_cdemo_sk",
        "cs_bill_hdemo_sk", "cs_item_sk", "cs_promo_sk", "cs_order_number",
        "cs_quantity"])
    dd = ds_columns(scale, "date_dim", ["d_date_sk", "d_date", "d_year",
                                        "d_week_seq"])
    hd = ds_columns(scale, "household_demographics",
                    ["hd_demo_sk", "hd_buy_potential"])
    cd = ds_columns(scale, "customer_demographics",
                    ["cd_demo_sk", "cd_marital_status"])
    it = ds_columns(scale, "item", ["i_item_sk", "i_item_desc"])
    wh = ds_columns(scale, "warehouse", ["w_warehouse_sk",
                                         "w_warehouse_name"])
    pr = ds_columns(scale, "promotion", ["p_promo_sk"])
    cr = ds_columns(scale, "catalog_returns", ["cr_item_sk",
                                               "cr_order_number"])
    inv = ds_columns(scale, "inventory", [
        "inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
        "inv_quantity_on_hand"])

    def v(t, n):
        return t[n][0]

    def ok(t, n):
        return (np.ones(len(t[n][0]), bool) if t[n][1] is None
                else t[n][1])

    def find(keys, valid, table, col):
        """Row of ``table`` whose ``col`` equals each key (-1: none)."""
        tk = v(table, col)
        order = np.argsort(tk, kind="stable")
        pos = np.clip(np.searchsorted(tk[order], keys), 0, len(tk) - 1)
        hit = valid & (tk[order][pos] == keys) & ok(table, col)[order][pos]
        return np.where(hit, order[pos], -1)

    live = np.ones(len(v(cs, "cs_item_sk")), bool)
    for n in ("cs_sold_date_sk", "cs_ship_date_sk", "cs_bill_cdemo_sk",
              "cs_bill_hdemo_sk", "cs_item_sk", "cs_quantity"):
        live &= ok(cs, n)
    d1 = find(v(cs, "cs_sold_date_sk"), live, dd, "d_date_sk")
    d3 = find(v(cs, "cs_ship_date_sk"), live, dd, "d_date_sk")
    h = find(v(cs, "cs_bill_hdemo_sk"), live, hd, "hd_demo_sk")
    c = find(v(cs, "cs_bill_cdemo_sk"), live, cd, "cd_demo_sk")
    i = find(v(cs, "cs_item_sk"), live, it, "i_item_sk")
    live &= (d1 >= 0) & (d3 >= 0) & (h >= 0) & (c >= 0) & (i >= 0)
    live &= v(dd, "d_year")[d1] == 1999
    live &= v(dd, "d_date")[d3] > v(dd, "d_date")[d1] + 5
    live &= v(hd, "hd_buy_potential")[h] == ">10000"
    live &= v(cd, "cd_marital_status")[c] == "D"
    rows = np.nonzero(live)[0]
    week = v(dd, "d_week_seq")[d1[rows]]

    # inventory by (item, week of its date), joined to warehouse and d2
    inv_ok = ok(inv, "inv_date_sk") & ok(inv, "inv_item_sk") \
        & ok(inv, "inv_warehouse_sk")
    d2 = find(v(inv, "inv_date_sk"), inv_ok, dd, "d_date_sk")
    w = find(v(inv, "inv_warehouse_sk"), inv_ok, wh, "w_warehouse_sk")
    inv_ok &= (d2 >= 0) & (w >= 0)
    inv_rows = np.nonzero(inv_ok)[0]
    ikey = (v(inv, "inv_item_sk")[inv_rows] << 20) \
        + v(dd, "d_week_seq")[d2[inv_rows]]
    order = np.argsort(ikey, kind="stable")
    ikey, inv_rows = ikey[order], inv_rows[order]
    ckey = (v(cs, "cs_item_sk")[rows] << 20) + week
    lo = np.searchsorted(ikey, ckey, "left")
    cnt = np.searchsorted(ikey, ckey, "right") - lo
    pair_cs = np.repeat(np.arange(len(rows)), cnt)
    pair_inv = inv_rows[np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
                        + np.arange(cnt.sum())]
    qty_ok = ok(inv, "inv_quantity_on_hand")[pair_inv] & (
        v(inv, "inv_quantity_on_hand")[pair_inv]
        < v(cs, "cs_quantity")[rows[pair_cs]])
    pair_cs, pair_inv = pair_cs[qty_ok], pair_inv[qty_ok]
    r = rows[pair_cs]

    promo = find(v(cs, "cs_promo_sk")[r], ok(cs, "cs_promo_sk")[r], pr,
                 "p_promo_sk") >= 0
    # catalog returns of the same (item, order): a row per match, or one
    rkey = v(cr, "cr_item_sk") * (1 << 32) + v(cr, "cr_order_number")
    rkey = np.sort(rkey[ok(cr, "cr_item_sk") & ok(cr, "cr_order_number")])
    qkey = v(cs, "cs_item_sk")[r] * (1 << 32) + v(cs, "cs_order_number")[r]
    mult = np.searchsorted(rkey, qkey, "right") - np.searchsorted(
        rkey, qkey, "left")
    if not np.all(ok(cs, "cs_order_number")[r]):
        mult = np.where(ok(cs, "cs_order_number")[r], mult, 0)
    mult = np.maximum(mult, 1)

    groups = {}
    desc = v(it, "i_item_desc")[i[r]]
    wname = v(wh, "w_warehouse_name")[w[pair_inv]]
    for k, (d, wn, wk, p, m) in enumerate(zip(
            desc.tolist(), wname.tolist(), week[pair_cs].tolist(),
            promo.tolist(), mult.tolist())):
        g = groups.setdefault((d, wn, wk), [0, 0, 0])
        g[0 if not p else 1] += m
        g[2] += m
    return [(d, wn, int(wk), n0, n1, n) for (d, wn, wk), (n0, n1, n)
            in groups.items()]


def ds_oracles(scale: float) -> dict:
    """Every phase-6 query's rows from its oracle, in ORDER BY order (all
    rows, before any LIMIT)."""
    import datetime as _dt

    want = {"q72": oracle_q72(scale)}
    db = ds_sqlite(scale)
    for label, sql in DS_ORACLE_SQL.items():
        # a list: statements that stage tables, then the query
        for stmt in sql[:-1] if isinstance(sql, list) else ():
            db.execute(stmt)
        rows = db.execute(sql[-1] if isinstance(sql, list)
                          else sql).fetchall()
        if label == "q51":
            rows = [(r[0], _dt.date.fromisoformat(r[1])) + tuple(r[2:])
                    for r in rows]
        want[label] = rows
    db.close()
    for label, rows in want.items():
        (key, desc), _limit = DS_ORDER[label]
        want[label] = presto_sorted(rows, key, desc)
    return want


def ds_phase(runner, scale: float, card: str, want: dict,
             modules) -> tuple:
    """Phase 6: the queries of ``DS_QUERIES`` (TPC-DS at ``scale``) on the
    card against their oracles (``ds_oracles``; ties in the ORDER BY
    compared as sets, and the rows a LIMIT cuts from a run of ties as a
    subset), through ``run_paths``; the joins' and the windows' inputs on
    cuda, and the window operator's and TopNRowNumber's host reads
    counted.  A query whose oracle has rows must return rows.  Returns
    the launches and kept inputs by path (``ds_<query>``)."""
    S, B2, H, J, G = modules
    from presto_tpu_torch.exec import streamagg as SA
    from presto_tpu_torch.ops import window as W

    spy = DeviceSpy()
    spy.wrap(H, "pages_hash_probe", "join")
    spy.wrap(J, "probe_counts", "join")
    spy.wrap(W, "segment_ids", "window")
    spy.count(W, "nonzero_host", "window")
    spy.count(W, "nonzero_index", "topn")
    spy.count(SA, "_read_host", "streaming")
    queries = {f"ds_{q}": ds_sql(q) for q in DS_QUERIES}
    inputs = {f"ds_{q}": ["join"] + (["window"] if q not in ("q72", "q95")
                                     else [])
              for q in DS_QUERIES}

    def compare(label, rows):
        q = label[3:]
        (key, _desc), limit = DS_ORDER[q]
        if want[q] and not rows:
            raise AssertionError(f"{label}: no row, the oracle has "
                                 f"{len(want[q])}")
        if q in DS_OPTIONAL:
            rows_match_optional(rows, want[q], DS_OPTIONAL[q], label, limit)
        else:
            rows_match_limit(rows, want[q], key, label, limit)

    out = run_paths(runner, queries, card, scale, modules, compare, spy,
                    inputs, {},
                    lambda sql: scanned_rows(runner, scale, sql))
    spy.restore()
    for q in DS_QUERIES:
        print("ds_oracle " + json.dumps({
            "query": f"ds_{q}", "oracle_rows": len(want[q]),
            "empty": not want[q]}), flush=True)
    return out



# --------------------------------------------------------------------------
# phase 7: tables on the card (the memory catalog)
# --------------------------------------------------------------------------

MEMORY_TABLES = ("lineitem", "orders", "customer")
# phase 3's queries over the memory copies (after ``USE memory``)
MEMORY_QUERIES = {"mem_q1": Q1, "mem_q6": Q6, "mem_q3": Q3}
RETURNED = "l_returnflag = 'R'"


def lineitem_facts(cols) -> dict:
    """What phase 7 checks of lineitem, from the generator's columns:
    its rows, the rows with l_returnflag 'R', and the statistics ANALYZE
    must give."""
    import numpy as np

    return {"rows": len(cols["l_orderkey"]),
            "returned": int((cols["l_returnflag"] == "R").sum()),
            "returnflag_ndv": len(set(cols["l_returnflag"].tolist())),
            "orderkey_ndv": len(np.unique(cols["l_orderkey"])),
            "shipdate": (str(int(cols["l_shipdate"].min())),
                         str(int(cols["l_shipdate"].max())))}


def host_syncs(fn):
    """``fn()`` under CUDA's sync debug mode: (its result, the
    synchronizing operations it made by the line of Python that made
    them, and how many of them were made while the expression evaluator
    copied a host array to the card).  The rest are the reads of the
    card."""
    import warnings

    import torch

    from presto_tpu_torch.expr import xp as X

    def syncs(warned):
        # not the warning that the debug mode itself is a prototype
        return [w for w in warned
                if "called a synchronizing" in str(w.message)]

    copy_syncs = []
    real = X.TorchXp.asarray
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def asarray(self, x, dtype=None):
            before = len(seen)
            out = real(self, x, dtype)
            copy_syncs.extend(syncs(seen[before:]))
            return out

        X.TorchXp.asarray = asarray
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            X.TorchXp.asarray = real
    sites = {}
    for w in syncs(seen):
        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    return out, sites, len(copy_syncs)


def host_copies(fn, to_card: bool = False):
    """``fn()``, and the element count of every card tensor it copied to
    the host (``Tensor.cpu``, ``.numpy``, ``.tolist``, ``.item``), or with
    ``to_card`` of every host tensor or array it copied to the card
    (``Tensor.to``, ``.cuda``, ``torch.as_tensor``)."""
    import torch

    if to_card:
        targets = [(torch.Tensor, "to"), (torch.Tensor, "cuda"),
                   (torch, "as_tensor")]
    else:
        targets = [(torch.Tensor, name)
                   for name in ("cpu", "numpy", "tolist", "item")]
    sizes = []
    undo = []
    for owner, name in targets:
        real = getattr(owner, name)

        def counted(src, *args, _real=real, **kwargs):
            out = _real(src, *args, **kwargs)
            on_card = isinstance(src, torch.Tensor) and src.is_cuda
            if not to_card and on_card:
                sizes.append(src.numel())
            elif (to_card and not on_card and isinstance(out, torch.Tensor)
                    and out.is_cuda):
                sizes.append(out.numel())
            return out

        setattr(owner, name, counted)
        undo.append((owner, name, real))
    try:
        out = fn()
    finally:
        for owner, name, real in reversed(undo):
            setattr(owner, name, real)
    return out, sizes


def memory_phase(runner, scale: float, card: str, want: dict, facts: dict,
                 tpch_warm: dict, modules) -> tuple:
    """Phase 7: lineitem, orders and customer copied into the memory
    catalog on the card by CTAS, then phase 3's Q1, Q6 and Q3 over them
    (``run_paths``, each against phase 3's oracle; Q1 must launch B1),
    INSERT, DELETE and ROLLBACK, ANALYZE and the blackhole sink, each
    against numpy's facts of the generator's columns.  Returns the
    launches and kept inputs by path."""
    import torch

    from presto_tpu_torch.connectors.tpch import TpchConnector

    S, B2, H, J, G = modules
    mem = runner.registry.get("memory")
    gen = TpchConnector(scale=scale)
    for table in MEMORY_TABLES:
        res, wall = timed(runner, f"create table memory.{table} as "
                                  f"select * from tpch.{table}")
        # the generator's lineitem has 1 to 7 lines an order: numpy's
        # count; the other two tables' counts are their exact SF sizes
        rows = (facts["rows"] if table == "lineitem" else
                int(gen.table_statistics(gen.get_table(table)).row_count))
        if res.rows != [(rows,)]:
            raise AssertionError(f"CTAS {table}: {res.rows}, want {rows}")
        batches = mem.tables[table].batches
        bad = [b for b in batches
               if b.device.type != "cuda" or b.capacity != b.num_rows]
        if bad or sum(b.num_rows for b in batches) != rows:
            raise AssertionError(f"memory.{table}: {len(bad)} batches off "
                                 "the card or padded")
        print("ctas " + json.dumps({
            "table": table, "rows": rows, "wall_s": wall,
            "rows_per_s": rows / wall, "batches": len(batches),
            "bytes_on_card": sum(b.size_bytes for b in batches),
            "card": card}), flush=True)

    runner.execute("use memory")
    spy = DeviceSpy()
    spy.wrap(G, "direct_grouped_aggregate", "q1")
    spy.wrap(G, "global_aggregate", "q6")
    spy.wrap(H, "pages_hash_probe", "join")
    spy.wrap(J, "probe_counts", "join")

    def compare(label, rows):
        rows_match(rows, want[label[len("mem_"):]], label)

    warm = {}
    out = run_paths(runner, MEMORY_QUERIES, card, scale, modules, compare,
                    spy, {"mem_q1": ["q1"], "mem_q6": ["q6"],
                          "mem_q3": ["join"]}, {"mem_q1": ("b1",)},
                    lambda sql: scanned_rows(runner, scale, sql), warm)
    spy.restore()
    print("memory_vs_tpch " + json.dumps({
        label: {"memory_warm_s": w, "tpch_warm_s": tpch_warm[label[4:]]}
        for label, w in warm.items()} | {"card": card}), flush=True)

    # INSERT, DELETE, ROLLBACK
    n_ret = facts["returned"]
    res = runner.execute("insert into memory.lineitem select * from "
                         f"tpch.lineitem where {RETURNED}")
    if res.rows != [(n_ret,)]:
        raise AssertionError(f"INSERT wrote {res.rows}, want {n_ret}")
    stored = len(mem.tables["lineitem"].batches)
    t0 = time.perf_counter()
    res, sites, copies = host_syncs(lambda: runner.execute(
        f"delete from memory.lineitem where {RETURNED}"))
    delete_s = time.perf_counter() - t0
    syncs = sum(sites.values())
    if res.rows != [(2 * n_ret,)]:
        raise AssertionError(f"DELETE removed {res.rows}, want {2 * n_ret}")
    if syncs - copies > stored:
        raise AssertionError(f"DELETE read the card {syncs - copies} times "
                             f"for {stored} stored batches")
    rows_match(runner.execute(Q1).rows,
               [r for r in want["q1"] if r[0] != "R"], "mem_q1 after DELETE")
    before = runner.execute("select count(*) from memory.orders").rows
    runner.execute("start transaction")
    staged = runner.execute("insert into memory.orders select * from "
                            "tpch.orders").rows
    runner.execute("rollback")
    after = runner.execute("select count(*) from memory.orders").rows
    if after != before or staged != before:
        raise AssertionError(f"ROLLBACK: {before} -> {after}, staged "
                             f"{staged}")
    # the returned rows back, so the table holds the generator's rows
    runner.execute("insert into memory.lineitem select * from "
                   f"tpch.lineitem where {RETURNED}")
    print("dml " + json.dumps({
        "inserted": n_ret, "deleted": 2 * n_ret, "delete_s": delete_s,
        "stored_batches": stored, "delete_syncs": syncs,
        "delete_copy_syncs": copies, "delete_host_reads": syncs - copies,
        "delete_sync_sites": sites,
        "rollback_rows": after[0][0], "card": card}), flush=True)

    # ANALYZE
    t0 = time.perf_counter()
    _, sizes = host_copies(lambda: runner.execute(
        "analyze memory.lineitem"))
    analyze_s = time.perf_counter() - t0
    largest_dictionary = max(
        len(c.dictionary) for c in mem.tables["lineitem"].batches[0].columns
        if c.dictionary is not None)
    if max(sizes, default=0) > largest_dictionary:
        raise AssertionError(f"ANALYZE copied {max(sizes)} values to the "
                             "host")
    stats = {r[0]: r for r in runner.execute(
        "show stats for memory.lineitem").rows}
    got = {"rows": int(stats[None][4]),
           "returnflag_ndv": int(stats["l_returnflag"][2]),
           "orderkey_ndv": int(stats["l_orderkey"][2]),
           "shipdate": tuple(stats["l_shipdate"][5:7])}
    wanted = {k: facts[k] for k in got}
    if got != wanted or got["returnflag_ndv"] != 3:
        raise AssertionError(f"SHOW STATS {got}, numpy {wanted}")
    print("analyze " + json.dumps({
        "stats": got, "analyze_s": analyze_s,
        "largest_host_copy": max(sizes, default=0),
        "card": card}), flush=True)

    # the write path with no storage
    res, wall = timed(runner, "create table blackhole.sink as select * "
                              "from tpch.lineitem")
    swallowed = runner.registry.get("blackhole").rows_swallowed["sink"]
    scanned = runner.execute("select count(*) from blackhole.sink").rows
    if res.rows != [(facts["rows"],)] or swallowed != facts["rows"] or \
            scanned != [(0,)]:
        raise AssertionError(f"blackhole: {res.rows}, {swallowed}, "
                             f"{scanned}")
    print("blackhole " + json.dumps({
        "rows": facts["rows"], "wall_s": wall,
        "rows_per_s": facts["rows"] / wall, "card": card}), flush=True)
    runner.execute("use tpch")
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------
# phase 8: the rest of the single-node statements, and the sketches
# --------------------------------------------------------------------------

# Q3 with its segment and its two dates as parameters, and the EXECUTE
# that binds the spec's validation values
Q3_PREPARED = (Q3.replace("'BUILDING'", "?")
               .replace("date '1995-03-15'", "?"))
EXEC_Q3 = ("execute q3 using 'BUILDING', date '1995-03-15', "
           "date '1995-03-15'")
Q3_OUTPUT = [("l_orderkey", "bigint"), ("revenue", "double"),
             ("o_orderdate", "date"), ("o_shippriority", "bigint")]
SKETCH_GROUPED = ("select o_orderpriority, approx_distinct(o_custkey), "
                  "approx_percentile(o_totalprice, 0.5) from orders "
                  "group by 1")
SKETCH_GLOBAL = "select approx_distinct(l_orderkey) from lineitem"
# HLL's standard error with 2^11 registers (sketch.py), and the rank
# bound of a KLL quantile (tests/test_kll.py)
HLL_STD_ERR = 0.023
KLL_RANK_BOUND = 0.02
CATALOGS = ["blackhole", "information_schema", "memory", "system", "tpcds",
            "tpch"]


def analyze_ops(lines):
    """[(operator, input rows, output rows)] of an EXPLAIN ANALYZE text's
    operator table."""
    import re

    out = []
    for line in lines:
        m = re.match(r"(\S+)\s+(\d+)\s+(\d+)\s+[\d.]+\s+[\d.]+\s+[\d.]+"
                     r"\s+\d+\s+\d+\s+\d+$", line)
        if m:
            out.append((m.group(1), int(m.group(2)), int(m.group(3))))
    return out


def task_ops(runner):
    return [(s.operator, s.input_rows, s.output_rows)
            for s in runner._last_task.operator_stats]


def sketch_oracle(scale: float) -> dict:
    """From the generator's orders columns: per priority, the exact
    distinct count of o_custkey and the sorted o_totalprice."""
    import numpy as np

    cols = table_columns(scale, "orders", ["o_orderpriority", "o_custkey",
                                           "o_totalprice"])
    out = {}
    for prio in sorted(set(cols["o_orderpriority"].tolist())):
        mask = cols["o_orderpriority"] == prio
        out[prio] = (len(np.unique(cols["o_custkey"][mask])),
                     np.sort(cols["o_totalprice"][mask]))
    return out


def check_sketches(rows, oracle: dict, orderkey_ndv: int, label: str):
    """Each estimate within 3 standard errors of the exact count, each
    median's rank error under the KLL bound: the worst of each."""
    import numpy as np

    grouped, (global_row,) = rows
    if sorted(r[0] for r in grouped) != sorted(oracle):
        raise AssertionError(f"{label}: groups {grouped}")
    worst_hll, worst_rank = 0.0, 0.0
    for prio, ad, p50 in grouped:
        exact, prices = oracle[prio]
        worst_hll = max(worst_hll, abs(ad - exact) / exact)
        lo = np.searchsorted(prices, p50, "left") / len(prices)
        hi = np.searchsorted(prices, p50, "right") / len(prices)
        worst_rank = max(worst_rank, max(lo - 0.5, 0.5 - hi, 0.0))
    worst_hll = max(worst_hll,
                    abs(global_row[0] - orderkey_ndv) / orderkey_ndv)
    if worst_hll > 3 * HLL_STD_ERR or worst_rank >= KLL_RANK_BOUND:
        raise AssertionError(f"{label}: HLL error {worst_hll}, KLL rank "
                             f"error {worst_rank}")
    return worst_hll, worst_rank


def statements_phase(runner, scale: float, card: str, want: dict,
                     facts: dict, tpch_warm: dict, q_launches: dict,
                     modules) -> tuple:
    """Phase 8 on phase 3's runner: the system and information_schema
    catalogs, a view of Q1 and an EXECUTE of a prepared Q3 (``run_paths``
    against phase 3's oracles, as ``view_q1`` and ``exec_q3``), EXPLAIN
    ANALYZE of Q1 and Q3 against a plain run's task stats (``ea_q1``,
    ``ea_q3``), the sketch aggregates at ``scale`` against numpy's exact
    counts and the CPU runner's bits, and GRANT/REVOKE and kill_query.
    Returns the launches and kept inputs by path."""
    import torch

    from presto_tpu_torch import events as ev
    from presto_tpu_torch import native
    from presto_tpu_torch.connectors import system as SY
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.localrunner import LocalQueryRunner
    from presto_tpu_torch.session import GrantAwareAccessControl, Session

    S, B2, H, J, G = modules

    # 1. the catalogs, their batches built on the card
    devices = []
    real_iter = SY._RowsPageSource.__iter__

    def spy_iter(self):
        for b in real_iter(self):
            devices.append(b.device)
            yield b

    SY._RowsPageSource.__iter__ = spy_iter
    try:
        gen = TpchConnector(scale=scale)
        n_columns = sum(len(gen.table_schema(gen.get_table(t)).columns)
                        for t in gen.list_tables())
        res_cat, wall_cat = timed(runner, "show catalogs")
        res_cols, wall_cols = timed(
            runner, "select count(*) from information_schema.columns "
                    "where table_catalog = 'tpch'")
        res_nodes, wall_nodes = timed(runner, "select * from system.nodes")
    finally:
        SY._RowsPageSource.__iter__ = real_iter
    if [r[0] for r in res_cat.rows] != CATALOGS:
        raise AssertionError(f"SHOW CATALOGS: {res_cat.rows}")
    if res_cols.rows != [(n_columns,)] or n_columns != 61:
        raise AssertionError(f"information_schema.columns: "
                             f"{res_cols.rows}, generator {n_columns}")
    if res_nodes.rows != [("local", "local://", "dev", True, "ACTIVE")]:
        raise AssertionError(f"system.nodes: {res_nodes.rows}")
    if len(devices) != 2 or any(d.type != "cuda" for d in devices):
        raise AssertionError(f"catalog batches on {devices}")
    print("catalogs " + json.dumps({
        "show_catalogs_s": wall_cat, "catalogs": len(res_cat.rows),
        "columns_s": wall_cols, "tpch_columns": n_columns,
        "nodes_s": wall_nodes, "batch_devices": sorted(
            {str(d) for d in devices}), "card": card}), flush=True)

    # 2. and 3. a view of Q1; an EXECUTE of Q3 prepared with parameters
    runner.execute("create view tpch.v_q1 as " + Q1)
    runner.execute("prepare q3 from " + Q3_PREPARED)
    described = runner.execute("describe output q3").rows
    if described != Q3_OUTPUT:
        raise AssertionError(f"DESCRIBE OUTPUT q3: {described}")
    spy = DeviceSpy()
    spy.wrap(G, "direct_grouped_aggregate", "q1")
    spy.wrap(H, "pages_hash_probe", "join")
    spy.wrap(J, "probe_counts", "join")

    def compare(label, rows):
        rows_match(rows, want[{"view_q1": "q1", "exec_q3": "q3"}[label]],
                   label)

    def scanned(sql):
        return scanned_rows(runner, scale, Q3 if sql == EXEC_Q3 else sql)

    launches, kept = run_paths(
        runner, {"view_q1": "select * from v_q1", "exec_q3": EXEC_Q3},
        card, scale, modules, compare, spy,
        {"view_q1": ["q1"], "exec_q3": ["join"]}, {"view_q1": ("b1",)},
        scanned)
    spy.restore()
    runner.execute("drop view v_q1")
    runner.execute("deallocate prepare q3")
    for label, q in (("view_q1", "q1"), ("exec_q3", "q3")):
        if launches[label] != q_launches[q]:
            raise AssertionError(f"{label} launched {launches[label]}, "
                                 f"{q} {q_launches[q]}")

    # 4. EXPLAIN ANALYZE of Q1 and Q3 against a plain run's task stats
    keep = PathInputs()
    for label, sql in (("ea_q1", Q1), ("ea_q3", Q3)):
        q = label[3:]
        counts = []
        for text in (sql, "explain analyze " + sql):
            S.LAUNCHES.reset()
            B2.INSERT_LAUNCHES.reset()
            B2.LOOKUP_LAUNCHES.reset()
            res, wall = timed(runner, text)
            counts.append({"b1": S.LAUNCHES.count,
                           "insert": B2.INSERT_LAUNCHES.count,
                           "lookup": B2.LOOKUP_LAUNCHES.count})
            if text == sql:
                rows_match(res.rows, want[q], label)
                plain, plain_wall = sorted(task_ops(runner)), wall
        launches[label] = counts[1]
        ops = analyze_ops([r[0] for r in res.rows])
        outputs = [o for o in ops if o[0].endswith("OutputCollector")]
        if sorted(ops) != plain or sorted(task_ops(runner)) != plain:
            raise AssertionError(f"{label}: operators {ops}, plain {plain}")
        if len(outputs) != 1 or outputs[0][1] != len(want[q]):
            raise AssertionError(f"{label}: output {outputs}")
        if counts[1] != counts[0]:
            raise AssertionError(f"{label} launched {counts[1]}, plain "
                                 f"{counts[0]}")
        # one more run that no wall reads keeps the kernels' inputs
        keep.wrap(G, "direct_segment_sums", "b1")
        keep.wrap(B2, "insert_claims", "insert")
        keep.wrap(B2, "insert_claims", "insert_loaded", insert_load)
        keep.wrap(B2, "lookup_ranges", "lookup")
        runner.execute("explain analyze " + sql)
        keep.restore()
        kept[label] = keep.take()
        print("explain_analyze " + json.dumps({
            "query": q, "wall_s": wall, "plain_s": plain_wall,
            "plain_warm_s": tpch_warm[q], "operators": len(ops),
            "output_rows": outputs[0][1], "launches": counts[1],
            "card": card}), flush=True)

    # 5. the sketches: numpy's exact counts, the same bits on two runs,
    # and the CPU runner's bits; one feed thread on both sides, so KLL
    # compacts in the same order
    if not native.available():
        raise AssertionError("xxh64 did not build with g++ on this host")
    oracle = sketch_oracle(scale)
    cpu = LocalQueryRunner.tpch(scale=scale, device="cpu")
    sketch_sql = {"grouped": SKETCH_GROUPED, "global": SKETCH_GLOBAL}
    scanned = {"grouped": int(1_500_000 * scale), "global": facts["rows"]}
    walls, results = {}, []
    for r in (runner, cpu):
        r.execute("set session task_concurrency = 1")
    for _ in range(2):
        rows = []
        for key, sql in sketch_sql.items():
            res, wall = timed(runner, sql)
            walls.setdefault(key, []).append(wall)
            rows.append(sorted(res.rows))
        results.append(rows)
    t0 = time.perf_counter()
    cpu_rows = [sorted(cpu.execute(sql).rows) for sql in sketch_sql.values()]
    cpu_s = time.perf_counter() - t0
    runner.execute("reset session task_concurrency")
    if results[1] != results[0] or cpu_rows != results[0]:
        raise AssertionError(f"sketch bits: {results}, CPU {cpu_rows}")
    worst_hll, worst_rank = check_sketches(results[0], oracle,
                                           facts["orderkey_ndv"], "sketch")
    for i, key in enumerate(sketch_sql):
        print("sketch " + json.dumps({
            "query": key, "rows": scanned[key],
            "result_rows": len(results[0][i]),
            "cold_s": walls[key][0], "warm_s": walls[key][1],
            "warm_rows_per_s": scanned[key] / walls[key][1],
            "xxh64_native": native.available(), "card": card}), flush=True)
    print("sketch_check " + json.dumps({
        "hll_worst_rel_err": worst_hll, "hll_limit": 3 * HLL_STD_ERR,
        "kll_worst_rank_err": worst_rank, "kll_limit": KLL_RANK_BOUND,
        "cpu_equal": True, "cpu_s": cpu_s, "card": card}), flush=True)
    del cpu

    # 6. GRANT/REVOKE under a GrantAwareAccessControl runner; kill_query
    ac = GrantAwareAccessControl()
    admin = LocalQueryRunner.tpch(scale=scale, access_control=ac,
                                  session=Session(user="admin"))
    bob = LocalQueryRunner(admin.registry, "tpch", admin.config,
                           session=Session(user="bob"), access_control=ac)
    admin.execute("create table memory.sec as select * from tpch.nation")
    outcomes = []
    for who, sql in ((bob, "select count(*) from memory.sec"),
                     (admin, "grant select on memory.sec to bob"),
                     (bob, "select count(*) from memory.sec"),
                     (admin, "revoke select on memory.sec from bob"),
                     (bob, "select count(*) from memory.sec")):
        try:
            outcomes.append(who.execute(sql).rows)
        except PermissionError:
            outcomes.append("denied")
    if outcomes[::2] != ["denied", [(25,)], "denied"]:
        raise AssertionError(f"GRANT/REVOKE: {outcomes}")

    class Killed(ev.EventListener):
        def __init__(self):
            self.events = []

        def query_killed(self, event):
            self.events.append(event)

    rec = Killed()
    runner.event_bus.register(rec)
    res = runner.execute("call system.runtime.kill_query('local-1', "
                         "'phase 8')")
    runner.event_bus.listeners.remove(rec)
    if (res.rows != [("killed",)] or len(rec.events) != 1
            or rec.events[0].error_name != "ADMINISTRATIVELY_KILLED"
            or rec.events[0].query_id != "local-1"):
        raise AssertionError(f"kill_query: {res.rows}, {rec.events}")
    print("access " + json.dumps({
        "grant_revoke": [o if o == "denied" else o[0][0]
                         for o in outcomes[::2]],
        "killed": rec.events[0].query_id,
        "error_name": rec.events[0].error_name,
        "message": rec.events[0].message, "card": card}), flush=True)
    torch.cuda.synchronize()
    return launches, kept


# --------------------------------------------------------------------------
# phase 9: nested types (UNNEST, split, the collect aggregates, the
# row-state statistics) and checksum on the card
# --------------------------------------------------------------------------

# one month of orders for the collected arrays and maps (about 19,000
# orders at SF1), so that the result stays a few MB
NESTED_MONTH = ((1995, 3, 1), (1995, 4, 1))
NESTED_QUERIES = {
    "nested_unnest": (
        "select o_orderpriority, count(*), sum(v), max(i) from orders "
        "cross join unnest(array[o_custkey, o_shippriority, o_orderkey]) "
        "with ordinality as t(v, i) group by o_orderpriority order by 1"),
    "nested_words": (
        "select w, count(*) from orders cross join unnest(split(o_comment, "
        "' ')) as t(w) group by w order by 2 desc, 1 limit 20"),
    "nested_collect": (
        "select o_orderpriority, array_agg(o_orderkey), map_agg(o_orderkey,"
        " o_custkey) from orders where o_orderdate >= date '1995-03-01' "
        "and o_orderdate < date '1995-04-01' group by o_orderpriority "
        "order by 1"),
    "nested_cardinality": (
        "select o_orderpriority, cardinality(array_agg(o_orderkey)), "
        "count(*) from orders group by o_orderpriority order by 1"),
    "nested_stats": (
        "select o_orderpriority, corr(o_totalprice, o_custkey), "
        "covar_samp(o_totalprice, o_custkey), covar_pop(o_totalprice, "
        "o_custkey), regr_slope(o_totalprice, o_custkey), "
        "regr_intercept(o_totalprice, o_custkey), min_by(o_orderkey, "
        "o_totalprice), max_by(o_orderkey, o_totalprice) from orders "
        "group by o_orderpriority order by 1"),
    "checksum": (
        "select checksum(l_orderkey), checksum(l_shipdate), "
        "checksum(l_returnflag) from lineitem"),
}
# a collected array's order, and the sums over one, follow the feed
# threads' arrival order: these paths are held to the oracle on every run
NESTED_ORDER_FREE = ("nested_collect", "nested_stats")
# the unnested rows GROUP BY the five priorities on the direct tier: B1
NESTED_MUST_LAUNCH = {"nested_unnest": ("b1",)}
# one checksum per flat type at SF0.01, against the CPU runner's
CHECKSUM_TYPES = (
    "select checksum(o_orderkey), checksum(cast(o_custkey as integer)), "
    "checksum(cast(o_custkey as smallint)), checksum(cast(o_shippriority "
    "as tinyint)), checksum(o_totalprice), checksum(cast(o_totalprice as "
    "real)), checksum(o_totalprice > 100000), checksum(o_orderdate), "
    "checksum(cast(o_orderdate as timestamp)), checksum(cast(o_totalprice "
    "as decimal(12,2))), checksum(o_orderpriority), "
    "checksum(nullif(o_custkey % 3, 0)) from orders")
# the tiny cases, against their literal answers
NESTED_SMALL = {
    "select t.id, u.v from (values (1, array[7]), (2, array[]), (3, "
    "cast(null as array(bigint)))) t(id, arr) left join unnest(t.arr) as "
    "u(v) on true order by t.id": [(1, 7), (2, None), (3, None)],
    "select t.id, u.o from (values (1, array[7]), (2, array[])) t(id, arr)"
    " left join unnest(t.arr) with ordinality as u(v, o) on true "
    "order by t.id": [(1, 1), (2, None)],
    "select * from unnest(array[1,2], array[])": [(1, None), (2, None)],
}
F64_EPS = 2.0 ** -53


def _stat_bound(n: int, my: float, slope: float, mx: float) -> float:
    """The float64 error bound of an intercept my - slope * mx from sums
    over n rows (each of its terms from an n-term sum: 2 n u of its
    magnitude), the tolerance where the intercept cancels toward 0."""
    return 2 * n * F64_EPS * (abs(my) + abs(slope * mx))


def nested_oracles(scale: float, batch_rows: int) -> dict:
    """Phase 9's oracles from the generator's columns, with numpy and
    Python (none of the port's operators): per priority, the unnested
    rows' count, sum and largest ordinality; the words of the comments
    by Python's ``str.split``; one month's order keys and key -> customer
    maps; the two-pass statistics and the keys at the least and greatest
    price; and the checksums as wrapping sums of the port's ``row_hash``
    run on the CPU over the generator's batches (a varchar's codes, as
    the engine hashes them)."""
    import collections

    import numpy as np
    import torch

    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.ops.hashing import row_hash

    o = table_columns(scale, "orders", [
        "o_orderkey", "o_custkey", "o_shippriority", "o_orderpriority",
        "o_comment", "o_orderdate", "o_totalprice"])
    prio = o["o_orderpriority"]
    keys = sorted(set(prio.tolist()))
    want = {"nested_unnest": [], "nested_cardinality": [],
            "nested_collect": [], "nested_stats": []}
    lo, hi = (_days(*d) for d in NESTED_MONTH)
    month = (o["o_orderdate"] >= lo) & (o["o_orderdate"] < hi)
    stats_extra = {}
    for p in keys:
        m = prio == p
        n = int(m.sum())
        total = int(o["o_custkey"][m].sum() + o["o_shippriority"][m].sum()
                    + o["o_orderkey"][m].sum())
        want["nested_unnest"].append((p, 3 * n, total, 3))
        want["nested_cardinality"].append((p, n, n))
        mm = m & month
        ok = o["o_orderkey"][mm].tolist()
        want["nested_collect"].append(
            (p, sorted(ok), dict(zip(ok, o["o_custkey"][mm].tolist()))))
        y = o["o_totalprice"][m].astype(np.float64)
        x = o["o_custkey"][m].astype(np.float64)
        mx, my = x.mean(), y.mean()
        dx, dy = x - mx, y - my
        cxy, cxx, cyy = (dx * dy).sum(), (dx * dx).sum(), (dy * dy).sum()
        slope = cxy / cxx
        okeys = o["o_orderkey"][m]
        want["nested_stats"].append((
            p, cxy / np.sqrt(cxx * cyy), cxy / (n - 1), cxy / n, slope,
            my - slope * mx, set(okeys[y == y.min()].tolist()),
            set(okeys[y == y.max()].tolist())))
        stats_extra[p] = _stat_bound(n, my, slope, mx)
    words = collections.Counter()
    for c in o["o_comment"].tolist():
        words.update(c.split(" "))
    want["nested_words"] = sorted(words.items(), key=lambda kv: (-kv[1],
                                                                 kv[0]))
    want["intercept_bound"] = stats_extra

    conn = TpchConnector(scale=scale)
    handle = conn.get_table("lineitem")
    names = ["l_orderkey", "l_shipdate", "l_returnflag"]
    sums = [0, 0, 0]
    for split in conn.get_splits(handle, 1):
        for b in conn.page_source(split, names, batch_rows):
            for i, c in enumerate(b.columns):
                v = torch.from_numpy(np.asarray(c.values)[:b.num_rows])
                ok = None if c.valid is None else torch.from_numpy(
                    np.asarray(c.valid)[:b.num_rows])
                sums[i] += int(row_hash([(v, ok, c.type)]).sum())
    want["checksum"] = [tuple(((x + (1 << 63)) % (1 << 64)) - (1 << 63)
                              for x in sums)]
    return want


def _nested_compare(want: dict):
    """compare(label, rows) for ``run_paths``: each path against its
    oracle (the arrays as multisets, the maps exactly; the statistics to
    1e-9 relative, an intercept within its float64 bound; min_by and
    max_by among the keys tied at the extreme)."""

    def compare(label, rows):
        w = want[label]
        if label == "nested_words":
            rows_match_limit(rows, w, _by((1, True), (0, False))[0], label,
                             limit=20)
        elif label == "nested_collect":
            got = [(p, sorted(a), m) for p, a, m in rows]
            if got != w:
                raise AssertionError(f"{label}: arrays or maps differ")
        elif label == "nested_stats":
            if [r[0] for r in rows] != [r[0] for r in w]:
                raise AssertionError(f"{label}: groups {rows}")
            for g, e in zip(rows, w):
                rows_match([g[1:5]], [e[1:5]], label)
                bound = max(1e-9 * abs(e[5]), want["intercept_bound"][e[0]])
                if abs(g[5] - e[5]) > bound:
                    raise AssertionError(f"{label} {e[0]} intercept "
                                         f"{g[5]!r} != {e[5]!r}")
                if g[6] not in e[6] or g[7] not in e[7]:
                    raise AssertionError(f"{label} {e[0]} min_by/max_by "
                                         f"{g[6:]} not in {e[6:]}")
        elif label == "checksum":
            if rows != w:
                raise AssertionError(f"checksum {rows} != CPU {w}")
        else:
            rows_match(rows, w, label)

    return compare


def nested_reads(runner, sql: str):
    """One run of ``sql`` on ``runner`` (one feed thread) that no wall
    reads: its rows and the counts of ``host_syncs`` (every read of the
    card, and those made in ``exec/unnestop.py``) beside the UNNEST
    operator's input batches, and of ``host_copies`` (copies to the
    card).  ``DeviceSpy`` fails the run unless its output batches lie on
    the card."""
    from presto_tpu_torch.exec import operators as OPS

    spy = DeviceSpy()
    spy.wrap(OPS.OutputCollector, "add_input", "output")
    try:
        (res, sites, _), copies = host_copies(
            lambda: host_syncs(lambda: runner.execute(sql)), to_card=True)
    finally:
        spy.restore()
    spy.check(["output"])
    unnest = os.path.join("presto_tpu_torch", "exec", "unnestop.py") + ":"
    return res.rows, {
        "unnest_batches": sum(s.input_batches
                              for s in runner._last_task.operator_stats
                              if "Unnest" in s.operator),
        "unnest_reads": sum(n for site, n in sites.items()
                            if site.startswith(unnest)),
        "reads": sum(sites.values()), "copies_to_card": len(copies)}


def nested_phase(runner, scale: float, card: str, modules) -> tuple:
    """Phase 9 on phase 3's runner at ``scale``: the paths of
    ``NESTED_QUERIES`` through ``run_paths`` against ``nested_oracles``
    (cold and two warm runs, the launches of each path's own cold run;
    ``nested_unnest`` must launch B1), and for each one more run with
    one feed thread (``nested_reads``): at most one read of the card an
    UNNEST batch, the output on cuda.  Then
    one checksum per flat type at SF0.01 against the CPU runner, and the
    tiny UNNEST cases against their literal answers.  One ``nested`` line
    a path.  Returns the launches and kept inputs by path."""
    from presto_tpu_torch.config import EngineConfig
    from presto_tpu_torch.localrunner import LocalQueryRunner

    S, B2, H, J, G = modules
    t0 = time.perf_counter()
    want = nested_oracles(scale, runner.config.scan_batch_rows)
    print(f"nested_oracles: {time.perf_counter() - t0:.2f} s at "
          f"SF{scale}", flush=True)
    spy = DeviceSpy()
    spy.wrap(G, "direct_grouped_aggregate", "aggregation")
    warm, cold = {}, {}
    launches, kept = run_paths(
        runner, NESTED_QUERIES, card, scale, modules,
        _nested_compare(want), spy,
        {label: ["aggregation"] if label == "nested_unnest" else []
         for label in NESTED_QUERIES}, NESTED_MUST_LAUNCH,
        lambda sql: scanned_rows(runner, scale, sql), warm,
        order_free=NESTED_ORDER_FREE, cold=cold)
    spy.restore()
    serial = LocalQueryRunner.tpch(scale=scale,
                                   config=EngineConfig(task_concurrency=1))
    compare = _nested_compare(want)
    for label, sql in NESTED_QUERIES.items():
        rows, counts = nested_reads(serial, sql)
        compare(label, rows)
        batches = counts["unnest_batches"]
        if counts["unnest_reads"] > batches:
            raise AssertionError(f"{label}: {counts['unnest_reads']} reads "
                                 f"of the card in {batches} UNNEST batches")
        if label in ("nested_unnest", "nested_words") and (
                batches == 0 or counts["unnest_reads"] == 0):
            # each batch reads its output size: none seen means the
            # instrument lost them
            raise AssertionError(f"{label}: {batches} UNNEST batches, "
                                 f"{counts['unnest_reads']} reads seen")
        line = {"query": label, "rows": len(rows),
                "cold_s": cold[label], "warm_s": warm[label],
                "launches": launches[label],
                "unnest_reads_per_batch": (counts["unnest_reads"] / batches
                                           if batches else None),
                **counts, "card": card}
        if label == "nested_stats":
            line["intercepts"] = [
                {"priority": r[0], "got": g[5], "numpy": r[5],
                 "bound": want["intercept_bound"][r[0]]}
                for r, g in zip(want[label], rows)]
        print("nested " + json.dumps(line), flush=True)

    # one checksum per flat type at SF0.01, and the tiny cases
    small = LocalQueryRunner.tpch(scale=0.01)
    cpu = LocalQueryRunner.tpch(scale=0.01, device="cpu")
    got = small.execute(CHECKSUM_TYPES).rows
    if got != cpu.execute(CHECKSUM_TYPES).rows:
        raise AssertionError(f"checksum per type {got} differs from the "
                             "CPU runner's")
    for sql, answer in NESTED_SMALL.items():
        rows = small.execute(sql).rows
        if rows != answer:
            raise AssertionError(f"{sql}: {rows}, want {answer}")
    print("nested_small " + json.dumps({
        "checksum_types": len(got[0]), "unnest_cases": len(NESTED_SMALL),
        "card": card}), flush=True)
    return launches, kept


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="TPC-H scale factor of the SQL phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel phase's random inputs")
    ap.add_argument("--ds-scale", type=float, default=1.0,
                    help="TPC-DS scale factor of phase 6")
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
    checks = [check_segment_sums(label, *b1_inputs(n, g, a, args.seed + i,
                                                   odd), g)
              for i, (label, n, g, a, odd) in enumerate(B1_SHAPES)]
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
             "l_orderkey", "l_partkey", "l_suppkey", "l_commitdate",
             "l_receiptdate"]
    cols = lineitem_columns(args.scale, names)
    want = {"q1": oracle_q1(cols), "q6": oracle_q6(cols),
            "q3": oracle_q3(args.scale, cols),
            "partkey": oracle_partkey(cols)}
    want.update(semi_oracles(args.scale, cols))
    facts = lineitem_facts(cols)
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

    # -- phase 4: this slice's queries (semi and anti joins, the cross
    # join against a scalar subquery), each path cold with the counts set
    # to 0 just before it and read just after, then warm twice
    semi_launches, semi_inputs = semi_phase(runner, args.scale, card, want,
                                            (S, B2, H, J, G))
    # Q18's IN subquery streams its GROUP BY now (clustered_aggregate on
    # cuda, checked above); its B2 inserts are the PagesHash build's only,
    # beside the 107 of the hash tier's rehash ladder before (PERF.md)
    print("q18_streaming " + json.dumps({
        "insert": semi_launches["q18"]["insert"], "insert_hash_tier": 107,
        "lookup": semi_launches["q18"]["lookup"]}), flush=True)

    # -- phase 6: TPC-DS (BASELINE.md's config 5 and the window queries)
    # at --ds-scale, each path cold with the counts set to 0 just before
    # it and read just after, then warm twice; its kept inputs join phase
    # 5's checks below
    t0 = time.perf_counter()
    ds_want = ds_oracles(args.ds_scale)
    print(f"ds_oracles: {time.perf_counter() - t0:.2f} s at "
          f"SF{args.ds_scale}", flush=True)
    ds_runner = LocalQueryRunner.tpch(scale=args.ds_scale)
    ds_launches, ds_inputs = ds_phase(ds_runner, args.ds_scale, card,
                                      ds_want, (S, B2, H, J, G))
    del ds_want
    semi_launches.update(ds_launches)
    semi_inputs.update(ds_inputs)
    # the dimension builds take PagesHash (B2); no GROUP BY of these
    # queries has a key domain small enough for B1
    for kind in ("insert", "lookup"):
        if not any(c[kind] for c in ds_launches.values()):
            raise AssertionError(f"phase 6 launched no {kind}: "
                                 f"{ds_launches}")

    # -- phase 7: tables on the card: the memory catalog at --scale, each
    # query path cold with the counts set to 0 just before it and read
    # just after, then warm twice; its kept inputs join phase 5's checks
    mem_launches, mem_inputs = memory_phase(
        runner, args.scale, card, want, facts,
        {label: min(w[1:]) for label, w in walls.items()},
        (S, B2, H, J, G))
    semi_launches.update(mem_launches)
    semi_inputs.update(mem_inputs)

    # -- phase 8: the rest of the statements and the sketches, on phase
    # 3's runner at --scale; each query path cold with the counts set to
    # 0 just before it and read just after; its kept inputs join phase
    # 5's checks
    stmt_launches, stmt_inputs = statements_phase(
        runner, args.scale, card, want, facts,
        {label: min(w[1:]) for label, w in walls.items()},
        {"q1": {"b1": b1_launches, "insert": 0, "lookup": 0},
         "q3": dict(b2_launches["q3"], b1=0)}, (S, B2, H, J, G))
    semi_launches.update(stmt_launches)
    semi_inputs.update(stmt_inputs)

    # -- phase 9: nested types, UNNEST, the collect aggregates and
    # checksum, on phase 3's runner at --scale; each path cold with the
    # counts set to 0 just before it and read just after; its kept inputs
    # join phase 5's checks
    nested_launches, nested_inputs = nested_phase(
        runner, args.scale, card, (S, B2, H, J, G))
    semi_launches.update(nested_launches)
    semi_inputs.update(nested_inputs)

    # -- phase 5: each kernel at the inputs phase 4 kept on each path,
    # against its plain version, with its times
    by_path = path_checks(semi_inputs)
    del semi_inputs
    for kernel, line in (("b1", "segment_sums"), ("insert", "probe_insert"),
                         ("lookup", "probe_lookup")):
        for path, c in by_path[kernel].items():
            print(f"{line} " + json.dumps(dict(c, path=path)), flush=True)
    for path, c in semi_launches.items():
        for kernel, n in c.items():
            if n > 0 and path not in by_path[kernel]:
                raise AssertionError(f"{path}: {n} {kernel} launches, no "
                                     "inputs kept")

    def entry(name, source, replaces, launches, c, paths):
        """``launches``: {path: count of that path's own run}; the key
        ``launches`` is the count on this slice's main path (Q3), or Q1's
        for B1.  ``ms`` is ``kernel_ms``, the device time from a CUDA
        graph (B2's lookup's in the (lo, cnt) mode the path runs), with
        ``wrapper_ms`` (the call), and ``library_device_ms`` (B2) or
        ``library_mm_ms`` (B1) beside it.  ``paths``: phase 5's checks of
        the kernel at each phase-4 path's inputs, under ``by_path``."""
        main = launches.get("q3", launches.get("q1"))
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": main,
               "launches_by_path": launches,
               "max_abs_err": c["max_abs_err"], "ms": c["ms"],
               "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
               "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
        for key in ("shape", "kernel_ms", "wrapper_ms",
                    "library_device_ms", "library_mm_ms"):
            if key in c:
                out[key] = c[key]
        out["by_path"] = {
            path: {key: p[key] for key in (
                "n", "g", "a", "k", "cap", "live", "prefilled", "build",
                "max_abs_err", "kernel_ms", "wrapper_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by") if key in p}
            for path, p in paths.items()}
        return out

    b1_by_path = {"q1": b1_launches}
    insert_by_path = {p: c["insert"] for p, c in b2_launches.items()}
    lookup_by_path = {p: c["lookup"] for p, c in b2_launches.items()}
    for p, c in semi_launches.items():
        b1_by_path[p] = c["b1"]
        insert_by_path[p] = c["insert"]
        lookup_by_path[p] = c["lookup"]
    kernels = [
        entry("direct_segment_sums",
              "presto_tpu_torch/csrc/segment_sums.cu",
              "presto_tpu/ops/pallas_groupby.py:48", b1_by_path, checks[0],
              by_path["b1"]),
        entry("probe_insert", "presto_tpu_torch/csrc/probe_insert.cu",
              "presto_tpu/ops/pallas_hash.py:44", insert_by_path,
              inserts[0], by_path["insert"]),
        entry("probe_lookup", "presto_tpu_torch/csrc/probe_insert.cu",
              "presto_tpu/ops/pallas_hash.py:44", lookup_by_path,
              lookups[0], by_path["lookup"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
