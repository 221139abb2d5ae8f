"""Grouped and global aggregation over tensors.

The reference's HashAggregationOperator drives GroupByHash
(presto-main/.../operator/MultiChannelGroupByHash.java:273-286) and
codegen'd accumulators (AccumulatorCompiler.java:80); its
AggregationOperator (AggregationOperator.java:35) reduces ungrouped.

This module holds the tiers this package runs:

- **direct** (``direct_grouped_aggregate``): bounded key domains
  (dictionary codes, booleans) — the BigintGroupByHash special-case role
  (GroupByHash.java:30-43).  The group id is computed arithmetically and
  the aggregation is a handful of segment reductions: float sums and
  counts through the hand-written kernel ``direct_segment_sums``
  (ops/segment_sums.py) when the domain is small, ``index_add_`` above
  that; exact integer sums and min/max through native-dtype scatters.
- **sort** (``grouped_aggregate``): any keys.  Rows sort by their
  normalized key words (a stable sort, so rows of one group keep their
  input order), run boundaries give the group ids, and each group reduces
  in that order.
- **hash**: the resident GroupByHash state of ``ops/hashtable.py``
  (kernel B2 on a CUDA tensor), driven by exec/aggregation.py.
- **global** (``global_aggregate``): one output row.

Float group sums are the same bits on every run, on every tier: each
group's sum is taken over its rows in input order by one fixed-order
reduction, ``sorted_segment_sums`` (``torch.segment_reduce`` over rows
already sorted by group), never by float atomics (``index_add_`` on CUDA
adds in whatever order its atomics land).  Integer sums stay exact
native-dtype scatters, and min/max do not depend on order.

Aggregation primitives are sum/count/min/max (the planner decomposes
avg/stddev/... into these, mirroring the partial/final Step split of
HashAggregationOperator.Step:61).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops.keys import normalize_keys
from presto_tpu_torch.ops.segment_sums import (
    MAX_SEGMENTS, direct_segment_sums,
)

# One aggregation input: (prim, values, valid|None) with prim in
# {'sum','count','min','max'}; 'count' ignores values.
AggIn = Tuple[str, Optional[torch.Tensor], Optional[torch.Tensor]]


def sorted_segment_sums(vals: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of ``vals`` (``[N]`` or ``[N, A]``, rows
    already grouped), ``lengths[g]`` rows for run g: each run summed in
    row order.  The one fixed-order reduction every float group sum goes
    through."""
    if vals.shape[0] == 0:
        return torch.zeros((lengths.shape[0],) + tuple(vals.shape[1:]),
                           dtype=vals.dtype, device=vals.device)
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _runs(sorted_ids: torch.Tensor):
    """(first position, length) of each run of equal ids."""
    n = sorted_ids.shape[0]
    boundary = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    boundary[1:] = sorted_ids[1:] != sorted_ids[:-1]
    starts = torch.nonzero(boundary).squeeze(1)
    ends = torch.cat([starts[1:], torch.tensor([n], device=starts.device)])
    return starts, ends - starts


def fixed_order_segment_sums(gid: torch.Tensor, vals: torch.Tensor):
    """Per distinct ``gid`` (int64 ``[N]``), the sum of its rows of
    ``vals`` in row order: ``(ids [G] ascending, sums [G, ...])``.  A
    stable sort groups the rows without reordering a group, then
    ``sorted_segment_sums`` reduces them: the same bits on every run."""
    if gid.shape[0] == 0:
        return gid, vals[:0]
    perm = torch.argsort(gid, stable=True)
    g = gid[perm]
    starts, lengths = _runs(g)
    return g[starts], sorted_segment_sums(vals[perm], lengths)


def segment_sums(gid: torch.Tensor, vals: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """Dense ``[n_seg, ...]`` sums of ``vals`` rows by ``gid`` in
    ``[0, n_seg)``, in fixed order (``fixed_order_segment_sums``)."""
    out = torch.zeros((n_seg,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    ids, sums = fixed_order_segment_sums(gid.to(torch.int64), vals)
    out[ids] = sums
    return out


def _min_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _max_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def scatter_extreme_(acc: torch.Tensor, gid: torch.Tensor,
                     values: torch.Tensor, prim: str) -> torch.Tensor:
    """``acc[g] = min/max(acc[g], values of the rows of g)``, in place and
    exact in ``acc``'s dtype (the order of the rows does not matter)."""
    if acc.dtype == torch.bool:
        # scatter_reduce has no bool kernels: reduce as uint8
        tmp = scatter_extreme_(acc.to(torch.uint8), gid,
                               values.to(torch.uint8), prim)
        return acc.copy_(tmp.to(torch.bool))
    return acc.scatter_reduce_(0, gid.long(), values.to(acc.dtype),
                               "amin" if prim == "min" else "amax")


def _segment_extreme(values: torch.Tensor, live: torch.Tensor,
                     gid: torch.Tensor, n_seg: int, prim: str
                     ) -> torch.Tensor:
    """Per-segment min or max of the live values (identity where a
    segment saw none), exact in the values' dtype."""
    ident = _min_identity(values.dtype) if prim == "min" \
        else _max_identity(values.dtype)
    v = torch.where(live, values, torch.full_like(values, ident))
    out = torch.full((n_seg,), ident, dtype=values.dtype,
                     device=values.device)
    return scatter_extreme_(out, gid, v, prim)


def _segment_ids(key_words: List[torch.Tensor], pad: torch.Tensor):
    """Sort rows by (pad, keys); return (perm, gid_sorted, boundary).

    torch has no ``lexsort``: the permutation is built from stable
    argsorts, minor word first, pad flag last (the primary word), so rows
    of one group keep their input order."""
    n = pad.shape[0]
    device = pad.device
    # zero pad rows' keys so they collide into one trailing run
    cleaned = [torch.where(pad, torch.zeros_like(w), w) for w in key_words]
    perm = torch.arange(n, device=device)
    for w in reversed([pad.to(torch.int8)] + cleaned):
        perm = perm[torch.argsort(w[perm], stable=True)]
    sorted_pad = pad[perm]
    boundary = torch.zeros(n, dtype=torch.bool, device=device)
    if n:
        boundary[0] = True
    for w in cleaned:
        ws = w[perm]
        boundary[1:] |= ws[1:] != ws[:-1]
    boundary[1:] |= sorted_pad[1:] != sorted_pad[:-1]
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    return perm, gid, boundary


def grouped_aggregate(
    key_columns: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor],
                                T.Type]],
    aggs: Sequence[AggIn],
    num_rows: int,
    live_mask: Optional[torch.Tensor] = None,
):
    """The sort tier: aggregate ``aggs`` per distinct key tuple.

    All tensors share one row capacity; rows ``[0, num_rows)`` are live
    (and ``live_mask``, a fused upstream filter).  Returns::

        (group_index [G] int64,   # row index of each group's first row
         num_groups  int,
         results     [(values [G], count_nonnull [G])])

    Groups come out in key-word order.  Key columns are gathered by the
    caller via ``group_index``.  Eager torch sizes every output exactly,
    so there is no capacity to overflow (the JAX package re-runs at the
    next bucket).
    """
    cap = key_columns[0][0].shape[0]
    device = key_columns[0][0].device
    pad = torch.arange(cap, device=device) >= num_rows
    if live_mask is not None:
        pad = pad | ~live_mask
    key_words, _ = normalize_keys(key_columns, nulls_equal=True)
    perm, gid, _boundary = _segment_ids(key_words, pad)
    # pad rows sort last: the live rows are the leading positions
    n_live = int((~pad).sum())
    perm, gid = perm[:n_live], gid[:n_live]
    starts, lengths = _runs(gid)
    num_groups = int(starts.shape[0])
    group_index = perm[starts]

    results = []
    for prim, values, valid in aggs:
        live = ~pad if valid is None else (~pad & valid)
        live_sorted = live[perm]
        cnt = torch.zeros(num_groups, dtype=torch.int64, device=device)
        cnt.index_add_(0, gid, live_sorted.to(torch.int64))
        if prim == "count":
            results.append((cnt, cnt))
            continue
        v = values[perm]
        if prim == "sum":
            v = torch.where(live_sorted, v, torch.zeros_like(v))
            if v.dtype.is_floating_point:
                out = sorted_segment_sums(v, lengths)
            else:
                out = torch.zeros(num_groups, dtype=v.dtype,
                                  device=device).index_add_(0, gid, v)
        elif prim in ("min", "max"):
            out = _segment_extreme(v, live_sorted, gid, num_groups, prim)
        else:
            raise ValueError(f"unknown aggregation primitive {prim}")
        results.append((out, cnt))
    return group_index, num_groups, results


def direct_grouped_aggregate(
    key_codes: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    domain_sizes: Sequence[int],
    aggs: Sequence[AggIn],
    num_rows: int,
    live_mask: Optional[torch.Tensor] = None,
):
    """Small-key-space path: mixed-radix group id -> segment reduce.

    ``key_codes``: per key column ``(codes, valid)`` with codes already in
    ``[0, domain_size)``.  Nullable keys get slot 0 reserved by the +1 shift
    here (null is a group, SQL semantics).  ``live_mask`` fuses an upstream
    filter (WHERE) without compaction.

    Returns ``(present [D] bool, results [(values [D], cnt [D])], bad)``
    over the dense domain ``D = prod(shifted domains)``; key values for
    slot g decode arithmetically (``decode_direct_keys``).  ``bad`` is
    ``direct_segment_sums``'s int32 ``[1]`` count of rows whose group id
    fell outside the domain, left on the device for the caller's next
    host read (None above the kernel's 32 segments).
    """
    codes0 = key_codes[0][0]
    cap = codes0.shape[0]
    device = codes0.device
    live = torch.arange(cap, device=device) < num_rows
    if live_mask is not None:
        live = live & live_mask
    gid = torch.zeros(cap, dtype=torch.int32, device=device)
    total = 1
    for (codes, valid), dom in zip(key_codes, domain_sizes):
        c = codes.to(torch.int32)
        if valid is not None:
            c = torch.where(valid, c + 1, 0)  # slot 0 = NULL group
            dom = dom + 1
        gid = gid * dom + c
        total *= dom
    # dead rows -> trailing garbage slot
    gid = torch.where(live, gid, total).to(torch.int32)
    n_seg = total + 1

    # --- sums & counts ---------------------------------------------------
    # Float sums and every count column (sums of ones, exact in f64) are
    # A float64 columns reduced by gid.  Integer sums stay exact in their
    # native dtype (an f64 reduction rounds int64 sums above 2^53).
    sum_cols, live_masks, int_sums = [], [], {}
    for i, (prim, values, valid) in enumerate(aggs):
        lv = live if valid is None else (live & valid)
        live_masks.append(lv)
        if prim == "sum":
            if values.dtype.is_floating_point:
                sum_cols.append(torch.where(lv, values, 0.0)
                                .to(torch.float64))
            else:
                v = torch.where(lv, values, torch.zeros_like(values))
                int_sums[i] = torch.zeros(
                    n_seg, dtype=values.dtype, device=device
                ).index_add_(0, gid.long(), v)[:total]
        sum_cols.append(lv.to(torch.float64))    # non-null count column
    sum_cols.append(live.to(torch.float64))      # group-present count

    bad = None
    if n_seg <= MAX_SEGMENTS:
        # the JAX package hands this reduction to its MXU/Pallas route at
        # the same domain size; here the hand-written kernel (a CUDA
        # tensor), which reads the columns where they lie, or its plain
        # version (a CPU tensor)
        reduced, bad = direct_segment_sums(gid, sum_cols, n_seg)
    else:
        reduced = segment_sums(gid, torch.stack(sum_cols, 1), n_seg)
    reduced = reduced[:total]                    # [G, A]

    star = torch.round(reduced[:, -1]).to(torch.int64)
    present = star > 0
    results = []
    col = 0
    for i, ((prim, values, valid), lv) in enumerate(zip(aggs, live_masks)):
        if prim == "sum":
            if i in int_sums:
                out = int_sums[i]
            else:
                out = reduced[:, col]
                col += 1
        cnt = torch.round(reduced[:, col]).to(torch.int64)
        col += 1
        if prim == "count":
            results.append((cnt, cnt))
            continue
        if prim == "sum":
            results.append((out, cnt))
            continue
        if prim not in ("min", "max"):
            raise ValueError(f"unknown aggregation primitive {prim}")
        out = _segment_extreme(values, lv, gid, n_seg, prim)[:total]
        results.append((out, cnt))
    return present, results, bad


def decode_direct_keys(slots: torch.Tensor,
                       key_valids: Sequence[bool],
                       domain_sizes: Sequence[int]):
    """Arithmetically decode dense slot ids back into per-column
    (codes, valid) — the inverse of direct_grouped_aggregate's packing."""
    doms = [d + 1 if nullable else d
            for d, nullable in zip(domain_sizes, key_valids)]
    out = []
    rem = slots
    for dom, nullable in zip(reversed(doms), reversed(key_valids)):
        c = torch.remainder(rem, dom)
        rem = torch.div(rem, dom, rounding_mode="floor")
        if nullable:
            out.append((torch.clamp(c - 1, min=0), c > 0))
        else:
            out.append((c, None))
    return out[::-1]


def global_aggregate(aggs: Sequence[AggIn], num_rows: int,
                     live_mask: Optional[torch.Tensor] = None):
    """Ungrouped aggregation (AggregationOperator analogue): one result
    per aggregate, as 0-d tensors ``(value, count)`` (SQL: aggregates
    over empty input yield count=0 / sum=NULL)."""
    results: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for prim, values, valid in aggs:
        live = torch.arange(values.shape[0], device=values.device) \
            < num_rows
        if live_mask is not None:
            live = live & live_mask
        if prim == "count" and valid is None:   # count(*)
            cnt = live.sum().to(torch.int64)
            results.append((cnt, cnt))
            continue
        if valid is not None:
            live = live & valid
        cnt = live.sum().to(torch.int64)
        if prim == "count":
            results.append((cnt, cnt))
            continue
        if prim == "sum":
            out = torch.where(live, values, torch.zeros_like(values)).sum()
        elif prim == "min":
            out = torch.where(live, values, torch.full_like(
                values, _min_identity(values.dtype))).min()
        elif prim == "max":
            out = torch.where(live, values, torch.full_like(
                values, _max_identity(values.dtype))).max()
        else:
            raise ValueError(prim)
        results.append((out, cnt))
    return results
