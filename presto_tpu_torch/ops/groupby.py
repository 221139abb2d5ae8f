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
- **global** (``global_aggregate``): one output row.

The sort and hash GROUP BY tiers of the JAX package are ROADMAP A4.

Aggregation primitives are sum/count/min/max (the planner decomposes
avg/stddev/... into these, mirroring the partial/final Step split of
HashAggregationOperator.Step:61).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.ops.segment_sums import (
    MAX_SEGMENTS, direct_segment_sums, direct_segment_sums_reference,
)

# One aggregation input: (prim, values, valid|None) with prim in
# {'sum','count','min','max'}; 'count' ignores values.
AggIn = Tuple[str, Optional[torch.Tensor], Optional[torch.Tensor]]


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


def _segment_extreme(values: torch.Tensor, live: torch.Tensor,
                     gid: torch.Tensor, n_seg: int, prim: str
                     ) -> torch.Tensor:
    """Per-segment min or max of the live values (identity where a
    segment saw none), exact in the values' dtype."""
    ident = _min_identity(values.dtype) if prim == "min" \
        else _max_identity(values.dtype)
    if values.dtype == torch.bool:
        # scatter_reduce has no bool kernels: reduce as uint8
        out = _segment_extreme(values.to(torch.uint8), live, gid, n_seg,
                               prim)
        return out.to(torch.bool)
    v = torch.where(live, values, torch.full_like(values, ident))
    out = torch.full((n_seg,), ident, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, gid.long(), v,
                               "amin" if prim == "min" else "amax",
                               include_self=True)


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

    Returns ``(present [D] bool, results [(values [D], cnt [D])])`` over
    the dense domain ``D = prod(shifted domains)``; key values for slot g
    decode arithmetically (``decode_direct_keys``).
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
    # Float sums and every count column (sums of ones, exact in f64) form
    # one [N, A] float64 matrix reduced by gid.  Integer sums stay exact
    # in their native dtype (an f64 reduction rounds int64 sums above
    # 2^53).
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

    m = torch.stack(sum_cols, 1)                 # [N, A]
    if n_seg <= MAX_SEGMENTS:
        # the JAX package hands this reduction to its MXU/Pallas route at
        # the same domain size; here the hand-written kernel (a CUDA
        # tensor) or its plain version (a CPU tensor)
        reduced = direct_segment_sums(gid, m, n_seg)
    else:
        reduced = direct_segment_sums_reference(gid, m, n_seg)
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
    return present, results


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
