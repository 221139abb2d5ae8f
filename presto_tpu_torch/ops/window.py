"""Window functions as segmented scans over partition-sorted rows.

The reference computes window functions row at a time over a sorted
PagesIndex, partition by partition (WindowOperator.java:61 +
operator/window/*, framing in FrameInfo).  Here, as in the JAX package,
the rows are sorted by (partition keys, order keys) once, and every
window function becomes a *segmented scan* (a scan whose combine resets
at partition boundaries) plus gathers at segment and peer-group
boundaries: no loop over partitions.

torch has no associative scan.  ``_segmented_scan`` builds the one the
JAX package gets from ``jax.lax.associative_scan``, with the same
recursion (combine adjacent pairs, scan the half, fill in the rest), so
every float sum is combined in the same tree as there and gives the same
bits; it takes about log2(n) rounds of elementwise torch ops.  The
frame sums difference prefix sums at the frame ends, cancellation
included, as the JAX package does.

Inputs are tensors of one capacity on one device; only rows
``[0, num_rows)`` are live, and the padding rows lie after every live row
(the sort puts them there).  ``seg`` is the partition id of each row
(nondecreasing), ``peer`` the peer-group id (nondecreasing, refines
``seg``).  Nothing here reads the device to the host but
``nonzero_host`` and ``nonzero_index``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def nonzero_host(mask: Tensor) -> np.ndarray:
    """The positions where ``mask`` holds, on the host: one device read
    (the window operator's partition starts)."""
    return torch.nonzero(mask).squeeze(1).cpu().numpy()


def nonzero_index(mask: Tensor) -> Tensor:
    """The positions where ``mask`` holds, as an index tensor on the
    mask's device; sizing it reads the device once (TopNRowNumber's
    ``keep``)."""
    return torch.nonzero(mask).squeeze(1)


# ---------------------------------------------------------------------------
# segment machinery
# ---------------------------------------------------------------------------

def _leading_true(x: Tensor) -> Tensor:
    return torch.ones(1, dtype=torch.bool, device=x.device)


def segment_ids(key_equal_prev: Tensor) -> Tensor:
    """[n] bool "row i equals row i-1 on the keys" -> int32 segment ids."""
    starts = torch.cat([_leading_true(key_equal_prev),
                        ~key_equal_prev[1:]])
    return (torch.cumsum(starts.to(torch.int32), 0) - 1).to(torch.int32)


def _seg_bounds(seg: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-row (start_idx, end_idx, index_in_seg, seg_count), int64."""
    n = seg.shape[0]
    idx = torch.arange(n, device=seg.device)
    is_start = torch.cat([_leading_true(seg), seg[1:] != seg[:-1]])
    # start index of this row's segment: running max of start positions
    start_idx = torch.cummax(torch.where(is_start, idx, 0), 0).values
    is_end = torch.cat([seg[1:] != seg[:-1], _leading_true(seg)])
    # end index: reverse running min of end positions
    end_idx = torch.flip(torch.cummin(
        torch.flip(torch.where(is_end, idx, n - 1), [0]), 0).values, [0])
    index_in_seg = idx - start_idx
    count = end_idx - start_idx + 1
    return start_idx, end_idx, index_in_seg, count


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    out = torch.empty((even.shape[0] + odd.shape[0],),
                      dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def _segmented_scan(seg: Tensor, values: Tensor,
                    combine: Callable[[Tensor, Tensor], Tensor]) -> Tensor:
    """Inclusive scan of ``combine`` over values, restarting per segment.

    The recursion of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan those, then combine each scanned pair with the next
    element; the segment id travels with its value and the combine
    keeps the right operand where the two segments differ."""

    def op(sa, va, sb, vb):
        return sb, torch.where(sa == sb, combine(va, vb), vb)

    def scan(s: Tensor, v: Tensor):
        n = v.shape[0]
        if n < 2:
            return s, v
        rs, rv = op(s[0:n - 1:2], v[0:n - 1:2], s[1::2], v[1::2])
        os_, ov = scan(rs, rv)
        if n % 2 == 0:
            es, ev = op(os_[:-1], ov[:-1], s[2::2], v[2::2])
        else:
            es, ev = op(os_, ov, s[2::2], v[2::2])
        es = torch.cat([s[:1], es])
        ev = torch.cat([v[:1], ev])
        return _interleave(es, os_), _interleave(ev, ov)

    return scan(seg, values)[1]


def _seg_cumsum(seg: Tensor, values: Tensor) -> Tensor:
    return _segmented_scan(seg, values, torch.add)


def _seg_cummax(seg: Tensor, values: Tensor) -> Tensor:
    return _segmented_scan(seg, values, torch.maximum)


def _seg_cummin(seg: Tensor, values: Tensor) -> Tensor:
    return _segmented_scan(seg, values, torch.minimum)


# ---------------------------------------------------------------------------
# ranking functions (frames do not apply)
# ---------------------------------------------------------------------------

def row_number(seg: Tensor) -> Tensor:
    _, _, in_seg, _ = _seg_bounds(seg)
    return (in_seg + 1).to(torch.int64)


def rank(seg: Tensor, peer: Tensor) -> Tensor:
    seg_start, _, _, _ = _seg_bounds(seg)
    peer_start, _, _, _ = _seg_bounds(peer)
    return (peer_start - seg_start + 1).to(torch.int64)


def dense_rank(seg: Tensor, peer: Tensor) -> Tensor:
    is_peer_start = torch.cat([_leading_true(peer), peer[1:] != peer[:-1]])
    return _seg_cumsum(seg, is_peer_start.to(torch.int64))


def percent_rank(seg: Tensor, peer: Tensor) -> Tensor:
    _, _, _, count = _seg_bounds(seg)
    r = rank(seg, peer)
    return torch.where(
        count > 1,
        (r - 1).to(torch.float64)
        / torch.clamp(count - 1, min=1).to(torch.float64),
        0.0)


def cume_dist(seg: Tensor, peer: Tensor) -> Tensor:
    seg_start, _, _, count = _seg_bounds(seg)
    _, peer_end, _, _ = _seg_bounds(peer)
    return ((peer_end - seg_start + 1).to(torch.float64)
            / count.to(torch.float64))


def ntile(seg: Tensor, n_buckets: int) -> Tensor:
    """SQL ntile: remainder rows go to the leading buckets."""
    _, _, in_seg, count = _seg_bounds(seg)
    base = count // n_buckets
    rem = count % n_buckets
    big = rem * (base + 1)  # rows covered by the (base+1)-sized buckets
    in_big = in_seg < big
    bucket = torch.where(
        in_big,
        in_seg // torch.clamp(base + 1, min=1),
        rem + (in_seg - big) // torch.clamp(base, min=1))
    return (bucket + 1).to(torch.int64)


# ---------------------------------------------------------------------------
# value functions
# ---------------------------------------------------------------------------

def shift_in_partition(seg: Tensor, values: Tensor, valid: Optional[Tensor],
                       offset: int, default_values: Optional[Tensor] = None,
                       ) -> Tuple[Tensor, Tensor]:
    """lag (offset>0) / lead (offset<0): value ``offset`` rows back within
    the partition, else the default (NULL when no default)."""
    n = values.shape[0]
    idx = torch.arange(n, device=values.device) - offset
    idx_c = torch.clamp(idx, 0, n - 1)
    in_part = (idx >= 0) & (idx < n) & (seg[idx_c] == seg)
    out = torch.where(in_part, values[idx_c], values)
    ok = in_part if valid is None else torch.where(in_part, valid[idx_c],
                                                   False)
    if default_values is not None:
        out = torch.where(in_part, out, default_values)
        ok = ok | ~in_part
    return out, ok


def value_at(values: Tensor, valid: Optional[Tensor], idx: Tensor
             ) -> Tuple[Tensor, Tensor]:
    """Gather ``values[idx]`` with validity (for last_value at frame end)."""
    idx_c = torch.clamp(idx, 0, values.shape[0] - 1)
    out = values[idx_c]
    ok = (torch.ones_like(idx, dtype=torch.bool) if valid is None
          else valid[idx_c])
    return out, ok


# ---------------------------------------------------------------------------
# framed aggregates
# ---------------------------------------------------------------------------

def frame_ends(seg: Tensor, peer: Tensor, unit: str,
               start: str, end: str,
               start_offset: Optional[int] = None,
               end_offset: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Per-row inclusive frame [lo, hi] as row indices.

    ``unit`` 'range' resolves CURRENT ROW to the whole peer group (SQL
    semantics); bounded offsets are supported for 'rows' only.
    """
    seg_start, seg_end, _, _ = _seg_bounds(seg)
    idx = torch.arange(seg.shape[0], device=seg.device)
    if unit == "range":
        peer_start, peer_end, _, _ = _seg_bounds(peer)
        cur_lo, cur_hi = peer_start, peer_end
    else:
        cur_lo, cur_hi = idx, idx

    if start == "unbounded_preceding":
        lo = seg_start
    elif start == "current":
        lo = cur_lo
    elif start == "preceding":
        lo = torch.maximum(idx - start_offset, seg_start)
    elif start == "following":
        lo = torch.minimum(idx + start_offset, seg_end + 1)
    else:
        raise ValueError(f"bad frame start {start}")

    if end == "unbounded_following":
        hi = seg_end
    elif end == "current":
        hi = cur_hi
    elif end == "following":
        hi = torch.minimum(idx + end_offset, seg_end)
    elif end == "preceding":
        hi = torch.maximum(idx - end_offset, seg_start - 1)
    else:
        raise ValueError(f"bad frame end {end}")
    return lo, hi


def framed_sum_count(seg: Tensor, values: Tensor, valid: Optional[Tensor],
                     lo: Tensor, hi: Tensor) -> Tuple[Tensor, Tensor]:
    """(sum, count) of valid values over [lo, hi] per row, via segmented
    prefix sums differenced at the frame bounds."""
    n = values.shape[0]
    ok = (torch.ones(n, dtype=torch.bool, device=values.device)
          if valid is None else valid)
    contrib = torch.where(ok, values, torch.zeros_like(values))
    ps = _seg_cumsum(seg, contrib)          # inclusive prefix within segment
    pc = _seg_cumsum(seg, ok.to(torch.int64))
    seg_start = _seg_bounds(seg)[0]

    def pref(p, at):
        # prefix value at index `at` (inclusive); 0 before segment start
        v = p[torch.clamp(at, 0, n - 1)]
        return torch.where(at < seg_start, torch.zeros_like(v), v)

    s = pref(ps, hi) - pref(ps, lo - 1)
    c = pref(pc, hi) - pref(pc, lo - 1)
    empty = lo > hi
    s = torch.where(empty, torch.zeros_like(s), s)
    c = torch.where(empty, torch.zeros_like(c), c)
    return s, c


def _sentinel(dtype: torch.dtype, is_max: bool):
    """The identity of max (the dtype's least value) or min (its
    greatest): ``finfo``/``iinfo`` bounds, not infinities."""
    info = torch.finfo if dtype.is_floating_point else torch.iinfo
    return info(dtype).min if is_max else info(dtype).max


def framed_minmax_range(values: Tensor, valid: Optional[Tensor],
                        lo: Tensor, hi: Tensor, is_max: bool
                        ) -> Tuple[Tensor, Tensor]:
    """min/max over arbitrary [lo, hi] frames (bounded ``N PRECEDING``
    starts included) via a doubling sparse table: level k holds the
    extremum of each 2^k-wide window, and a query covers [lo, hi] with
    two overlapping power-of-two windows.  O(n log n) elementwise build,
    two gathers per row.

    ``lo``/``hi`` must already be clipped to partition bounds (as
    frame_ends produces), so queries never straddle partitions."""
    n = values.shape[0]
    device = values.device
    sentinel = _sentinel(values.dtype, is_max)
    ok = (torch.ones(n, dtype=torch.bool, device=device)
          if valid is None else valid)
    masked = torch.where(ok, values,
                         torch.full_like(values, sentinel))
    op = torch.maximum if is_max else torch.minimum

    levels = [masked]
    counts = [ok.to(torch.int32)]
    width = 1
    while width < n:
        prev = levels[-1]
        pcnt = counts[-1]
        pad = torch.full((width,), sentinel, dtype=values.dtype,
                         device=device)
        levels.append(op(prev, torch.cat([prev[width:], pad])))
        counts.append(pcnt + torch.cat(
            [pcnt[width:], torch.zeros(width, dtype=torch.int32,
                                       device=device)]))
        width *= 2
    table = torch.stack(levels)            # [L, n]
    ctable = torch.stack(counts)

    length = torch.clamp(hi - lo + 1, min=1)
    k = (torch.ceil(torch.log2(length.to(torch.float64) + 0.5))
         .to(torch.int32) - 1)
    k = torch.clamp(k, 0, len(levels) - 1).to(torch.int64)  # floor(log2)
    span = torch.bitwise_left_shift(torch.ones_like(k), k)
    a = torch.clamp(lo, 0, n - 1)
    b = torch.clamp(hi - span + 1, 0, n - 1)
    out = op(table[k, a], table[k, b])
    any_ok = (ctable[k, a] + ctable[k, b]) > 0
    empty = lo > hi
    return out, any_ok & ~empty


def framed_minmax(seg: Tensor, peer: Tensor, values: Tensor,
                  valid: Optional[Tensor], unit: str, start: str, end: str,
                  is_max: bool, lo: Optional[Tensor] = None,
                  hi: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """min/max over frames with an unbounded edge (the common shapes):
    [unbounded_preceding, current|unbounded_following].  Running extremum
    via segmented cummax/cummin; range frames gather at the peer end.
    Bounded starts (``N PRECEDING``) route to the sparse-table range
    query when the caller supplies the frame ends."""
    if start != "unbounded_preceding":
        if lo is None or hi is None:
            raise NotImplementedError(
                "bounded min/max frame requires precomputed frame ends")
        return framed_minmax_range(values, valid, lo, hi, is_max)
    sentinel = _sentinel(values.dtype, is_max)
    ok = (torch.ones(values.shape[0], dtype=torch.bool,
                     device=values.device) if valid is None else valid)
    masked = torch.where(ok, values, torch.full_like(values, sentinel))
    scan = (_seg_cummax if is_max else _seg_cummin)(seg, masked)
    cnt = _seg_cumsum(seg, ok.to(torch.int64))
    if end == "unbounded_following":
        seg_end = _seg_bounds(seg)[1]
        out, any_ok = scan[seg_end], cnt[seg_end] > 0
    elif unit == "range":
        peer_end = _seg_bounds(peer)[1]
        out, any_ok = scan[peer_end], cnt[peer_end] > 0
    else:
        out, any_ok = scan, cnt > 0
    return out, any_ok
