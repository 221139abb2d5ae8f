"""Hash-join kernel family (sorted-build design).

The reference's join is PagesHash — an open-addressing table over
PagesIndex, probed row at a time (presto-main/.../operator/PagesHash.java:
63-121, JoinProbe.java:74-80, LookupJoinPageBuilder.java:74).  This is the
port of the JAX package's ``ops/join.py``, whose sorted tier reads:

  build:  key ids -> sort build ids
  probe:  per-probe match ranges (a dense histogram when the build's key
          span is small, else a vectorized binary search) -> prefix-sum
          expansion -> two gathers

Duplicate build keys need no PositionLinks chains: they are adjacent runs
in the sorted order.  Null join keys never match (SQL semantics), encoded
as distinct negative sentinels per side.

The PagesHash table proper (``ops/hashtable.py pages_hash_build`` /
``pages_hash_probe``, kernel B2 on a CUDA tensor) shares the (lo, counts)
-> ``expand_matches`` contract below.

Eager torch sizes every output exactly: the expansion takes the exact
output row count, where the JAX package pads to a capacity bucket.  The
semi and anti joins are masks over the probe rows from the same (lo,
counts) (``semi_mask``, ``anti_keep_from_parts``).  The ``canonical``
tier (``canonical_ids``, a union sort of both sides' keys) is ROADMAP A4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from presto_tpu_torch import types as T

_BUILD_DEAD = -2   # build row excluded (null key or padding)
_PROBE_DEAD = -1   # probe row excluded (null key or padding)

KeyColumn = Tuple[torch.Tensor, Optional[torch.Tensor], T.Type]


def single_word_joinable(typ: T.Type, has_dictionary: bool = False) -> bool:
    """May this key channel take the single-word fast path (values ARE
    the ids)?  Integer-word types and dictionary codes qualify."""
    return (has_dictionary or T.is_integral(typ)
            or typ.name in ("date", "timestamp", "boolean")
            or isinstance(typ, T.DecimalType))


def _dead(values: torch.Tensor, valid: Optional[torch.Tensor],
          n: int) -> torch.Tensor:
    dead = torch.arange(values.shape[0], device=values.device) >= n
    return dead if valid is None else (dead | ~valid)


def single_word_span_too_big(build_key: KeyColumn, n_build: int) -> bool:
    """Would the live build-key spread overflow the (value - min + 2) id
    arithmetic?  (Callers then route to a tier that can take the keys.)
    One host read of the live minimum and maximum."""
    values, valid, _ = build_key
    dead = _dead(values, valid, n_build)
    if bool(dead.all()):
        return False
    v = values.to(torch.int64)[~dead]
    lo, hi = torch.aminmax(v)
    return int(hi) - int(lo) >= 1 << 62


def single_word_ids(build_key: KeyColumn, probe_key: KeyColumn,
                    n_build: int, n_probe: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast path for one integer-typed key channel: values ARE the ids.

    Both sides shift by the build side's live minimum so ids are
    non-negative for every matchable value — negative keys included —
    leaving {-2,-1} as dead-row sentinels.  Probe values below the build
    minimum cannot match any build row and map to the dead sentinel."""
    bvals, bvalid, _ = build_key
    pvals, pvalid, _ = probe_key
    b = bvals.to(torch.int64)
    p = pvals.to(torch.int64)
    dead_b = _dead(bvals, bvalid, n_build)
    dead_p = _dead(pvals, pvalid, n_probe)
    bmin = torch.where(dead_b, 1 << 62, b).min() if b.shape[0] else \
        torch.tensor(0, device=b.device)
    bmin = torch.where(dead_b.all(), 0, bmin)
    b = b - bmin + 2
    p = p - bmin + 2
    return (torch.where(dead_b, _BUILD_DEAD, b),
            torch.where(dead_p | (p < 0), _PROBE_DEAD, p))


def build_index(build_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the build side (the LookupSource build): ``(sorted ids,
    perm)``.  Stable, so equal keys keep their input order."""
    perm = torch.argsort(build_ids, stable=True)
    return build_ids[perm], perm


def _lower_bound(sorted_arr: torch.Tensor, queries: torch.Tensor,
                 inclusive: bool) -> torch.Tensor:
    """Vectorized binary search as a static loop of flat gathers.
    ``inclusive=False`` -> first i with arr[i] >= q (left);
    ``inclusive=True`` -> first i with arr[i] > q (right)."""
    n = sorted_arr.shape[0]
    device = queries.device
    lo = torch.zeros(queries.shape[0], dtype=torch.int64, device=device)
    hi = torch.full((queries.shape[0],), n, dtype=torch.int64,
                    device=device)
    if n == 0:
        return lo
    for _ in range(n.bit_length()):
        mid = (lo + hi) >> 1
        v = sorted_arr[torch.clamp(mid, max=n - 1)]
        go_right = (v <= queries) if inclusive else (v < queries)
        # once lo == hi the interval is empty: without this guard the
        # clamped gather rereads arr[n-1] and pushes lo past n
        go_right = go_right & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _dense_scratch(cap_b: int, cap_p: int) -> int:
    """Histogram size for the dense-domain probe path: large enough for
    generated-key ranges at small and medium scale, capped so the scratch
    stays tens of MB."""
    want = 4 * (cap_b + cap_p)
    size = 1 << 14
    while size < want and size < (1 << 24):
        size <<= 1
    return size


class BuildRanges:
    """A sorted build's dead-row count and live key range, read from the
    device once (at build finish), and its dense-domain histograms by
    size, each made on first use.  Handing this to ``probe_counts`` keeps
    the probe free of host reads."""

    def __init__(self, sorted_build: torch.Tensor):
        cap_b = sorted_build.shape[0]
        live_b = sorted_build >= 0
        if cap_b == 0:
            self.n_dead, self.bmin, self.bmax = 0, 0, -1
        else:
            # dead ids are negative and sort first: the live ones follow
            self.n_dead, self.bmin, self.bmax = torch.stack([
                cap_b - live_b.sum(),
                torch.where(live_b, sorted_build, 1 << 62).min(),
                sorted_build[-1]]).tolist()
        self.cap_b = cap_b
        self.live_b = live_b
        self.sorted_build = sorted_build
        self._hists = {}

    def dense(self, size: int):
        """``(hist, starts)`` over ``size`` slots from the live minimum,
        or None when the live span does not fit (or nothing is live)."""
        if self.n_dead >= self.cap_b or self.bmax - self.bmin >= size - 1:
            return None
        hit = self._hists.get(size)
        if hit is None:
            device = self.sorted_build.device
            off = torch.where(self.live_b, self.sorted_build - self.bmin,
                              size)
            hist = torch.zeros(size + 1, dtype=torch.int32, device=device)
            hist.index_add_(0, off, torch.ones(self.cap_b, dtype=torch.int32,
                                               device=device))
            hist = hist[:size]
            hit = self._hists[size] = (hist, torch.cumsum(hist, 0) - hist)
        return hit


def probe_counts(sorted_build: torch.Tensor, perm_b: torch.Tensor,
                 probe_ids: torch.Tensor,
                 ranges: Optional[BuildRanges] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-probe-row match range ``(lo, counts)`` in the sorted build
    order.

    When the live build-key span fits a histogram, match ranges come from
    two gathers into (hist, starts) tensors (the BigintGroupByHash
    dense-path idea applied to the probe); otherwise a vectorized binary
    search over the sorted build.  ``ranges`` (the build's
    ``BuildRanges``) picks the strategy with no host read; without it
    one read makes them here."""
    if ranges is None:
        ranges = BuildRanges(sorted_build)
    live_p = probe_ids >= 0
    S = _dense_scratch(sorted_build.shape[0], probe_ids.shape[0])
    dense = ranges.dense(S)
    if dense is not None:
        hist, starts_d = dense
        q = probe_ids - ranges.bmin
        in_rng = live_p & (q >= 0) & (q < S)
        qi = torch.clamp(q, 0, S - 1)
        cnt = torch.where(in_rng, hist[qi], 0)
        lo = torch.where(in_rng, ranges.n_dead + starts_d[qi], 0)
        return lo.to(torch.int64), cnt.to(torch.int64)
    lo = _lower_bound(sorted_build, probe_ids, inclusive=False)
    hi = _lower_bound(sorted_build, probe_ids, inclusive=True)
    cnt = torch.where(live_p, hi - lo, 0)
    return lo, cnt


def _expand_probe_idx(emit: torch.Tensor, out_capacity: int,
                      total: Optional[int] = None):
    """Map each output slot to its source probe row, search-free: mark
    each emitting row's start slot with +1, cumsum over the output space,
    and translate emit-rank back to row through a compacted index.
    ``total`` (the sum of ``emit``, when the caller has read it) saves a
    host read."""
    n = emit.shape[0]
    device = emit.device
    inclusive = torch.cumsum(emit, 0)
    if total is None:
        total = int(inclusive[-1]) if n else 0
    starts = inclusive - emit
    emitting = emit > 0
    # emit-rank -> probe row (rank r is the r-th emitting row)
    rows = torch.nonzero(emitting).squeeze(1)
    # +1 at each emitting row's first output slot (disjoint ranges ->
    # distinct starts); slots past out_capacity drop
    start_slots = torch.where(emitting & (starts < out_capacity), starts,
                              out_capacity)
    flag = torch.zeros(out_capacity + 1, dtype=torch.int32, device=device)
    flag.index_add_(0, start_slots, torch.ones(n, dtype=torch.int32,
                                               device=device))
    dense_rank = torch.cumsum(flag[:out_capacity], 0) - 1
    if rows.shape[0] == 0:
        probe_idx = torch.zeros(out_capacity, dtype=torch.int64,
                                device=device)
    else:
        probe_idx = rows[torch.clamp(dense_rank, 0, rows.shape[0] - 1)]
    return probe_idx, starts, total


def expand_matches(lo: torch.Tensor, counts: torch.Tensor,
                   perm_b: torch.Tensor, out_capacity: int,
                   total: Optional[int] = None):
    """Prefix-sum expansion: (probe_row, build_row) pairs of an inner
    join.  Returns (probe_idx, build_idx, row_valid, unmatched, total),
    each ``[out_capacity]``; ``total`` may exceed out_capacity (the caller
    sizes the output from ``counts`` first, and may pass that sum in)."""
    probe_idx, starts, total = _expand_probe_idx(counts, out_capacity,
                                                 total)
    device = lo.device
    j = torch.arange(out_capacity, device=device)
    k = j - starts[probe_idx]
    pos = torch.clamp(lo[probe_idx] + k, max=max(perm_b.shape[0] - 1, 0))
    build_idx = perm_b[pos] if perm_b.shape[0] else torch.zeros_like(pos)
    row_valid = j < total
    unmatched = torch.zeros(out_capacity, dtype=torch.bool, device=device)
    return probe_idx, build_idx, row_valid, unmatched, total


def expand_matches_outer(lo: torch.Tensor, counts: torch.Tensor,
                         live_probe: torch.Tensor, perm_b: torch.Tensor,
                         out_capacity: int, total: Optional[int] = None):
    """Left-outer expansion: every live probe row emits max(count, 1)
    rows; ``unmatched`` marks the rows whose build side is null."""
    emit = torch.where(live_probe, torch.clamp(counts, min=1), 0)
    probe_idx, starts, total = _expand_probe_idx(emit, out_capacity,
                                                 total)
    device = lo.device
    j = torch.arange(out_capacity, device=device)
    k = j - starts[probe_idx]
    unmatched = counts[probe_idx] == 0
    pos = torch.clamp(lo[probe_idx] + k, max=max(perm_b.shape[0] - 1, 0))
    build_idx = (torch.where(unmatched, 0, perm_b[pos])
                 if perm_b.shape[0] else torch.zeros_like(pos))
    row_valid = j < total
    return probe_idx, build_idx, row_valid, unmatched, total


def semi_mask(counts: torch.Tensor, live_probe: torch.Tensor
              ) -> torch.Tensor:
    """Semi join: the probe rows with a match (HashSemiJoinOperator
    analogue)."""
    return live_probe & (counts > 0)


def anti_keep_from_parts(counts: torch.Tensor, live_ids: torch.Tensor,
                         in_row: torch.Tensor, null_aware: bool,
                         probe_key_valids, n_build_rows: int,
                         build_has_null: torch.Tensor) -> torch.Tensor:
    """Which probe rows survive an anti join.

    NOT EXISTS (``null_aware=False``): keep every unmatched in-range row,
    null keys included (they never match anything).

    NOT IN (``null_aware=True``) follows SQL three-valued logic
    (HashSemiJoinOperator.java:47): an empty filtering side keeps every
    row; otherwise a NULL probe key or any NULL among the filtering keys
    makes the predicate UNKNOWN -> row excluded; matched rows are FALSE
    -> excluded; only non-null unmatched rows against a null-free side
    survive.  ``live_ids`` = the row could match (non-null AND, on the
    ``single`` tier, not below the build minimum); the probe key is
    non-null where every ``probe_key_valids`` mask (None = non-nullable)
    holds.  ``n_build_rows`` is the build's live row count (a host int),
    ``build_has_null`` the build's device bool scalar.
    """
    if not null_aware:
        return in_row & ((live_ids & (counts == 0)) | ~live_ids)
    if n_build_rows == 0:
        return in_row
    survive = in_row & (counts == 0) & ~build_has_null
    for v in probe_key_valids:
        if v is not None:
            survive = survive & v
    return survive


def any_pair_passes(probe_idx: torch.Tensor, ok: torch.Tensor,
                    n_probe: int) -> torch.Tensor:
    """Per probe row: does any of its (probe_idx, ok) pairs pass?  An
    integer count per row, then ``> 0``: the same result whatever order
    the scatter adds in (no float atomics)."""
    hits = torch.zeros(n_probe, dtype=torch.int32, device=ok.device)
    hits.index_add_(0, probe_idx, ok.to(torch.int32))
    return hits > 0
