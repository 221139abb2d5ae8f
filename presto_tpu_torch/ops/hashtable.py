"""Device-resident open-addressing hash tables.

The reference's two hottest hash structures are ``MultiChannelGroupByHash``
(open-addressing linear probing with rehash,
presto-main/.../operator/MultiChannelGroupByHash.java:273-286) and
``PagesHash`` (the join lookup table, PagesHash.java:63-121).  Both walk a
power-of-two table with a **1-byte hash-prefix reject** (PagesHash.java:49:
a probe compares one hash byte before paying the full key comparison).
This module is the port of the JAX package's ``ops/hashtable.py``: tables
are tensors that live on the device across batches.

Table layout (one layout for the plain version and the CUDA kernel):

- ``t_words``: int64 ``[cap, k]``, the normalized key words of each slot,
  row-major so that one slot's words are adjacent;
- ``t_ctrl``: int32 ``[cap]``, one control word per slot: ``EMPTY`` (0),
  ``CLAIMED`` (1, only while the kernel installs a key) or
  ``READY | prefix`` once the key is in place.  The 1-byte prefix lives
  in the control word, so the reject test reads one array.

Every function that inserts or looks up goes through the wrappers of
``ops/probe_insert.py``: on a CUDA tensor the hand-written kernel B2
(``csrc/probe_insert.cu``), on a CPU tensor the plain versions below,
``probe_insert`` and ``probe_find``.  Those are the JAX package's
data-parallel claim loop, round for round: every unresolved row gathers
its slot's control word, rejects on the prefix, compares the full words
only where the prefix agrees, and rows that see an empty slot claim it by
scatter-min of their row id (one winner per slot).  The claim loop is
deterministic and gives the JAX package's slot ids.  The kernel gives the
same group partition (same key -> same slot, distinct keys -> distinct
slots) but its slot ids depend on which thread wins a contended slot, so
they may change from run to run.  Nothing downstream depends on slot ids
beyond the order of un-sorted output rows: per-group float sums are taken
in row order (``ops/groupby.py sorted_segment_sums``).

Tables are updated in place (the JAX package returns new arrays).  When an
insert reports ``ok=False`` some keys of that batch may already be
installed; ``groupby_update`` then sets exactly the slots the insert
claimed (its journal) back to empty, so a failed update leaves the state
as the JAX package's caller keeps it (its old state), and nothing is
accumulated.

The hash is computed in int64: torch has no ``>>`` or ``<`` for uint64,
so logical right shifts are masked arithmetic shifts and the wrapping
multiplies run in two's complement.  The bits equal the JAX package's
uint64 hash.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch.ops import probe_insert as B2
from presto_tpu_torch.ops.groupby import (
    _max_identity, _min_identity, fixed_order_segment_sums,
    scatter_extreme_,
)
from presto_tpu_torch.ops.keys import normalize_keys, to_sortable_i64

EMPTY = 0
CLAIMED = 1
READY = 0x100              # a ready slot's control word is READY | prefix

# distinct seed from the partitioning hash: a key must not land in the same
# table slot pattern as its exchange partition
_SEED = 0x2545F4914F6CDD1D


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = _signed(0xFF51AFD7ED558CCD)
_M2 = _signed(0xC4CEB9FE1A85EC53)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (uint64 ``x >> s``)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _shr(x, 33)) * _M1
    x = (x ^ _shr(x, 33)) * _M2
    return x ^ _shr(x, 33)


def hash_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """The 64-bit hash per row over normalized int64 key words, as the
    int64 with the bits of the JAX package's uint64 hash."""
    acc = torch.full((words[0].shape[0],), _SEED, dtype=torch.int64,
                     device=words[0].device)
    for w in words:
        acc = _mix64(acc ^ w.to(torch.int64))
    return acc


def slot_and_prefix(h: torch.Tensor, cap: int):
    """(initial slot int32, 1-byte prefix uint8) from the row hash.  The
    slot comes from the LOW bits and the prefix from the HIGH byte, so the
    reject byte stays independent of the slot index (PagesHash.java:49)."""
    slot = (h & (cap - 1)).to(torch.int32)
    prefix = _shr(h, 56).to(torch.uint8)
    return slot, prefix


def empty_table(cap: int, n_words: int, device) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """A fresh ``(t_words, t_ctrl)`` table of ``cap`` slots."""
    if cap < 1 or cap & (cap - 1):
        raise ValueError(f"table capacity {cap} is not a power of two")
    return (torch.zeros((cap, n_words), dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int32, device=device))


def used_slots(t_ctrl: torch.Tensor) -> torch.Tensor:
    """bool ``[cap]``: the slots that hold a key."""
    return t_ctrl != EMPTY


def _stack(key_words: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([w.to(torch.int64) for w in key_words], 1)


# ---------------------------------------------------------------------------
# The plain versions of kernel B2: the claim loop
# ---------------------------------------------------------------------------

def probe_insert(keys: torch.Tensor, live: torch.Tensor,
                 t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """Insert-or-find every live row's key (``keys`` int64 ``[N, k]``),
    updating the table in place.

    Returns ``(slot [N] int32, ok)``: dead rows get slot == cap (a drop
    sentinel for downstream scatters); ``ok`` is False when the bounded
    loop could not place every row (the table is effectively full: the
    caller rehashes bigger and retries; nothing was accumulated)."""
    cap = t_ctrl.shape[0]
    n = keys.shape[0]
    device = keys.device
    slot0, prefix = slot_and_prefix(hash_words(keys.unbind(1)), cap)
    want = READY | prefix.to(torch.int32)
    rowid = torch.arange(n, device=device)
    slot = slot0.to(torch.int64)
    out = torch.full((n,), cap, dtype=torch.int32, device=device)
    unresolved = live.clone()
    # a row needs at most its probe-chain length in rounds; a full table
    # would spin for cap rounds, so the bound trips first and the caller
    # rehashes (which halves the load) and retries
    max_rounds = min(cap, 256)
    for _ in range(max_rounds):
        if not bool(unresolved.any()):
            break
        ctrl_g = t_ctrl[slot]
        used_g = ctrl_g != EMPTY
        # 1-byte prefix reject: the full word compare only counts where
        # the stored prefix agrees
        eq = (ctrl_g == want) & (t_words[slot] == keys).all(1)
        match = unresolved & eq
        empty = unresolved & ~used_g
        claim = torch.full((cap + 1,), n, dtype=torch.int64, device=device)
        claim.scatter_reduce_(0, torch.where(empty, slot, cap), rowid,
                              "amin")
        winner = empty & (claim[slot] == rowid)
        wslot = slot[winner]
        t_ctrl[wslot] = want[winner]
        t_words[wslot] = keys[winner]
        resolved = match | winner
        out = torch.where(resolved, slot.to(torch.int32), out)
        unresolved = unresolved & ~resolved
        # rows that saw a DIFFERENT occupied key advance (linear probing);
        # claim losers stay: their slot now holds the winner's key, which
        # may equal theirs
        advance = unresolved & used_g & ~eq
        slot = torch.where(advance, (slot + 1) & (cap - 1), slot)
    return out, not bool(unresolved.any())


def probe_find(keys: torch.Tensor, live: torch.Tensor,
               t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """Read-only probe: ``(slot [N] int32, found [N] bool)``.  A row is
    resolved when it matches an entry (found) or hits an empty slot (not
    found, slot = that empty slot).  Dead rows are not found."""
    cap = t_ctrl.shape[0]
    n = keys.shape[0]
    device = keys.device
    slot0, prefix = slot_and_prefix(hash_words(keys.unbind(1)), cap)
    want = READY | prefix.to(torch.int32)
    slot = slot0.to(torch.int64)
    unresolved = live.clone()
    found = torch.zeros(n, dtype=torch.bool, device=device)
    for _ in range(cap + 1):
        if not bool(unresolved.any()):
            break
        ctrl_g = t_ctrl[slot]
        eq = (ctrl_g == want) & (t_words[slot] == keys).all(1)
        match = unresolved & eq
        empty = unresolved & (ctrl_g == EMPTY)
        found = found | match
        unresolved = unresolved & ~(match | empty)
        slot = torch.where(unresolved, (slot + 1) & (cap - 1), slot)
    return slot.to(torch.int32), found


# ---------------------------------------------------------------------------
# GroupByHash: device-resident grouped-aggregation state
# ---------------------------------------------------------------------------
# State: (t_words, t_ctrl, keyvals, aggs, n_groups)
#   keyvals:  per key COLUMN, (values, valid|None) in the input dtype — the
#             representative values extract() emits (input batches are not
#             retained)
#   aggs:     per aggregation, (acc, nonnull_count) in the accumulation
#             dtypes the sort tier uses
#   n_groups: the occupied slots, a host int kept from the inserts' claim
#             counts (so an update reads no table to count them)

def groupby_init(cap: int, n_words: int, key_dtypes: Sequence[torch.dtype],
                 key_nullable: Sequence[bool],
                 agg_specs: Sequence[Tuple[str, Optional[torch.dtype]]],
                 device):
    """Fresh empty state.  ``agg_specs`` is (prim, value_dtype|None) per
    aggregation (None == count(*))."""
    t_words, t_ctrl = empty_table(cap, n_words, device)
    keyvals = []
    for dt, nullable in zip(key_dtypes, key_nullable):
        vals = torch.zeros(cap, dtype=dt, device=device)
        keyvals.append((vals, torch.zeros(cap, dtype=torch.bool,
                                          device=device)
                        if nullable else None))
    aggs = []
    for prim, dt in agg_specs:
        nn = torch.zeros(cap, dtype=torch.int64, device=device)
        if prim == "count" or dt is None:
            aggs.append((torch.zeros(cap, dtype=torch.int64, device=device),
                         nn))
        elif prim == "sum":
            aggs.append((torch.zeros(cap, dtype=dt, device=device), nn))
        elif prim == "min":
            aggs.append((torch.full((cap,), _min_identity(dt), dtype=dt,
                                    device=device), nn))
        elif prim == "max":
            aggs.append((torch.full((cap,), _max_identity(dt), dtype=dt,
                                    device=device), nn))
        else:
            raise ValueError(f"unknown aggregation primitive {prim}")
    return t_words, t_ctrl, tuple(keyvals), tuple(aggs), 0


def groupby_update(state, key_columns, agg_ins, num_rows: int,
                   live_mask: Optional[torch.Tensor] = None):
    """One batch's accumulate into resident state.

    ``key_columns``: [(values, valid|None, type)]; ``agg_ins``:
    [(prim, values|None, valid|None)].  Returns ``(state, n_groups, ok)``.
    When ``ok`` is False the table was too full to place this batch's
    keys and the state is as it was before the call: the keys the batch
    placed before the probe bound tripped are taken out again (else they
    would be extracted as groups with no rows) and nothing is
    accumulated.  The caller rehashes and retries the same batch.

    Float sums add each group's batch partial, itself summed in row order
    (``sorted_segment_sums``), so the sums are the same bits on every run
    whatever slot ids the kernel hands out.
    """
    t_words, t_ctrl, keyvals, aggs, n_groups = state
    cap_rows = key_columns[0][0].shape[0]
    device = key_columns[0][0].device
    live = torch.arange(cap_rows, device=device) < num_rows
    if live_mask is not None:
        live = live & live_mask
    # key words against the STATE's nullability spec, not this batch's: a
    # batch whose column arrives all-valid (valid=None) must still give
    # the null-flag word the table was keyed with
    kw = []
    for (values, valid, typ), (_kv, kvalid) in zip(key_columns, keyvals):
        w = to_sortable_i64(values, typ)
        if kvalid is not None:
            vm = valid if valid is not None else torch.ones(
                cap_rows, dtype=torch.bool, device=device)
            kw.append(torch.where(vm, w, torch.zeros_like(w)))
            kw.append((~vm).to(torch.int64))
        else:
            kw.append(w)
    slot, ok, n_new, journal = B2.insert_claims(_stack(kw), live, t_words,
                                                t_ctrl)
    if not ok:
        # take the batch's keys out again: a slot whose control word is
        # EMPTY is free whatever its stale key words hold
        t_ctrl[journal[journal >= 0].to(torch.int64)] = EMPTY
        return state, n_groups, False
    n_groups += n_new
    slot = slot.to(torch.int64)
    rows = torch.nonzero(live).squeeze(1)
    srows = slot[rows]
    for (values, valid, _t), (kv, kvalid) in zip(key_columns, keyvals):
        # rows of one slot hold equal key words, hence equal values
        kv[srows] = values[rows].to(kv.dtype)
        if kvalid is not None:
            kvalid[srows] = (True if valid is None else valid[rows])
    for (prim, values, valid), (acc, nn) in zip(agg_ins, aggs):
        lv = live if valid is None else (live & valid)
        r = torch.nonzero(lv).squeeze(1)
        s = slot[r]
        nn.index_add_(0, s, torch.ones_like(s))
        if prim == "count" or values is None:
            acc.index_add_(0, s, torch.ones_like(s))
        elif prim == "sum":
            v = values[r].to(acc.dtype)
            if acc.dtype.is_floating_point:
                ids, part = fixed_order_segment_sums(s, v)
                acc[ids] += part
            else:
                acc.index_add_(0, s, v)      # exact: any order will do
        elif prim in ("min", "max"):
            scatter_extreme_(acc, s, values[r], prim)
        else:
            raise ValueError(f"unknown aggregation primitive {prim}")
    return (t_words, t_ctrl, keyvals, aggs, n_groups), n_groups, True


def groupby_rehash(state, new_cap: int, prims: Sequence[str] = ()):
    """Re-insert every occupied entry into a ``new_cap`` table, carrying
    key values and accumulated state (the MultiChannelGroupByHash
    ``rehash()`` role).  Returns ``(state', ok)``.

    ``prims`` names each aggregation's primitive: slots not carried start
    at the prim's identity (min -> +inf, max -> -inf), or a group first
    installed after the rehash would fold a stale zero into its min/max."""
    t_words, t_ctrl, keyvals, aggs, _n_groups = state
    device = t_words.device
    if not prims:
        prims = ["sum"] * len(aggs)
    key_dtypes = [kv.dtype for kv, _ in keyvals]
    key_nullable = [kvalid is not None for _, kvalid in keyvals]
    agg_specs = [(prim, acc.dtype) for prim, (acc, _nn) in zip(prims, aggs)]
    new = groupby_init(new_cap, t_words.shape[1], key_dtypes, key_nullable,
                       agg_specs, device)
    nwords, nctrl, nkeyvals, naggs, _zero = new
    old = torch.nonzero(used_slots(t_ctrl)).squeeze(1)
    keys = t_words[old]
    slot, ok = B2.insert(keys, torch.ones(old.shape[0], dtype=torch.bool,
                                          device=device), nwords, nctrl)
    if not ok:
        return new, False
    s = slot.to(torch.int64)
    for (kv, kvalid), (nkv, nkvalid) in zip(keyvals, nkeyvals):
        nkv[s] = kv[old]
        if nkvalid is not None:
            nkvalid[s] = kvalid[old]
    for (acc, nn), (nacc, nnn) in zip(aggs, naggs):
        nacc[s] = acc[old]
        nnn[s] = nn[old]
    return (nwords, nctrl, nkeyvals, naggs, int(old.shape[0])), True


def groupby_extract(state):
    """The occupied slots, in slot order.

    Returns ``(n_groups, key_outs, agg_outs)``: ``key_outs`` are
    (values, valid|None) pairs and ``agg_outs`` (acc, nonnull_count)
    pairs, each ``[n_groups]`` — the (values, cnt) contract of the sort
    tier, so callers share the output-building code."""
    t_words, t_ctrl, keyvals, aggs, _n_groups = state
    idx = torch.nonzero(used_slots(t_ctrl)).squeeze(1)
    key_outs = [(kv[idx], None if kvalid is None else kvalid[idx])
                for kv, kvalid in keyvals]
    agg_outs = [(acc[idx], nn[idx]) for acc, nn in aggs]
    return int(idx.shape[0]), key_outs, agg_outs


# ---------------------------------------------------------------------------
# PagesHash: join build/probe over the same table layout
# ---------------------------------------------------------------------------

def pages_hash_build(key_columns, num_rows: int, cap: int):
    """Build the lookup table over the build side's raw key words.

    The table is keyed on EQUALITY of normalized words, not order, so it
    serves any multi-channel key types.  Duplicate keys need no
    PositionLinks chains: build rows are grouped per distinct key by a
    stable sort of their slot ids, and each slot carries its group's
    (start, count) range into that order.

    Returns ``(t_words, t_ctrl, starts, counts, perm, has_null, ok)``:
    ``starts[slot]``/``counts[slot]`` index ``perm`` as the sorted tier's
    (lo, counts) index its build permutation, so the expansion functions
    of ops/join.py are shared.  Within a key, build rows keep their input
    order.
    """
    cap_b = key_columns[0][0].shape[0]
    device = key_columns[0][0].device
    in_row = torch.arange(cap_b, device=device) < num_rows
    kw, null_row = normalize_keys(key_columns, nulls_equal=False)
    live = in_row if null_row is None else (in_row & ~null_row)
    has_null = (torch.zeros((), dtype=torch.bool, device=device)
                if null_row is None else (in_row & null_row).any())
    t_words, t_ctrl = empty_table(cap, len(kw), device)
    slot, ok = B2.insert(_stack(kw), live, t_words, t_ctrl)
    sslot = torch.where(live, slot.to(torch.int64), cap)
    counts = torch.zeros(cap + 1, dtype=torch.int32, device=device)
    counts.index_add_(0, sslot, torch.ones(cap_b, dtype=torch.int32,
                                           device=device))
    counts = counts[:cap]
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    # group build rows by slot (dead rows last), input order within a slot
    perm = torch.argsort(sslot, stable=True)
    return t_words, t_ctrl, starts, counts, perm, has_null, ok


def pages_hash_probe(table, probe_key_columns, num_rows: int):
    """``(lo, counts, live)`` per probe row against a pages_hash_build
    table.

    ``lo``/``counts`` satisfy the expand_matches contract of ops/join.py
    (positions into the build perm); ``live`` marks the probe rows that
    could match (non-null keys, in-row)."""
    t_words, t_ctrl, starts, counts_t = table
    cap_p = probe_key_columns[0][0].shape[0]
    device = probe_key_columns[0][0].device
    in_row = torch.arange(cap_p, device=device) < num_rows
    kw, null_row = normalize_keys(probe_key_columns, nulls_equal=False)
    live = in_row if null_row is None else (in_row & ~null_row)
    lo, cnt = B2.lookup_ranges(_stack(kw), live, t_words, t_ctrl, starts,
                               counts_t)
    return lo, cnt, live
