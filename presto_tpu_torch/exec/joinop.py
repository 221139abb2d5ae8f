"""Hash join operators: build and probe sharing a LookupSource.

Reference models: HashBuilderOperator.java:51 (build side ->
PartitionedLookupSourceFactory), LookupJoinOperator.java:64 (probe) and
HashSemiJoinOperator (semi), with the inner, probe-outer (left), semi and
anti variants of LookupJoinOperators.java:45-60.

The LookupSource is chosen at build finish, as the JAX package's
accelerator branch chooses it (``presto_tpu/exec/joinop.py:246-353``):

- ``hash``: the PagesHash table of ops/hashtable.py (kernel B2 on a CUDA
  tensor).  Keys that are not single integer words always take it; packable
  keys take it on ``cuda`` (or anywhere with ``force_pages_hash``) when the
  build has at most ``device_join_probe_max_build_rows`` rows.  The build
  retries once at 4x capacity when the bounded probe cannot place its keys.
- ``single``: one integer-ish key channel; its values are the ids, sorted.
- ``packed``: multi-channel integer keys packed into one word by
  build-side [min, max] ranges; probe values outside a channel's range
  cannot match.

Every tier streams the probe: per probe batch, match ranges (lo, counts)
-> the exact output size -> one expansion -> gathers.  Within one probe
row, build rows of a key come out in build input order on every tier.
A semi or anti join keeps probe rows by a mask over the same (lo, counts):
one host read per probe batch (the selected count).  With a residual (a
correlated EXISTS / NOT EXISTS) the candidate pairs are expanded, in
chunks of probe rows when they are many, and the residual decides which
pass.  Every build records whether a live row has a NULL key (NOT IN's
three-valued logic).

The ``canonical`` tier (a union sort of both sides' keys), the spilled
(grace) build and grouped execution are ROADMAP A7, A8 and A9 and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, null_column
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import (
    Operator, OperatorFactory, device_concat,
)
from presto_tpu_torch.ops.join import BuildRanges


def _is_single_word_type(t: T.Type) -> bool:
    from presto_tpu_torch.ops.join import single_word_joinable

    return single_word_joinable(t, t.is_dictionary)


@dataclasses.dataclass
class LookupSource:
    """Build-side product handed to the probe operator."""

    mode: str                      # 'single' | 'packed' | 'hash' | 'empty'
    sorted_ids: Optional[torch.Tensor]   # int64 [cap_b] (single/packed)
    perm: Optional[torch.Tensor]         # int64 [cap_b]
    data: Optional[Batch]          # padded device build batch
    n_build: int
    key_channels: List[int]
    mins: Optional[np.ndarray] = None    # packed: per-channel min;
                                         # single: [build live min]
    strides: Optional[np.ndarray] = None  # packed: per-channel stride
    maxs: Optional[np.ndarray] = None
    # 'hash': (t_words, t_ctrl, starts, counts) whose (starts, counts)
    # index ``perm`` — the PagesHash role proper
    pages: Optional[tuple] = None
    key_types: Optional[tuple] = None     # probe-normalization types
    # device bool scalar: a live build row has a NULL key (NOT IN)
    has_null_key: Optional[torch.Tensor] = None
    # single/packed: the sorted ids' live range, read once at build
    ranges: Optional[BuildRanges] = None


class LookupSourceFactory:
    """Rendezvous between build and probe pipelines
    (PartitionedLookupSourceFactory analogue, single partition)."""

    def __init__(self):
        self.source: Optional[LookupSource] = None

    def set(self, source: LookupSource) -> None:
        self.source = source

    def get(self) -> LookupSource:
        if self.source is None:
            raise RuntimeError("build side not finished before probe "
                               "(pipeline ordering bug)")
        return self.source


def _dead_rows(pairs, num_rows: int) -> torch.Tensor:
    cap = pairs[0][0].shape[0]
    dead = torch.arange(cap, device=pairs[0][0].device) >= num_rows
    for _values, valid in pairs:
        if valid is not None:
            dead = dead | ~valid
    return dead


# a residual join expands at most this many candidate pairs at once (plus
# those of a chunk's first probe row)
RESIDUAL_CHUNK_PAIRS = 1 << 22


def _has_null_key(pairs, num_rows: int) -> torch.Tensor:
    """Device bool scalar: does a live row have a NULL key?  From the key
    validity, never from the ids (an id is also dead for padding)."""
    values = pairs[0][0]
    in_row = torch.arange(values.shape[0], device=values.device) < num_rows
    has = torch.zeros((), dtype=torch.bool, device=values.device)
    for _values, valid in pairs:
        if valid is not None:
            has = has | (in_row & ~valid).any()
    return has


def _build_index_single(values: torch.Tensor, valid, num_rows: int):
    """Single-word build: ids (value - min + 2, so negative keys map to
    valid ids and the sentinels own {-2, -1}), sorted index, the live
    minimum and the span-overflow flag (one host read)."""
    from presto_tpu_torch.ops import join as J

    dead = _dead_rows([(values, valid)], num_rows)
    v = values.to(torch.int64)
    bmin, span_big = 0, False
    if not bool(dead.all()):
        lo, hi = torch.aminmax(v[~dead])
        bmin = int(lo)
        span_big = int(hi) - bmin >= 1 << 62
    if span_big:
        return None, None, bmin, True
    ids = torch.where(dead, -2, v - bmin + 2)
    sb, perm = J.build_index(ids)
    return sb, perm, bmin, False


def _key_ranges(pairs, num_rows: int):
    """Per-key-channel live [min, max] (packed-mode ranges) as host
    int64 arrays; an empty build gives min > max."""
    base_dead = _dead_rows([(pairs[0][0], None)], num_rows)
    los, his = [], []
    for values, valid in pairs:
        dead = base_dead if valid is None else (base_dead | ~valid)
        v = values.to(torch.int64)
        los.append(torch.where(dead, 1 << 62, v).min())
        his.append(torch.where(dead, -(1 << 62), v).max())
    return (torch.stack(los).cpu().numpy(), torch.stack(his).cpu().numpy())


def _build_index_packed(pairs, mins: np.ndarray, strides: np.ndarray,
                        num_rows: int):
    """Packed multi-key build: mixed-radix ids + sorted index."""
    from presto_tpu_torch.ops import join as J

    dead = _dead_rows(pairs, num_rows)
    ids = torch.zeros(pairs[0][0].shape[0], dtype=torch.int64,
                      device=pairs[0][0].device)
    for i, (values, _valid) in enumerate(pairs):
        ids = ids + (values.to(torch.int64) - int(mins[i])) * int(strides[i])
    ids = torch.where(dead, -2, ids)
    return J.build_index(ids)


class HashBuildOperator(Operator):
    def __init__(self, ctx: OperatorContext,
                 factory: "HashBuildOperatorFactory"):
        super().__init__(ctx)
        self.f = factory
        factory._build_ctxs.append(ctx)
        self._batches: List[Batch] = []

    def close(self) -> None:
        # the LookupSource keeps the build data alive through the probe:
        # the probe side releases the reservation (factory.release)
        pass

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        self._batches.append(batch)
        self.ctx.memory.reserve(batch.size_bytes)

    def _on_accelerator(self, data: Batch) -> bool:
        return data.device.type == "cuda" or self.ctx.config.force_pages_hash

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        data = device_concat(self._batches,
                             self.ctx.config.min_batch_capacity)
        self._batches = []
        if self.f.dynamic_filter is not None:
            self.f.dynamic_filter.fill_from_build(data, self.f.key_channels)
        chans = self.f.key_channels
        if data is None:
            self.f.lookup.set(LookupSource("empty", None, None, None, 0,
                                           chans))
            return
        n_build = data.num_rows
        key_pairs = [(data.columns[c].values, data.columns[c].valid)
                     for c in chans]
        cfg = self.ctx.config
        packable = all(_is_single_word_type(data.columns[c].type)
                       for c in chans)
        want_hash = False
        if cfg.device_join_probe:
            if not packable:
                # keys with no integer id: the table is what lets the probe
                # stream at all
                want_hash = True
            elif (self._on_accelerator(data)
                    and n_build <= cfg.device_join_probe_max_build_rows):
                # the JAX package's accelerator branch: the table wins up to
                # the build-size bound (a huge build's inserts cost more
                # than one sort)
                want_hash = True
        if want_hash and self._set_pages_hash(data, key_pairs, chans,
                                              n_build):
            return
        if len(chans) == 1 and packable:
            sb, perm, bmin, span_big = _build_index_single(
                *key_pairs[0], n_build)
            if not span_big:
                self.f.lookup.set(LookupSource(
                    "single", sb, perm, data, n_build, chans,
                    mins=np.asarray([bmin], np.int64),
                    has_null_key=_has_null_key(key_pairs, n_build),
                    ranges=BuildRanges(sb)))
                return
        if packable:
            # pack multi-channel integer keys using build-side ranges
            los, his = _key_ranges(key_pairs, n_build)
            if bool((los > his).any()):            # no live rows
                los = np.zeros_like(los)
                his = np.zeros_like(his)
            strides = []
            span_product = 1
            for lo, hi in zip(los, his):
                strides.append(span_product)
                span_product *= int(hi) - int(lo) + 1
            if span_product < (1 << 62):
                strides_a = np.asarray(strides, np.int64)
                sb, perm = _build_index_packed(key_pairs, los, strides_a,
                                               n_build)
                self.f.lookup.set(LookupSource(
                    "packed", sb, perm, data, n_build, chans, mins=los,
                    strides=strides_a, maxs=his,
                    has_null_key=_has_null_key(key_pairs, n_build),
                    ranges=BuildRanges(sb)))
                return
        # key spans overflowed the single/packed id arithmetic: the hash
        # table still streams such keys (equality needs no ids)
        if (cfg.device_join_probe and not want_hash
                and self._set_pages_hash(data, key_pairs, chans, n_build)):
            return
        raise NotImplementedError(
            "join keys that need the canonical tier (a union sort of both "
            "sides) are not in presto_tpu_torch yet: ROADMAP A7 (canonical "
            "join tier)")

    def _set_pages_hash(self, data: Batch, key_pairs, chans,
                        n_build: int) -> bool:
        """Build and publish the PagesHash lookup source; False when the
        bounded probe could not place the build keys (adversarial chains:
        one retry at 4x capacity quarters the load first)."""
        from presto_tpu_torch.ops.hashtable import pages_hash_build

        table_cap = max(2 * data.capacity, 1024)
        ktypes = tuple(data.columns[c].type for c in chans)
        kc = [(v, valid, t) for (v, valid), t in zip(key_pairs, ktypes)]
        for cap in (table_cap, 4 * table_cap):
            # null-key rows are dead rows of the table: has_null comes
            # from the key validity
            (tw, tctrl, starts, counts, perm, has_null,
             ok) = pages_hash_build(kc, n_build, cap)
            if ok:
                self.ctx.stats.kernel_tier = "hash"
                self.f.lookup.set(LookupSource(
                    "hash", None, perm, data, n_build, chans,
                    pages=(tw, tctrl, starts, counts), key_types=ktypes,
                    has_null_key=has_null))
                return True
        return False

    def get_output(self) -> Optional[Batch]:
        return None

    def is_finished(self) -> bool:
        return self._finishing


class HashBuildOperatorFactory(OperatorFactory):
    def __init__(self, key_channels: Sequence[int],
                 input_types: Sequence[T.Type], dynamic_filter=None):
        self.key_channels = list(key_channels)
        self.input_types = list(input_types)
        self.lookup = LookupSourceFactory()
        self.dynamic_filter = dynamic_filter
        self._build_ctxs: List[OperatorContext] = []

    def create(self, ctx: OperatorContext) -> HashBuildOperator:
        return HashBuildOperator(ctx, self)

    def release(self) -> None:
        """Drop the lookup source and the build-side reservation (called
        when the probe finishes).  Idempotent."""
        self.lookup.source = None
        ctxs, self._build_ctxs = self._build_ctxs, []
        for ctx in ctxs:
            ctx.memory.free()


def _ids_from_pairs(pairs, key_channels, src: LookupSource,
                    num_rows: int) -> torch.Tensor:
    """Probe ids for the 'single' and 'packed' modes."""
    dead = _dead_rows([pairs[c] for c in key_channels], num_rows)
    if src.mode == "single":
        # probe values below the build minimum cannot match: dead sentinel
        ids = pairs[key_channels[0]][0].to(torch.int64) - int(src.mins[0]) + 2
        return torch.where(dead | (ids < 0), -1, ids)
    ids = torch.zeros_like(dead, dtype=torch.int64)
    for i, c in enumerate(key_channels):
        v = pairs[c][0].to(torch.int64)
        lo, hi = int(src.mins[i]), int(src.maxs[i])
        dead = dead | (v < lo) | (v > hi)
        ids = ids + (v - lo) * int(src.strides[i])
    return torch.where(dead, -1, ids)


class LookupJoinOperator(Operator):
    """Probe side.  Output layout: all probe channels, then all build
    channels (the planner projects away what it does not need); a semi or
    anti join emits the probe channels only."""

    def __init__(self, ctx: OperatorContext,
                 factory: "LookupJoinOperatorFactory"):
        super().__init__(ctx)
        self.f = factory
        self._out: List[Batch] = []
        self._residuals = {}   # dictionary binding -> compiled residual

    def close(self) -> None:
        super().close()
        self.f.build.release()

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        src = self.f.build.lookup.get()
        if src.data is not None and batch.device != src.data.device:
            raise ValueError(f"probe rows on {batch.device} meet a build "
                             f"on {src.data.device}")
        if not self.ctx.stats.kernel_tier:
            self.ctx.stats.kernel_tier = (
                "hash" if src.mode == "hash" else "sorted")
        if self.f.join_type in ("semi", "anti"):
            out = self._probe_filter(src, batch)
        else:
            out = self._probe_streaming(src, batch)
        if out is not None and out.num_rows > 0:
            self.ctx.stats.output_rows += out.num_rows
            self._out.append(out)

    def _lo_counts(self, src: LookupSource, batch: Batch):
        """Per-probe-row match range into ``src.perm``, and which rows
        could match at all (non-null keys, in range)."""
        from presto_tpu_torch.ops import join as J

        chans = self.f.probe_key_channels
        pairs = [(c.values, c.valid) for c in batch.columns]
        if src.mode == "hash":
            from presto_tpu_torch.ops.hashtable import pages_hash_probe

            kc = [(pairs[c][0], pairs[c][1], src.key_types[i])
                  for i, c in enumerate(chans)]
            return pages_hash_probe(src.pages, kc, batch.num_rows)
        ids = _ids_from_pairs(pairs, chans, src, batch.num_rows)
        lo, counts = J.probe_counts(src.sorted_ids, src.perm, ids,
                                    src.ranges)
        return lo, counts, ids >= 0

    def _probe_streaming(self, src: LookupSource,
                         batch: Batch) -> Optional[Batch]:
        from presto_tpu_torch.ops import join as J

        join_type = self.f.join_type
        n = batch.num_rows
        device = batch.device
        if src.mode == "empty":
            if join_type == "inner":
                return None
            cols = [c.head(n) for c in batch.columns]
            cols += [null_column(t, n, device)
                     for t in self.f.build.input_types]
            return Batch(tuple(cols), n)
        lo, counts, _live = self._lo_counts(src, batch)
        if join_type == "left":
            # every real probe row emits >= 1 row (null-key rows emit the
            # unmatched form)
            in_row = torch.arange(batch.capacity, device=device) < n
            total = int(torch.where(in_row, torch.clamp(counts, min=1),
                                    0).sum())
            pi, bi, _rv, unmatched, total = J.expand_matches_outer(
                lo, counts, in_row, src.perm, total, total=total)
        else:
            total = int(counts.sum())
            if total == 0:
                return None
            pi, bi, _rv, unmatched, total = J.expand_matches(
                lo, counts, src.perm, total, total=total)
        cols = [c.take(pi) for c in batch.columns]
        for c in src.data.columns:
            taken = c.take(bi)
            if join_type != "inner":
                taken = taken.with_values(taken.values, ~unmatched
                                          if taken.valid is None else
                                          taken.valid & ~unmatched)
            cols.append(taken)
        return Batch(tuple(cols), total)

    def _probe_filter(self, src: LookupSource,
                      batch: Batch) -> Optional[Batch]:
        """Semi/anti join: the probe rows that survive, in order.  Without
        a residual the one host read is the selected count."""
        from presto_tpu_torch.ops import join as J
        from presto_tpu_torch.ops.filter import selected_positions

        anti = self.f.join_type == "anti"
        n = batch.num_rows
        in_row = torch.arange(batch.capacity, device=batch.device) < n
        if src.mode == "empty":
            # nothing to match: a semi join keeps no row, an anti join
            # (NOT EXISTS and NOT IN alike) every row
            if not anti:
                return None
            mask = in_row
        else:
            lo, counts, live = self._lo_counts(src, batch)
            if self.f.residual is not None:
                passes = self._residual_passes(src, batch, lo, counts)
                # a residual anti join is a correlated NOT EXISTS:
                # null-key rows never match, so they stay
                mask = ((live & ~passes) | (~live & in_row) if anti
                        else live & passes)
            elif anti:
                mask = J.anti_keep_from_parts(
                    counts, live, in_row, self.f.null_aware,
                    [batch.columns[c].valid
                     for c in self.f.probe_key_channels],
                    src.n_build, build_has_null=src.has_null_key)
            else:
                mask = J.semi_mask(counts, live)
        return batch.take(selected_positions(mask, None, n))

    def _residual_compiled(self, src: LookupSource, batch: Batch):
        """The residual over [probe channels..., build channels...],
        compiled with both sides' dictionaries
        (JoinFilterFunctionCompiler role), once per binding."""
        from presto_tpu_torch.expr.compile import ExprCompiler

        key = (id(src),) + tuple(
            None if c.dictionary is None else c.dictionary.token
            for c in batch.columns)
        hit = self._residuals.get(key)
        if hit is None:
            nprobe = batch.num_columns
            dicts = {i: c.dictionary for i, c in enumerate(batch.columns)
                     if c.dictionary is not None}
            for j, c in enumerate(src.data.columns):
                if c.dictionary is not None:
                    dicts[nprobe + j] = c.dictionary
            hit = self._residuals[key] = ExprCompiler(dicts).compile(
                self.f.residual)
        return hit

    def _residual_passes(self, src: LookupSource, batch: Batch,
                         lo: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
        """Per probe row: does any of its candidate pairs pass the
        residual?  The pairs are expanded in chunks of probe rows, each
        holding at most ``RESIDUAL_CHUNK_PAIRS`` pairs plus those of its
        first row, so a large batch never allocates all of its pairs at
        once."""
        from presto_tpu_torch.expr.xp import TorchXp
        from presto_tpu_torch.ops import join as J

        device = batch.device
        cap = batch.capacity
        passes = torch.zeros(cap, dtype=torch.bool, device=device)
        cum = torch.cumsum(counts, 0)
        total = int(cum[-1]) if cap else 0
        if total == 0:
            return passes
        bound = RESIDUAL_CHUNK_PAIRS
        if total <= bound:
            chunks = [(0, cap, total)]
        else:
            marks = torch.arange(bound, total, bound, device=device)
            cuts = torch.cat([
                torch.zeros(1, dtype=torch.int64, device=device),
                torch.searchsorted(cum, marks, right=True),
                torch.full((1,), cap, dtype=torch.int64, device=device)])
            cum0 = torch.cat([torch.zeros(1, dtype=cum.dtype,
                                          device=device), cum])
            starts, ends = cuts[:-1], cuts[1:]
            sizes = cum0[ends] - cum0[starts]
            chunks = [c for c in zip(*torch.stack(
                [starts, ends, sizes]).tolist()) if c[2] > 0]
        cres = self._residual_compiled(src, batch)
        xp = TorchXp(device)
        for a, b, size in chunks:
            pi, bi, _rv, _u, _t = J.expand_matches(
                lo[a:b], counts[a:b], src.perm, size, total=size)
            pi = pi + a
            pairs = [(c.values[pi], None if c.valid is None
                      else c.valid[pi]) for c in batch.columns]
            pairs += [(c.values[bi], None if c.valid is None
                       else c.valid[bi]) for c in src.data.columns]
            rmask, rvalid = cres.run(pairs, size, xp)
            ok = torch.broadcast_to(xp.asarray(rmask), (size,))
            if rvalid is not None:
                ok = ok & xp.asarray(rvalid)
            passes = passes | J.any_pair_passes(pi, ok, cap)
        return passes

    def get_output(self) -> Optional[Batch]:
        if self._out:
            return self._out.pop(0)
        return None

    def is_finished(self) -> bool:
        return self._finishing and not self._out


class LookupJoinOperatorFactory(OperatorFactory):
    def __init__(self, build: HashBuildOperatorFactory,
                 probe_key_channels: Sequence[int],
                 probe_types: Sequence[T.Type],
                 join_type: str = "inner", residual=None,
                 null_aware: bool = False):
        """``residual``: a semi/anti join's in-kernel filter over [probe
        channels..., build channels...] (an inner join's is a post-join
        filter the planner adds); ``null_aware``: NOT IN's three-valued
        anti join."""
        if join_type not in ("inner", "left", "semi", "anti"):
            raise ValueError(f"unknown join type {join_type}")
        if residual is not None and join_type not in ("semi", "anti"):
            raise NotImplementedError(
                "residual filters only on semi/anti joins")
        self.build = build
        self.probe_key_channels = list(probe_key_channels)
        self.probe_types = list(probe_types)
        self.join_type = join_type
        self.residual = residual
        self.null_aware = null_aware

    def create(self, ctx: OperatorContext) -> LookupJoinOperator:
        return LookupJoinOperator(ctx, self)
