"""Aggregation operators.

Reference models: HashAggregationOperator.java:48 (grouped) and
AggregationOperator.java:35 (global).  Both materialize their input (as
the reference's builders do) and reduce once at finish.

Grouped aggregation runs three tiers, chosen as the JAX package chooses
them (``presto_tpu/exec/aggregation.py:253-505``):

- **direct**: every key is a bounded domain (dictionary codes, booleans)
  whose packed product is small, so the group id is arithmetic and the
  reduction is ``ops.groupby.direct_grouped_aggregate`` (its small-domain
  float sums go through the hand-written kernel of ``ops/segment_sums.py``);
- **hash**: once the input reaches ``hash_groupby_min_rows``, group state
  lives on the device across batches in the GroupByHash table of
  ``ops/hashtable.py`` (kernel B2 on a CUDA tensor), with a rehash ladder
  up to ``hash_groupby_max_slots`` and an exact overflow seam to the sort
  tier;
- **sort**: ``ops.groupby.grouped_aggregate`` over the materialized
  input, for everything else.

Streaming aggregation over key-clustered scans is exec/streamagg.py.
Spilling and the host-side collect/sketch aggregates are ROADMAP A8 and
A5: a plan that needs them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import (
    Operator, OperatorFactory, device_concat,
)
from presto_tpu_torch.expr.xp import torch_dtype


@dataclasses.dataclass(frozen=True)
class AggChannel:
    """One primitive reduction: prim in {'sum','count','min','max'},
    over input channel ``channel`` (None == count(*))."""

    prim: str
    channel: Optional[int]
    out_type: T.Type


_DEVICE_PRIMS = ("sum", "count", "min", "max")


def _check_prims(aggs: Sequence[AggChannel]) -> None:
    for a in aggs:
        if a.prim not in _DEVICE_PRIMS:
            raise NotImplementedError(
                f"aggregate primitive {a.prim}: ROADMAP A5 ports the "
                "host-side collect/sketch aggregates")


def _minmax_dict_input(a: AggChannel, col: Column):
    """min/max over a dictionary column reduce *lexicographic ranks* (codes
    are interning order, not sort order); the returned postprocess maps the
    winning rank back to a code and reattaches the dictionary."""
    if a.prim not in ("min", "max") or col.dictionary is None:
        return col.values, None
    device = col.values.device
    ranks = torch.from_numpy(col.dictionary.sort_ranks()).to(device)
    order = torch.from_numpy(
        np.argsort(col.dictionary.sort_ranks()).astype(np.int32)).to(device)
    vals = ranks[col.values.long()]
    dictionary = col.dictionary

    def post(agg_ranks: torch.Tensor):
        idx = torch.clamp(agg_ranks, 0, len(order) - 1).long()
        return order[idx], dictionary

    return vals, post


def _agg_inputs(aggs: Sequence[AggChannel], data: Batch):
    """(prim, values, valid) per aggregation plus its postprocess."""
    agg_ins, posts = [], []
    for a in aggs:
        if a.channel is None:
            agg_ins.append(("count", None, None))   # count(*): no values
            posts.append(None)
        else:
            col = data.columns[a.channel]
            vals, post = _minmax_dict_input(a, col)
            agg_ins.append((a.prim, vals, col.valid))
            posts.append(post)
    return agg_ins, posts


# merge primitive per partial-state component (the Step.FINAL half of
# HashAggregationOperator.Step:61): re-aggregating a pre-reduced partial
# state with these gives the answer of aggregating the raw rows
MERGE_PRIM = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


class HashAggregationOperator(Operator):
    def __init__(self, ctx: OperatorContext, group_channels: Sequence[int],
                 aggs: Sequence[AggChannel], input_types: Sequence[T.Type]):
        super().__init__(ctx)
        _check_prims(aggs)
        self.group_channels = list(group_channels)
        self.aggs = list(aggs)
        self.input_types = list(input_types)
        self._batches: List[Batch] = []
        self._outputs: List[Batch] = []
        self._accumulated_rows = 0
        # resident GroupByHash tier (ops/hashtable.py): state lives on the
        # device ACROSS batches; decided once, when the input crosses
        # hash_groupby_min_rows
        self._hash_decided = False
        self._hash_state = None
        self._hash_cap = 0
        self._hash_key_meta = None   # [(type, dictionary)] per key column
        # partial-state batches carried over an overflow-to-sort seam
        # (merge-prim re-aggregated at finish, exactly once)
        self._carried: List[Batch] = []

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_batches += 1
        self.ctx.stats.input_rows += batch.num_rows
        if self._hash_state is not None:
            if self._hash_accumulate(batch):
                return
            # the table hit the rehash ceiling: its state was carried;
            # THIS batch and the rest take the sort tier
        elif (not self._hash_decided
                and self._accumulated_rows + batch.num_rows
                >= self.ctx.config.hash_groupby_min_rows):
            # the engagement threshold crossed: small inputs never pay the
            # per-batch insert's fixed costs (one sort at finish is
            # cheaper); large ones drain what accumulated so far into
            # resident state and stream from here with bounded memory
            self._hash_decided = True
            if self._hash_eligible(batch):
                self._hash_begin(batch)
                pending, self._batches = self._batches, []
                self._accumulated_rows = 0
                self.ctx.memory.free()
                for b in pending + [batch]:
                    if (self._hash_state is None
                            or not self._hash_accumulate(b)):
                        self._append_sort_tier(b)
                return
        self._append_sort_tier(batch)

    def _append_sort_tier(self, batch: Batch) -> None:
        self._batches.append(batch)
        self.ctx.memory.reserve(batch.size_bytes)
        self._accumulated_rows += batch.num_rows

    # -- resident hash tier ------------------------------------------------
    def _hash_eligible(self, batch: Batch) -> bool:
        """Device prims only, no min/max over dictionary inputs (their
        resident state would be interning codes), keys not served by the
        bounded-domain direct tier (faster where it applies), and grouping
        actually present."""
        if not self.ctx.config.hash_groupby_enabled or \
                not self.group_channels:
            return False
        for a in self.aggs:
            if (a.prim in ("min", "max") and a.channel is not None
                    and batch.columns[a.channel].dictionary is not None):
                return False
        return self._direct_domains(batch) is None

    def _hash_begin(self, batch: Batch) -> None:
        from presto_tpu_torch.ops.hashtable import groupby_init

        cap = self.ctx.config.hash_groupby_init_slots
        key_cols = [batch.columns[c] for c in self.group_channels]
        self._hash_key_meta = [(c.type, c.dictionary) for c in key_cols]
        agg_specs = [(a.prim, None if a.channel is None or a.prim == "count"
                      else batch.columns[a.channel].values.dtype)
                     for a in self.aggs]
        # every key column is nullable in the resident state: validity
        # presence may differ from batch to batch, the word layout may not
        self._hash_state = groupby_init(
            cap, 2 * len(key_cols), [c.values.dtype for c in key_cols],
            [True] * len(key_cols), agg_specs, batch.device)
        self._hash_cap = cap
        self.ctx.stats.kernel_tier = "hash"

    def _hash_accumulate(self, batch: Batch) -> bool:
        """Fold one batch into the resident state; False when the rehash
        ladder hit its ceiling (state carried, the caller falls back to
        the sort tier for this and later batches)."""
        from presto_tpu_torch.ops.hashtable import groupby_update

        max_slots = self.ctx.config.hash_groupby_max_slots
        prims = [a.prim for a in self.aggs]
        key_cols = [(batch.columns[c].values, batch.columns[c].valid,
                     batch.columns[c].type) for c in self.group_channels]
        agg_ins = [("count", None, None) if a.channel is None else
                   (a.prim, batch.columns[a.channel].values,
                    batch.columns[a.channel].valid) for a in self.aggs]
        while True:
            state, ng, ok = groupby_update(self._hash_state, key_cols,
                                           agg_ins, batch.num_rows)
            if ok:
                self._hash_state = state
                # proactive rehash past 1/2 fill keeps probe chains short
                # for the NEXT batch (MultiChannelGroupByHash.java:286)
                if (ng * 2 > self._hash_cap
                        and self._hash_cap * 2 <= max_slots):
                    self._hash_rehash(prims)
                return True
            # placement failed (table effectively full); nothing was
            # accumulated, so rehash-and-retry is exactly-once
            if self._hash_cap * 2 > max_slots:
                self._hash_overflow_to_sort()
                return False
            self._hash_rehash(prims)

    def _hash_rehash(self, prims) -> None:
        from presto_tpu_torch.ops.hashtable import groupby_rehash

        cap = self._hash_cap * 2
        state, ok = groupby_rehash(self._hash_state, cap, prims)
        while not ok:       # distinct keys into a table twice as big
            cap *= 2
            state, ok = groupby_rehash(self._hash_state, cap, prims)
        self._hash_state, self._hash_cap = state, cap

    def _hash_overflow_to_sort(self) -> None:
        """The overflow rung of the ladder: snapshot the accumulated state
        as a partial-state batch and drop to the sort tier; finish merges
        the carried partials with merge prims, so no group is dropped or
        counted twice however the input straddled the seam."""
        out = self._hash_extract_batch()
        if out is not None and out.num_rows > 0:
            self._carried.append(out)
        self._hash_state = None
        self._hash_cap = 0
        self.ctx.stats.kernel_tier = "hash+sort"

    def _hash_extract_batch(self) -> Optional[Batch]:
        from presto_tpu_torch.ops.hashtable import groupby_extract

        if self._hash_state is None:
            return None
        n, key_outs, agg_outs = groupby_extract(self._hash_state)
        if n == 0:
            return None
        cols = [Column(typ, vals, valid, dictionary)
                for (vals, valid), (typ, dictionary)
                in zip(key_outs, self._hash_key_meta)]
        for a, (acc, cnt) in zip(self.aggs, agg_outs):
            if a.prim == "count":
                cols.append(Column(a.out_type, acc.to(torch.int64)))
            else:
                cols.append(Column(a.out_type,
                                   acc.to(torch_dtype(a.out_type.np_dtype)),
                                   cnt > 0))
        return Batch(tuple(cols), n)

    def _merge_partials(self, parts: List[Batch]) -> Optional[Batch]:
        """Merge-prim re-aggregation of partial-state batches (keys + one
        state column per aggregation): the Step.FINAL half of the
        overflow seam.  Exact: each input row entered one partial."""
        k = len(self.group_channels)
        merge_aggs = [AggChannel(MERGE_PRIM[a.prim], k + i, a.out_type)
                      for i, a in enumerate(self.aggs)]
        types = ([self.input_types[c] for c in self.group_channels]
                 + [a.out_type for a in self.aggs])
        mctx = OperatorContext(self.ctx.task, f"{self.ctx.name}.merge")
        sub = HashAggregationOperator(mctx, list(range(k)), merge_aggs,
                                      types)
        return sub._compute_batches(parts)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        outs: List[Batch] = []
        if self._hash_state is not None:
            # the steady state of the resident tier: groups come straight
            # off the device table, no materialized input
            out = self._hash_extract_batch()
            if out is not None:
                outs.append(out)
            self._hash_state = None
        else:
            out = self._compute_batches(self._batches)
            if out is not None:
                outs.append(out)
        if self._carried:
            merged = self._merge_partials(self._carried + outs)
            outs = [merged] if merged is not None else []
            self._carried = []
        for out in outs:
            self.ctx.stats.output_rows += out.num_rows
        self._outputs.extend(outs)
        self._batches = []
        self.ctx.memory.free()

    def _direct_domains(self, data: Batch) -> Optional[List[int]]:
        """Per-key domain sizes when every key column is bounded (dictionary
        codes / booleans) and the packed domain is small; else None."""
        doms = []
        for c in self.group_channels:
            col = data.columns[c]
            if col.dictionary is not None:
                doms.append(len(col.dictionary))
            elif col.type.name == "boolean":
                doms.append(2)
            else:
                return None
        total = 1
        for d, c in zip(doms, self.group_channels):
            total *= d + (1 if data.columns[c].valid is not None else 0)
        if not doms or total > self.ctx.config.direct_groupby_max_domain:
            return None
        return doms

    def _compute_batches(self, batches: List[Batch]) -> Optional[Batch]:
        data = device_concat(batches, self.ctx.config.min_batch_capacity)
        if data is None:
            return None  # grouped aggregation of zero rows -> zero rows
        doms = self._direct_domains(data)
        if doms is not None:
            self.ctx.stats.kernel_tier = \
                self.ctx.stats.kernel_tier or "direct"
            return self._compute_direct(data, doms)
        self.ctx.stats.kernel_tier = self.ctx.stats.kernel_tier or "sort"
        return self._compute_sort(data)

    def _compute_sort(self, data: Batch) -> Batch:
        """The sort tier (see ops.groupby.grouped_aggregate)."""
        from presto_tpu_torch.ops.groupby import grouped_aggregate

        key_cols = [(data.columns[c].values, data.columns[c].valid,
                     data.columns[c].type) for c in self.group_channels]
        agg_ins, posts = _agg_inputs(self.aggs, data)
        gi, num_groups, results = grouped_aggregate(key_cols, agg_ins,
                                                    data.num_rows)
        cols = []
        for c in self.group_channels:
            src = data.columns[c]
            cols.append(Column(src.type, src.values[gi],
                               None if src.valid is None else src.valid[gi],
                               src.dictionary))
        for a, post, (values, cnt) in zip(self.aggs, posts, results):
            if a.prim == "count":
                cols.append(Column(a.out_type, values.to(torch.int64)))
                continue
            dictionary = None
            if post is not None:
                values, dictionary = post(values)
            cols.append(Column(a.out_type,
                               values.to(torch_dtype(a.out_type.np_dtype)),
                               cnt > 0, dictionary))
        return Batch(tuple(cols), num_groups)

    def _compute_direct(self, data: Batch, doms: List[int]) -> Batch:
        """Gather-free path (see ops.groupby.direct_grouped_aggregate)."""
        from presto_tpu_torch.ops.groupby import (
            decode_direct_keys, direct_grouped_aggregate,
        )

        key_cols = [data.columns[c] for c in self.group_channels]
        key_codes = [(c.values, c.valid) for c in key_cols]
        agg_ins, posts = _agg_inputs(self.aggs, data)
        present, results, bad = direct_grouped_aggregate(
            key_codes, doms, agg_ins, data.num_rows)
        if bad is not None:
            # B1's status word rides on the nonzero's read: the copy is
            # queued first, so that read's wait covers it
            bad = bad.to("cpu", non_blocking=True)
        slots = torch.nonzero(present).squeeze(1)
        num_groups = int(slots.shape[0])
        if bad is not None and int(bad[0]) != 0:
            raise ValueError(f"{int(bad[0])} rows with a group id outside "
                             f"[0, {present.shape[0] + 1})")
        decoded = decode_direct_keys(
            slots, [c.valid is not None for c in key_cols], doms)
        cols = []
        for src, (codes, valid) in zip(key_cols, decoded):
            cols.append(Column(src.type, codes.to(src.values.dtype),
                               valid, src.dictionary))
        for a, post, (values, cnt) in zip(self.aggs, posts, results):
            if a.prim == "count":
                cols.append(Column(a.out_type, values[slots]
                                   .to(torch.int64)))
                continue
            vals = values[slots]
            dictionary = None
            if post is not None:
                vals, dictionary = post(vals)
            cols.append(Column(a.out_type,
                               vals.to(torch_dtype(a.out_type.np_dtype)),
                               cnt[slots] > 0, dictionary))
        return Batch(tuple(cols), num_groups)

    def get_output(self) -> Optional[Batch]:
        if not self._outputs:
            return None
        return self._outputs.pop(0)

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


class HashAggregationOperatorFactory(OperatorFactory):
    def __init__(self, group_channels, aggs, input_types):
        self.group_channels = list(group_channels)
        self.aggs = list(aggs)
        self.input_types = list(input_types)

    def create(self, ctx: OperatorContext) -> HashAggregationOperator:
        return HashAggregationOperator(ctx, self.group_channels, self.aggs,
                                       self.input_types)


class GlobalAggregationOperator(Operator):
    """Ungrouped aggregation: exactly one output row, even on empty input,
    on the query's device."""

    def __init__(self, ctx: OperatorContext, aggs: Sequence[AggChannel],
                 input_types: Sequence[T.Type], device: torch.device):
        super().__init__(ctx)
        _check_prims(aggs)
        self.aggs = list(aggs)
        self.input_types = list(input_types)
        self.device = device
        self._batches: List[Batch] = []
        self._output: Optional[Batch] = None

    def add_input(self, batch: Batch) -> None:
        self._batches.append(batch)
        self.ctx.stats.input_rows += batch.num_rows

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        from presto_tpu_torch.ops.groupby import global_aggregate

        data = device_concat(self._batches,
                             self.ctx.config.min_batch_capacity)
        self._batches = []
        cols = []
        if data is None:
            for a in self.aggs:
                if a.prim == "count":
                    cols.append(Column(a.out_type, np.zeros(1, np.int64)))
                else:
                    dictionary = (Dictionary()
                                  if a.out_type.is_dictionary else None)
                    cols.append(Column(a.out_type,
                                       np.zeros(1, a.out_type.np_dtype),
                                       np.zeros(1, bool), dictionary))
            self._output = Batch(tuple(cols), 1).to_device(self.device)
            return
        agg_ins, posts = _agg_inputs(self.aggs, data)
        if any(values is None for _p, values, _v in agg_ins):
            # count(*) counts live rows: any column's length will do
            ref = (data.columns[0].values if data.columns else
                   torch.zeros(data.capacity, device=data.device))
            agg_ins = [(p, ref if v is None else v, valid)
                       for p, v, valid in agg_ins]
        results = global_aggregate(agg_ins, data.num_rows)
        for a, post, (value, cnt) in zip(self.aggs, posts, results):
            if a.prim == "count":
                cols.append(Column(a.out_type,
                                   np.asarray([int(value)], np.int64)))
                continue
            nonempty = int(cnt) > 0
            dictionary = None
            if post is not None:
                value, dictionary = post(value.reshape(1))
                value = value[0]
            cols.append(Column(
                a.out_type,
                np.asarray([value.item()], a.out_type.np_dtype),
                None if nonempty else np.zeros(1, bool), dictionary))
        self._output = Batch(tuple(cols), 1).to_device(self.device)

    def get_output(self) -> Optional[Batch]:
        out, self._output = self._output, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._output is None


class GlobalAggregationOperatorFactory(OperatorFactory):
    def __init__(self, aggs, input_types, device):
        self.aggs = list(aggs)
        self.input_types = list(input_types)
        self.device = torch.device(device)

    def create(self, ctx: OperatorContext) -> GlobalAggregationOperator:
        return GlobalAggregationOperator(ctx, self.aggs, self.input_types,
                                         self.device)
