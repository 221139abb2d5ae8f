"""Aggregation operators.

Reference models: HashAggregationOperator.java:48 (grouped) and
AggregationOperator.java:35 (global).  Both materialize their input (as
the reference's builders do) and reduce once at finish.

Grouped aggregation runs the direct tier: every key is a bounded domain
(dictionary codes, booleans) whose packed product is small, so the group
id is arithmetic and the reduction is ``ops.groupby.
direct_grouped_aggregate`` (its small-domain float sums go through the
hand-written CUDA kernel of ``ops/segment_sums.py``).  The sort and hash
tiers of the JAX package, spilling, and the host-side collect/sketch
aggregates are ROADMAP A4 and A5: a plan that needs them raises
``NotImplementedError``.
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

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_batches += 1
        self.ctx.stats.input_rows += batch.num_rows
        self._batches.append(batch)
        self.ctx.memory.reserve(batch.size_bytes)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        data = device_concat(self._batches,
                             self.ctx.config.min_batch_capacity)
        self._batches = []
        if data is not None:
            # grouped aggregation of zero rows -> zero rows
            self._outputs.append(self._compute(data))
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

    def _compute(self, data: Batch) -> Batch:
        doms = self._direct_domains(data)
        if doms is None:
            raise NotImplementedError(
                "GROUP BY over keys that are not small bounded domains: "
                "ROADMAP A4 ports the sort and hash tiers")
        self.ctx.stats.kernel_tier = self.ctx.stats.kernel_tier or "direct"
        return self._compute_direct(data, doms)

    def _compute_direct(self, data: Batch, doms: List[int]) -> Batch:
        """Gather-free path (see ops.groupby.direct_grouped_aggregate)."""
        from presto_tpu_torch.ops.groupby import (
            decode_direct_keys, direct_grouped_aggregate,
        )

        key_cols = [data.columns[c] for c in self.group_channels]
        key_codes = [(c.values, c.valid) for c in key_cols]
        agg_ins, posts = _agg_inputs(self.aggs, data)
        present, results = direct_grouped_aggregate(
            key_codes, doms, agg_ins, data.num_rows)
        slots = torch.nonzero(present).squeeze(1)
        num_groups = int(slots.shape[0])
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
        self.ctx.stats.output_rows += num_groups
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
    """Ungrouped aggregation: exactly one output row, even on empty input."""

    def __init__(self, ctx: OperatorContext, aggs: Sequence[AggChannel],
                 input_types: Sequence[T.Type]):
        super().__init__(ctx)
        _check_prims(aggs)
        self.aggs = list(aggs)
        self.input_types = list(input_types)
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
            self._output = Batch(tuple(cols), 1)
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
        self._output = Batch(tuple(cols), 1)

    def get_output(self) -> Optional[Batch]:
        out, self._output = self._output, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._output is None


class GlobalAggregationOperatorFactory(OperatorFactory):
    def __init__(self, aggs, input_types):
        self.aggs = list(aggs)
        self.input_types = list(input_types)

    def create(self, ctx: OperatorContext) -> GlobalAggregationOperator:
        return GlobalAggregationOperator(ctx, self.aggs, self.input_types)
