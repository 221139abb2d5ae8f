"""Streaming aggregation over key-clustered input.

The reference's StreamingAggregationOperator
(presto-main/.../operator/StreamingAggregationOperator.java:38) exploits
input that is already sorted or clustered on the group keys: it holds one
open group instead of a hash table and emits each group as soon as the
next key appears.  Same contract here: each batch runs the sort-free
``clustered_aggregate`` (run boundaries and segment reductions on the
device, no sort, no rehash), every finished group of the batch goes out
together, and only the last, possibly still open, group's state carries
to the next batch, merged on the host by each primitive's combine rule.

Each batch reads the device once: the group count together with the
first and last groups' keys and states (``_read_host``).  The groups go
out as device tensors.

Chosen by the physical planner when the group channels trace to a prefix
of the scan's declared sort order (``Connector.sort_order``, the
LocalProperties/StreamPropertyDerivations role).  The pipeline must not
be split into concurrent feed drivers (``requires_ordered_input``):
round-robin feeds would interleave key ranges.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, next_bucket
from presto_tpu_torch.exec.aggregation import AggChannel
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import Operator, OperatorFactory
from presto_tpu_torch.expr.xp import numpy_dtype, torch_dtype
from presto_tpu_torch.ops import groupby as G


def _read_host(parts: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Small 1-d tensors of one device on the host, in one device read:
    each goes over as int64 words (a float as its bits) and comes back in
    its own dtype."""
    words = []
    for p in parts:
        if p.is_floating_point():
            bits = torch.int64 if p.element_size() == 8 else torch.int32
            p = p.contiguous().view(bits)
        words.append(p.to(torch.int64))
    flat = torch.cat(words).cpu().numpy()
    out, at = [], 0
    for p in parts:
        w = flat[at:at + p.shape[0]]
        at += p.shape[0]
        dt = numpy_dtype(p.dtype)
        if dt.kind == "f":
            w = w.astype(np.int64 if dt.itemsize == 8 else np.int32).view(dt)
        out.append(w.astype(dt))
    return out


class StreamingAggregationOperator(Operator):
    def __init__(self, ctx: OperatorContext,
                 group_channels: Sequence[int],
                 aggs: Sequence[AggChannel]):
        super().__init__(ctx)
        self.group_channels = list(group_channels)
        self.aggs = list(aggs)
        self.ctx.stats.kernel_tier = "clustered"
        self._outputs: List[Batch] = []
        # the open group: (key tuple of host values, per-aggregate
        # (value, count) host scalars, 1-row key Columns on the device)
        self._carry: Optional[Tuple[tuple, List[Tuple[object, int]],
                                    List[Column]]] = None

    # -- carry merge (the combine rule per primitive) --------------------
    @staticmethod
    def _combine(prim: str, a, b, cnt_a: int, cnt_b: int):
        if cnt_a == 0:
            return b
        if cnt_b == 0:
            return a
        if prim in ("sum", "count"):
            return a + b
        if prim == "min":
            return min(a, b)
        if prim == "max":
            return max(a, b)
        raise ValueError(prim)

    @staticmethod
    def _key_value(c: Column, value, valid):
        if valid is not None and not valid:
            return None
        if c.dictionary is not None:
            return c.dictionary.values[int(value)]
        return c.type.to_python(value)

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_batches += 1
        self.ctx.stats.input_rows += batch.num_rows
        n = batch.num_rows
        if n == 0:
            return
        key_cols = [batch.columns[c] for c in self.group_channels]
        agg_ins = []
        for a in self.aggs:
            if a.channel is None:
                agg_ins.append(("count", None, None))
            else:
                col = batch.columns[a.channel]
                agg_ins.append((a.prim, col.values, col.valid))
        group_cap = next_bucket(min(batch.capacity, n), minimum=16)
        first_pos, ng_t, results = G.clustered_aggregate(
            [(c.values, c.valid, c.type) for c in key_cols], agg_ins, n,
            group_cap)

        # the one device read: the group count, and the keys and states
        # of the first and the last group
        edges = torch.stack([torch.zeros_like(ng_t), ng_t - 1])
        edge_rows = first_pos[edges]
        parts = [ng_t.view(1)]
        for c in key_cols:
            parts.append(c.values[edge_rows])
            if c.valid is not None:
                parts.append(c.valid[edge_rows])
        for values, cnt in results:
            parts += [values[edges], cnt[edges]]
        host = iter(_read_host(parts))
        ng = int(next(host)[0])
        keys = []                       # per key column: (first, last)
        for c in key_cols:
            v = next(host)
            g = next(host) if c.valid is not None else (None, None)
            keys.append([self._key_value(c, v[e], g[e]) for e in (0, 1)])
        states = []                     # per aggregate: [first, last]
        for _ in self.aggs:
            v, cnt = next(host), next(host)
            states.append([(v[e].item(), int(cnt[e])) for e in (0, 1)])
        first_key = tuple(k[0] for k in keys)
        last = ng - 1

        # merge the carried open group into this batch's first group when
        # the key continues; otherwise flush the carry as its own group
        if self._carry is not None:
            ckey, cstate, ckey_cols = self._carry
            if ckey == first_key:
                for i, a in enumerate(self.aggs):
                    (v0, c0) = states[i][0]
                    merged = (self._combine(a.prim, cstate[i][0], v0,
                                            cstate[i][1], c0),
                              cstate[i][1] + c0)
                    values, cnt = results[i]
                    values[0] = merged[0]
                    cnt[0] = merged[1]
                    states[i][0] = merged
                    if last == 0:
                        states[i][1] = merged
            else:
                self._push(self._state_batch(ckey_cols, cstate))
            self._carry = None

        # carry the last group (open until a new key or finish)
        self._carry = (tuple(k[1] for k in keys),
                       [s[1] for s in states],
                       [c.take(first_pos[last:last + 1]) for c in key_cols])
        if last > 0:
            idx = first_pos[:last]
            cols = [c.take(idx) for c in key_cols]
            for a, (values, cnt) in zip(self.aggs, results):
                cols.append(self._agg_column(a, values[:last], cnt[:last]))
            self._push(Batch(tuple(cols), last))

    def _push(self, b: Batch) -> None:
        self.ctx.stats.output_batches += 1
        self.ctx.stats.output_rows += b.num_rows
        self._outputs.append(b)

    @staticmethod
    def _agg_column(a: AggChannel, vals: torch.Tensor,
                    cnts: torch.Tensor) -> Column:
        vals = vals.to(torch_dtype(a.out_type.np_dtype))
        if a.prim == "count":
            return Column(a.out_type, vals)
        return Column(a.out_type, vals, cnts > 0)

    def _state_batch(self, key_cols: List[Column],
                     state: List[Tuple[object, int]]) -> Batch:
        device = key_cols[0].values.device
        cols = list(key_cols)
        for a, (v, cnt) in zip(self.aggs, state):
            vals = torch.tensor([v if v is not None else 0],
                                dtype=torch_dtype(a.out_type.np_dtype),
                                device=device)
            valid = (None if (cnt > 0 or a.prim == "count")
                     else torch.zeros(1, dtype=torch.bool, device=device))
            cols.append(Column(a.out_type, vals, valid))
        return Batch(tuple(cols), 1)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        if self._carry is not None:
            _ckey, cstate, ckey_cols = self._carry
            self._push(self._state_batch(ckey_cols, cstate))
            self._carry = None

    def get_output(self) -> Optional[Batch]:
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


class StreamingAggregationOperatorFactory(OperatorFactory):
    # concurrent feed drivers would interleave key ranges and break the
    # clustering contract: the runner keeps this pipeline serial
    requires_ordered_input = True

    def __init__(self, group_channels: Sequence[int],
                 aggs: Sequence[AggChannel],
                 input_types: Sequence[T.Type]):
        for a in aggs:
            # the planner's eligibility check guarantees this; direct
            # construction must honour it too (the carry merge would
            # compare dictionary interning codes)
            if (a.prim in ("min", "max") and a.channel is not None
                    and input_types[a.channel].is_dictionary):
                raise ValueError(
                    "min/max over dictionary columns is not streamable")
        self.group_channels = list(group_channels)
        self.aggs = list(aggs)

    def create(self, ctx: OperatorContext) -> StreamingAggregationOperator:
        return StreamingAggregationOperator(ctx, self.group_channels,
                                            self.aggs)
