"""WindowOperator and TopNRowNumberOperator: window functions as
segmented scans over partition-sorted rows.

Reference model: WindowOperator (presto-main/.../operator/
WindowOperator.java:61) sorts a PagesIndex by (partition, order) keys and
walks it row by row, partition by partition, with per-function framing
(operator/window/FrameInfo).  Here, as in the JAX package, the input is
sorted once by (partition, order) keys (the embedded OrderByOperator),
partition and peer-group ids come from adjacent-row key equality on the
device, and every window function is a segmented scan (ops/window.py):
no loop over partitions.

Output rows come out partition/order-sorted (the reference's output order
as well); the appended channels hold the function results.  The port's
sort has no spill (ROADMAP A8), so neither has this operator: the whole
input is held on the device.  Evaluation still goes in chunks of complete
partitions, cut where the JAX package cuts them, so that each scan runs
over the same rows and gives the same bits there and here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import (
    Operator, OperatorFactory, device_concat,
)
from presto_tpu_torch.exec.sortop import OrderByOperator, SortSpec
from presto_tpu_torch.expr.xp import torch_dtype
from presto_tpu_torch.ops import window as W
from presto_tpu_torch.sql.plan import PlanWindowFunction


def eval_window_function(fn: PlanWindowFunction, columns, seg, peer):
    """Evaluate one window function over partition-sorted columns.

    Returns ``(result_type, values, valid|None, dictionary|None)``."""
    name = fn.name
    rt = fn.result_type
    if name == "row_number":
        return rt, W.row_number(seg), None, None
    if name == "rank":
        return rt, W.rank(seg, peer), None, None
    if name == "dense_rank":
        return rt, W.dense_rank(seg, peer), None, None
    if name == "percent_rank":
        return rt, W.percent_rank(seg, peer), None, None
    if name == "cume_dist":
        return rt, W.cume_dist(seg, peer), None, None
    if name == "ntile":
        return rt, W.ntile(seg, fn.offset), None, None

    if name in ("lag", "lead"):
        c = columns[fn.arg_channels[0]]
        default = (columns[fn.default_channel].values
                   if fn.default_channel is not None else None)
        off = fn.offset if name == "lag" else -fn.offset
        vals, ok = W.shift_in_partition(seg, c.values, c.valid, off,
                                        default)
        return rt, vals, ok, c.dictionary

    lo, hi = W.frame_ends(seg, peer, fn.frame_unit, fn.frame_start,
                          fn.frame_end, fn.frame_start_offset,
                          fn.frame_end_offset)
    if name in ("first_value", "nth_value"):
        c = columns[fn.arg_channels[0]]
        k = fn.offset or 1
        target = lo + (k - 1)
        in_frame = target <= hi
        tc = torch.clamp(target, 0, c.values.shape[0] - 1)
        vals = c.values[tc]
        ok = in_frame if c.valid is None else (in_frame & c.valid[tc])
        return rt, vals, ok, c.dictionary
    if name == "last_value":
        c = columns[fn.arg_channels[0]]
        vals, ok = W.value_at(c.values, c.valid, hi)
        ok = ok & (lo <= hi)
        return rt, vals, ok, c.dictionary

    # framed aggregates
    if name == "count":
        if not fn.arg_channels:
            ones = torch.ones(seg.shape[0], dtype=torch.int64,
                              device=seg.device)
            s, _ = W.framed_sum_count(seg, ones, None, lo, hi)
            return rt, s, None, None
        c = columns[fn.arg_channels[0]]
        _, cnt = W.framed_sum_count(
            seg, torch.zeros(seg.shape[0], dtype=torch.int64,
                             device=seg.device), c.valid, lo, hi)
        return rt, cnt, None, None
    if name in ("sum", "avg"):
        c = columns[fn.arg_channels[0]]
        vals = c.values
        if T.is_integral(c.type) or isinstance(c.type, T.DecimalType):
            vals = vals.to(torch.int64)
        s, cnt = W.framed_sum_count(seg, vals, c.valid, lo, hi)
        ok = cnt > 0
        if name == "sum":
            return rt, s.to(torch_dtype(rt.np_dtype)), ok, None
        cnt_safe = torch.clamp(cnt, min=1).to(torch.float64)
        if isinstance(rt, T.DecimalType):
            # scaled-integer average, round half away from zero
            q = s.to(torch.float64) / cnt_safe
            avg = torch.where(q >= 0, torch.floor(q + 0.5),
                              torch.ceil(q - 0.5)).to(torch.int64)
            return rt, avg, ok, None
        return rt, s.to(torch.float64) / cnt_safe, ok, None
    if name in ("min", "max"):
        c = columns[fn.arg_channels[0]]
        vals, ok = W.framed_minmax(seg, peer, c.values, c.valid,
                                   fn.frame_unit, fn.frame_start,
                                   fn.frame_end, is_max=(name == "max"),
                                   lo=lo, hi=hi)
        return rt, vals, ok, c.dictionary
    raise NotImplementedError(f"window function {name}")


def _same_as_prev(c: Column, n: int, nan_equal: bool) -> torch.Tensor:
    """[n - 1] bool: row i + 1 equals row i on this key (NULL equals NULL,
    -0.0 equals 0.0, NaN equals NaN where ``nan_equal``: the JAX package
    cuts its chunks so, while its segment ids keep NaN apart)."""
    v = c.values[:n]
    same = v[1:] == v[:-1]
    if nan_equal and v.is_floating_point():
        same = same | (torch.isnan(v[1:]) & torch.isnan(v[:-1]))
    if c.valid is not None:
        g = c.valid[:n]
        same = (g[1:] == g[:-1]) & (same | ~g[1:])
    return same


class WindowOperator(Operator):
    """Window functions over the input sorted by (partition, order)."""

    def __init__(self, ctx: OperatorContext,
                 partition_channels: Sequence[int],
                 order_keys: Sequence[Tuple[int, bool, Optional[bool]]],
                 functions: Sequence[PlanWindowFunction]):
        super().__init__(ctx)
        self.partition_channels = list(partition_channels)
        self.order_keys = list(order_keys)
        self.functions = list(functions)
        self._batches: List[Batch] = []
        self._sorter: Optional[OrderByOperator] = None
        self._outputs: List[Batch] = []

    def _sort_specs(self) -> List[SortSpec]:
        specs = [SortSpec(ch, False, False)
                 for ch in self.partition_channels]
        specs += [SortSpec(ch, not asc, bool(nf))
                  for ch, asc, nf in self.order_keys]
        return specs

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        specs = self._sort_specs()
        if not specs:
            # OVER (): one global partition, nothing to sort or chunk
            self._batches.append(batch)
            self.ctx.memory.reserve(batch.size_bytes)
            return
        if self._sorter is None:
            sub = OperatorContext(self.ctx.task, f"{self.ctx.name}.sort")
            self._sorter = OrderByOperator(sub, specs)
        self._sorter.add_input(batch)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        if self._sorter is None:
            data = device_concat(self._batches,
                                 self.ctx.config.min_batch_capacity)
            self._batches = []
            self.ctx.memory.free()
            if data is not None:
                self._emit(self._evaluate(data))
            return
        self._sorter.finish()
        self._consume_sorted()
        self._sorter.close()
        self._sorter = None

    def close(self) -> None:
        super().close()
        # the embedded sorter is this operator's own, not the pipeline's:
        # free its reservations here (failure paths included)
        if self._sorter is not None:
            self._sorter.close()
            self._sorter = None

    def _emit(self, out: Batch) -> None:
        self._outputs.append(out)
        self.ctx.stats.output_rows += out.num_rows

    def _partition_starts(self, data: Batch) -> torch.Tensor:
        """[n] bool on the device: rows that start a new partition."""
        n = data.num_rows
        starts = torch.zeros(n, dtype=torch.bool, device=data.device)
        starts[:1] = True
        for ch in self.partition_channels:
            starts[1:] |= ~_same_as_prev(data.columns[ch], n, True)
        return starts

    def _consume_sorted(self) -> None:
        """Drain the sorter, evaluating chunks of complete partitions.

        As in the JAX package: once at least ``scan_batch_rows`` rows are
        pending, evaluate up to the last partition start and keep the
        rest pending.  Each such cut reads the pending rows' partition
        starts to the host once.  The port's sorter (no spill) emits one
        batch, so there is at most one cut; a sorter that emits several
        batches has every one of them evaluated."""
        target = max(self.ctx.config.scan_batch_rows, 1)
        pending: List[Batch] = []
        while True:
            out = self._sorter.get_output()
            if out is None:
                break
            pending.append(out.compact())
            if (sum(b.num_rows for b in pending) < target
                    or not self.partition_channels):
                continue
            data = pending[0] if len(pending) == 1 else \
                device_concat(pending, 1).compact()
            starts = W.nonzero_host(self._partition_starts(data))
            cut = int(starts[-1]) if len(starts) else 0
            if cut == 0:
                pending = [data]          # one partition: keep growing
                continue
            n = data.num_rows
            self._evaluate_rows(data.take(
                torch.arange(cut, device=data.device)))
            pending = [data.take(torch.arange(cut, n, device=data.device))]
        self._evaluate_rows(*pending)

    def _evaluate_rows(self, *batches: Batch) -> None:
        padded = device_concat(batches, self.ctx.config.min_batch_capacity)
        if padded is not None:
            self._emit(self._evaluate(padded))

    def _segment(self, data: Batch):
        """Partition and peer-group ids of sorted rows, shared by the
        window evaluation and the TopNRowNumber truncation.  Liveness
        takes part as a pseudo-key, so padding rows (all after the live
        rows) never merge into the last partition."""
        n, cap = data.num_rows, data.capacity
        device = data.device
        live = torch.arange(cap, device=device) < n
        part_eq = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                             live[1:] == live[:-1]])
        for ch in self.partition_channels:
            part_eq[1:] &= _same_as_prev(data.columns[ch], cap, False)
        seg = W.segment_ids(part_eq)
        peer_eq = part_eq.clone()
        for ch, _, _ in self.order_keys:
            peer_eq[1:] &= _same_as_prev(data.columns[ch], cap, False)
        peer = W.segment_ids(peer_eq)
        return seg, peer, live

    def _evaluate(self, data: Batch) -> Batch:
        seg, peer, _live = self._segment(data)
        out_cols = list(data.columns)
        for fn in self.functions:
            rt, vals, ok, d = eval_window_function(fn, data.columns, seg,
                                                   peer)
            out_cols.append(Column(rt, vals, ok, d))
        return Batch(tuple(out_cols), data.num_rows)

    def get_output(self) -> Optional[Batch]:
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


class TopNRowNumberOperator(WindowOperator):
    """Fused ``row_number() OVER (partition ORDER BY ...) <= N``
    (TopNRowNumberOperator.java:38 role): sorts once by (partition,
    order), keeps only each partition's first N rows, and emits the row
    number with them; the filtered rows never go downstream.  Sizing the
    kept rows reads the device once a chunk."""

    def __init__(self, ctx: OperatorContext,
                 factory: "TopNRowNumberOperatorFactory"):
        super().__init__(ctx, factory.partition_channels,
                         factory.order_keys, [])
        self.limit = factory.limit
        self.rn_type = factory.rn_type

    def _evaluate(self, data: Batch) -> Batch:
        seg, _peer, live = self._segment(data)
        rn = W.row_number(seg)
        idx = W.nonzero_index(live & (rn <= self.limit))
        out = data.take(idx)
        rn_col = Column(self.rn_type,
                        rn[idx].to(torch_dtype(self.rn_type.np_dtype)))
        return Batch(tuple(out.columns) + (rn_col,), int(idx.shape[0]))


class TopNRowNumberOperatorFactory(OperatorFactory):
    def __init__(self, partition_channels: Sequence[int],
                 order_keys: Sequence[Tuple[int, bool, Optional[bool]]],
                 limit: int, rn_type: T.Type):
        self.partition_channels = list(partition_channels)
        self.order_keys = list(order_keys)
        self.limit = limit
        self.rn_type = rn_type

    def create(self, ctx: OperatorContext) -> TopNRowNumberOperator:
        return TopNRowNumberOperator(ctx, self)


class WindowOperatorFactory(OperatorFactory):
    def __init__(self, partition_channels: Sequence[int],
                 order_keys: Sequence[Tuple[int, bool, Optional[bool]]],
                 functions: Sequence[PlanWindowFunction]):
        self.partition_channels = list(partition_channels)
        self.order_keys = list(order_keys)
        self.functions = list(functions)

    def create(self, ctx: OperatorContext) -> WindowOperator:
        return WindowOperator(ctx, self.partition_channels,
                              self.order_keys, self.functions)
