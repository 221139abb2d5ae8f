"""UNION ALL plumbing: N source pipelines feeding one consumer chain.

Reference model: the reference plans UNION as an ExchangeNode/LocalExchange
gathering multiple driver pipelines into one (LocalExchange.java:53 with
passthrough exchangers).  In the single-process runner the same rendezvous
is a shared buffer: each input branch runs as its own pipeline ending in a
``UnionSinkOperator``; the consuming pipeline starts with a
``UnionSourceOperator`` that drains the buffer.  Pipelines execute in
dependency order (the execute_pipelines contract), so all sinks finish
before the source starts — as build sides rendezvous with probes.

The source emits batches in (input index, arrival within that input)
order, so a float sum downstream sees the same order on every run.  The
inputs of one channel may carry different dictionaries (``n_name UNION
ALL r_name``): the source re-codes such a channel into one dictionary, so
every operator downstream (a hash GROUP BY keyed on codes included) sees
one code space.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import Operator, OperatorFactory


class UnionBuffer:
    """Shared rendezvous between sink pipelines and the source."""

    def __init__(self, n_sinks: int):
        self.n_sinks = n_sinks
        self.batches: List[List[Batch]] = [[] for _ in range(n_sinks)]
        self.remaining_sinks = n_sinks

    def reset(self) -> None:
        """Re-arm for another execution of the same plan."""
        self.batches = [[] for _ in range(self.n_sinks)]
        self.remaining_sinks = self.n_sinks

    def drain(self) -> List[Batch]:
        """Every input's batches, input by input, with each dictionary
        channel in one code space; the buffer is left empty."""
        out = [b for per_input in self.batches for b in per_input]
        self.batches = [[] for _ in range(self.n_sinks)]
        if not out:
            return out
        for ci, first in enumerate(out[0].columns):
            dicts = {id(b.columns[ci].dictionary): b.columns[ci].dictionary
                     for b in out if b.columns[ci].dictionary is not None}
            if first.type.is_dictionary and len(dicts) > 1:
                target = Dictionary()
                out = [_recode(b, ci, target) for b in out]
        return out


def _recode(batch: Batch, ci: int, target: Dictionary) -> Batch:
    """``batch`` with channel ``ci``'s codes mapped into ``target``."""
    col = batch.columns[ci]
    remap = col.dictionary.remap_into(target)
    if len(remap) == 0:           # an all-NULL channel: codes are unused
        codes = col.values
    else:
        table = torch.from_numpy(remap).to(col.values.device)
        codes = table[col.values.long().clamp(0, len(remap) - 1)]
    cols = list(batch.columns)
    cols[ci] = Column(col.type, codes, col.valid, target)
    return Batch(tuple(cols), batch.num_rows)


class UnionSinkOperator(Operator):
    def __init__(self, ctx: OperatorContext, buffer: UnionBuffer,
                 index: int):
        super().__init__(ctx)
        self.buffer = buffer
        self.index = index

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        self.buffer.batches[self.index].append(batch)

    def finish(self) -> None:
        if not self._finishing:
            self.buffer.remaining_sinks -= 1
        super().finish()

    def is_finished(self) -> bool:
        return self._finishing


class UnionSinkOperatorFactory(OperatorFactory):
    def __init__(self, buffer: UnionBuffer, index: int):
        self.buffer = buffer
        self.index = index

    def create(self, ctx: OperatorContext) -> UnionSinkOperator:
        return UnionSinkOperator(ctx, self.buffer, self.index)

    def reset_for_execution(self) -> None:
        # idempotent: every sink factory and the source factory share
        # one buffer; the first reset re-arms it for all of them
        self.buffer.reset()


class UnionSourceOperator(Operator):
    def __init__(self, ctx: OperatorContext, buffer: UnionBuffer):
        super().__init__(ctx)
        self.buffer = buffer
        self._ready: Optional[List[Batch]] = None

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[Batch]:
        if self._ready is None:
            if self.buffer.remaining_sinks > 0:
                return None
            self._ready = self.buffer.drain()
        if self._ready:
            batch = self._ready.pop(0)
            self.ctx.stats.output_rows += batch.num_rows
            return batch
        return None

    def is_finished(self) -> bool:
        return self._ready is not None and not self._ready


class UnionSourceOperatorFactory(OperatorFactory):
    def __init__(self, buffer: UnionBuffer):
        self.buffer = buffer

    def create(self, ctx: OperatorContext) -> UnionSourceOperator:
        return UnionSourceOperator(ctx, self.buffer)

    def reset_for_execution(self) -> None:
        self.buffer.reset()
