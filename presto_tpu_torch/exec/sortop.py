"""ORDER BY / TopN operator (OrderByOperator.java:45, TopNOperator.java:35).

It materializes (as the reference's PagesIndex does), builds the sort
permutation once on the device, and gathers.  TopN (ORDER BY + LIMIT) is
the same sort with a truncated output, as in the JAX package.  Varchar keys order by the
lexicographic rank of their dictionary codes (``Dictionary.sort_ranks``),
computed on the host over the dictionary: strings never sort on the
device.  The spilled external sort (sorted runs + merge) and the radix
sort are ROADMAP A4.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import (
    Operator, OperatorFactory, device_concat,
)


@dataclasses.dataclass(frozen=True)
class SortSpec:
    channel: int
    descending: bool = False
    nulls_first: bool = False


class OrderByOperator(Operator):
    def __init__(self, ctx: OperatorContext, specs: Sequence[SortSpec],
                 limit: Optional[int] = None):
        super().__init__(ctx)
        self.specs = list(specs)
        self.limit = limit
        self._batches: List[Batch] = []
        self._outputs: List[Batch] = []

    def add_input(self, batch: Batch) -> None:
        self._batches.append(batch)
        self.ctx.stats.input_rows += batch.num_rows
        self.ctx.memory.reserve(batch.size_bytes)

    def _sort_batches(self, batches: List[Batch]) -> Optional[Batch]:
        """Device sort of the concatenated batches."""
        from presto_tpu_torch.ops.sort import sort_permutation

        data = device_concat(batches, self.ctx.config.min_batch_capacity)
        if data is None:
            return None
        keys = []
        for s in self.specs:
            c = data.columns[s.channel]
            if c.type.is_dictionary:
                ranks = torch.from_numpy(c.dictionary.sort_ranks()).to(
                    c.values.device)
                values = ranks[c.values.long()]
                keys.append((values, c.valid, T.INTEGER, s.descending,
                             s.nulls_first))
            else:
                keys.append((c.values, c.valid, c.type, s.descending,
                             s.nulls_first))
        perm = sort_permutation(keys, data.num_rows)
        cols = [Column(c.type, c.values[perm],
                       None if c.valid is None else c.valid[perm],
                       c.dictionary)
                for c in data.columns]
        return Batch(tuple(cols), data.num_rows)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        out = self._sort_batches(self._batches)
        self._batches = []
        self.ctx.memory.free()
        if out is not None:
            n = out.num_rows if self.limit is None else min(
                self.limit, out.num_rows)
            self._outputs.append(out.head(n))
            self.ctx.stats.output_rows += n

    def get_output(self) -> Optional[Batch]:
        if not self._outputs:
            return None
        return self._outputs.pop(0)

    def is_finished(self) -> bool:
        return self._finishing and not self._outputs


class OrderByOperatorFactory(OperatorFactory):
    def __init__(self, specs: Sequence[SortSpec],
                 limit: Optional[int] = None):
        self.specs = list(specs)
        self.limit = limit

    def create(self, ctx: OperatorContext) -> OrderByOperator:
        return OrderByOperator(ctx, self.specs, self.limit)
