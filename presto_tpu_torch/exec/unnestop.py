"""UNNEST operator (UnnestOperator.java:39).

Expands ARRAY/MAP columns into rows: each input row emits
max(cardinalities) output rows; replicated channels repeat per element,
shorter arrays null-pad, maps expand to (key, value), arrays of ROW expand
one output column per field, and WITH ORDINALITY appends the 1-based
position.  LEFT JOIN UNNEST (``outer``) keeps a row whose containers are
empty or NULL as one row of NULLs.

The offsets and the expansion are torch ops on the batch's device: the
replicated columns and the unnested children are gathers by the
expansion's row and element indices.  The output size is read from the
device once a batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, null_column
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import Operator, OperatorFactory


def _and(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    return a if b is None else a & b


class UnnestOperator(Operator):
    def __init__(self, ctx: OperatorContext,
                 replicate_channels: Sequence[int],
                 unnest_channels: Sequence[int], ordinality: bool,
                 outer: bool = False):
        super().__init__(ctx)
        self.replicate_channels = list(replicate_channels)
        self.unnest_channels = list(unnest_channels)
        self.ordinality = ordinality
        self.outer = outer
        self._pending: Optional[Batch] = None

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._pending = batch
        self.ctx.stats.input_batches += 1
        self.ctx.stats.input_rows += batch.num_rows

    def get_output(self) -> Optional[Batch]:
        if self._pending is None:
            return None
        batch, self._pending = self._pending, None
        n = batch.num_rows
        ucols = [batch.columns[c] for c in self.unnest_channels]
        dev = ucols[0].values.device
        lens = []
        for c in ucols:
            ln = c.values[:n].long()
            if c.valid is not None:            # NULL container => 0 rows
                ln = torch.where(c.valid[:n], ln, 0)
            lens.append(ln)
        maxlen = lens[0]
        for ln in lens[1:]:
            maxlen = torch.maximum(maxlen, ln)
        # LEFT JOIN UNNEST keeps empty/NULL-container rows as one
        # all-NULL-unnest-columns row
        efflen = maxlen.clamp(min=1) if self.outer else maxlen
        total = int(efflen.sum())       # the batch's one read of the device
        if total == 0:
            return None
        row_of = torch.repeat_interleave(
            torch.arange(n, device=dev), efflen, output_size=total)
        within = torch.arange(total, device=dev) - \
            (torch.cumsum(efflen, 0) - efflen)[row_of]

        out_cols: List[Column] = [batch.columns[ch].take(row_of)
                                  for ch in self.replicate_channels]
        for c, ln in zip(ucols, lens):
            row_len = ln[row_of]
            present = within < row_len
            m = c.children[0].values.shape[0]
            # rows whose array here is shorter (even empty) gather a safe
            # slot; ``present`` masks them to NULL
            idx = (c.starts()[:n][row_of]
                   + torch.minimum(within, (row_len - 1).clamp(min=0)))
            idx = idx.clamp(0, max(m - 1, 0))
            for kid in c.children:
                out_cols.extend(self._expand_kid(kid, idx, present, total))
        if self.ordinality:
            ord_valid = within < maxlen[row_of] if self.outer else None
            out_cols.append(Column(T.BIGINT, within + 1, ord_valid))
        self.ctx.stats.output_rows += total
        return Batch(tuple(out_cols), total)

    def _expand_kid(self, kid: Column, idx: torch.Tensor,
                    present: torch.Tensor, total: int) -> List[Column]:
        if kid.values.shape[0] == 0:
            col = null_column(kid.type, total, present.device)
        else:
            taken = kid.take(idx)
            col = taken.with_values(taken.values, _and(present, taken.valid))
        if isinstance(kid.type, T.RowType):
            # array(row(...)) expands one column per field
            return [f.with_values(f.values, _and(col.valid, f.valid))
                    for f in col.children]
        return [col]

    def is_finished(self) -> bool:
        return self._finishing and self._pending is None


class UnnestOperatorFactory(OperatorFactory):
    parallel_safe = True

    def __init__(self, replicate_channels: Sequence[int],
                 unnest_channels: Sequence[int], ordinality: bool,
                 outer: bool = False):
        self.replicate_channels = list(replicate_channels)
        self.unnest_channels = list(unnest_channels)
        self.ordinality = ordinality
        self.outer = outer

    def create(self, ctx: OperatorContext) -> UnnestOperator:
        return UnnestOperator(ctx, self.replicate_channels,
                              self.unnest_channels, self.ordinality,
                              self.outer)
