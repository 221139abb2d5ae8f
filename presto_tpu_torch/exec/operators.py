"""Leaf / streaming operators: scan, values, filter+project, limit,
output.

Reference models: TableScanOperator.java:46, FilterAndProjectOperator.java:38
(+ compiled PageProcessor), TaskOutputOperator.java:33.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.connectors.api import Connector, Split
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import (
    Operator, OperatorFactory, SourceOperator,
)
from presto_tpu_torch.expr.compile import ExprCompiler
from presto_tpu_torch.expr.ir import RowExpression
from presto_tpu_torch.expr.xp import TorchXp


class TableScanOperator(SourceOperator):
    """Pulls host batches from the connector PageSource and stages them on
    the device (the LazyBlock-load + ConnectorPageSource.getNextPage
    path)."""

    def __init__(self, ctx: OperatorContext, connector: Connector,
                 columns: Sequence[str], batch_rows: int,
                 device: torch.device):
        super().__init__(ctx)
        self.connector = connector
        self.columns = list(columns)
        self.batch_rows = batch_rows
        self.device = device
        self._splits: List[Split] = []
        self._no_more_splits = False
        self._iter = None

    def add_split(self, split: Split) -> None:
        self._splits.append(split)

    def no_more_splits(self) -> None:
        self._no_more_splits = True

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[Batch]:
        while True:
            if self._iter is None:
                if not self._splits:
                    return None
                split = self._splits.pop(0)
                self._iter = iter(self.connector.page_source(
                    split, self.columns, self.batch_rows))
            try:
                batch = next(self._iter)
            except StopIteration:
                self._iter = None
                continue
            if batch.num_rows == 0:
                continue
            self.ctx.memory.set_bytes(batch.size_bytes)
            return batch.compact().to_device(self.device)

    def is_finished(self) -> bool:
        return (self._no_more_splits and not self._splits
                and self._iter is None) or self._finishing


class TableScanOperatorFactory(OperatorFactory):
    parallel_safe = True

    def __init__(self, connector: Connector, columns: Sequence[str],
                 device, batch_rows: int = 65536, table: str = ""):
        self.connector = connector
        self.columns = list(columns)
        self.device = torch.device(device)
        self.batch_rows = batch_rows
        self.table = table

    def create(self, ctx: OperatorContext) -> TableScanOperator:
        return TableScanOperator(ctx, self.connector, self.columns,
                                 self.batch_rows, self.device)


class ValuesOperator(Operator):
    """Emits batches built at planning time (a VALUES list, the dummy row
    of a SELECT without FROM)."""

    def __init__(self, ctx: OperatorContext, batches: Sequence[Batch]):
        super().__init__(ctx)
        self._batches = list(batches)

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[Batch]:
        if self._batches:
            batch = self._batches.pop(0)
            self.ctx.stats.output_rows += batch.num_rows
            return batch
        return None

    def is_finished(self) -> bool:
        return not self._batches


class ValuesOperatorFactory(OperatorFactory):
    def __init__(self, batches: Sequence[Batch]):
        self.batches = list(batches)

    def create(self, ctx: OperatorContext) -> ValuesOperator:
        return ValuesOperator(ctx, self.batches)


class FilterProjectOperator(Operator):
    """filter -> compact -> project (the PageProcessor replacement), as
    eager torch ops on the batch's device.  Expressions compile once per
    dictionary binding (dictionaries are compile-time constants of the
    string functions); the selection vector never leaves the device."""

    def __init__(self, ctx: OperatorContext,
                 filter_expr: Optional[RowExpression],
                 projections: Sequence[RowExpression],
                 input_types: Sequence[T.Type]):
        super().__init__(ctx)
        self.filter_expr = filter_expr
        self.projections = list(projections)
        self.input_types = list(input_types)
        self._pending: Optional[Batch] = None
        self._compiled = {}   # dictionary binding -> (filter, projections)

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._pending = batch
        self.ctx.stats.input_batches += 1
        self.ctx.stats.input_rows += batch.num_rows

    def _compile(self, batch: Batch):
        key = tuple(None if c.dictionary is None else c.dictionary.token
                    for c in batch.columns)
        hit = self._compiled.get(key)
        if hit is None:
            compiler = ExprCompiler({i: c.dictionary
                                     for i, c in enumerate(batch.columns)
                                     if c.dictionary is not None})
            cfilter = (compiler.compile(self.filter_expr)
                       if self.filter_expr is not None else None)
            cprojs = [compiler.compile(p) for p in self.projections]
            hit = self._compiled[key] = (cfilter, cprojs)
        return hit

    def get_output(self) -> Optional[Batch]:
        if self._pending is None:
            return None
        batch, self._pending = self._pending, None
        device = batch.device
        xp = TorchXp(device)
        cfilter, cprojs = self._compile(batch)
        n = batch.num_rows
        if cfilter is not None:
            from presto_tpu_torch.ops.filter import selected_positions

            cols = [(c.values, c.valid) for c in batch.columns]
            mask, mvalid = cfilter.run(cols, n, xp)
            mask, mvalid = xp.asarray(mask), (
                None if mvalid is None else xp.asarray(mvalid))
            batch = batch.take(selected_positions(mask, mvalid, n))
            n = batch.num_rows
        pairs = [(c.values, c.valid) for c in batch.columns]
        out_cols = []
        for p in cprojs:
            values, valid = p.run(pairs, n, xp)
            if isinstance(values, Column):   # host-built column (strings)
                col = Column(values.type, values.values, valid,
                             values.dictionary)
            else:
                col = Column(p.type, values, valid, p.dictionary)
            out_cols.append(col.to_device(device))
        out = Batch(tuple(out_cols), n)
        self.ctx.stats.output_batches += 1
        self.ctx.stats.output_rows += n
        if n == 0:
            return None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._pending is None


class FilterProjectOperatorFactory(OperatorFactory):
    parallel_safe = True

    def __init__(self, filter_expr: Optional[RowExpression],
                 projections: Sequence[RowExpression],
                 input_types: Sequence[T.Type]):
        self.filter_expr = filter_expr
        self.projections = list(projections)
        self.input_types = list(input_types)

    def create(self, ctx: OperatorContext) -> FilterProjectOperator:
        return FilterProjectOperator(ctx, self.filter_expr, self.projections,
                                     self.input_types)


class LimitOperator(Operator):
    """LIMIT without ORDER BY: the first ``limit`` rows in arrival order
    (LimitOperator.java role)."""

    def __init__(self, ctx: OperatorContext, limit: int):
        super().__init__(ctx)
        self.remaining = limit
        self._pending: Optional[Batch] = None

    def needs_input(self) -> bool:
        return (self._pending is None and self.remaining > 0
                and not self._finishing)

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        if batch.num_rows > self.remaining:
            batch = batch.head(self.remaining)
        self.remaining -= batch.num_rows
        self._pending = batch
        self.ctx.stats.output_rows += batch.num_rows

    def get_output(self) -> Optional[Batch]:
        out, self._pending = self._pending, None
        return out

    def is_finished(self) -> bool:
        return (self.remaining == 0 or self._finishing) and \
            self._pending is None


class LimitOperatorFactory(OperatorFactory):
    def __init__(self, limit: int):
        self.limit = limit

    def create(self, ctx: OperatorContext) -> LimitOperator:
        return LimitOperator(ctx, self.limit)


class OutputCollector(Operator):
    """Terminal sink gathering result batches on the host
    (TaskOutputOperator / test MaterializedResult role)."""

    def __init__(self, ctx: OperatorContext):
        super().__init__(ctx)
        self.batches: List[Batch] = []

    def add_input(self, batch: Batch) -> None:
        if batch.num_rows:
            self.batches.append(batch.compact().to_numpy())
        self.ctx.stats.input_batches += 1
        self.ctx.stats.input_rows += batch.num_rows

    def is_finished(self) -> bool:
        return self._finishing

    def rows(self) -> List[tuple]:
        out: List[tuple] = []
        for b in self.batches:
            out.extend(b.to_pylist())
        return out


class OutputCollectorFactory(OperatorFactory):
    def __init__(self):
        self.collectors: List[OutputCollector] = []

    def create(self, ctx: OperatorContext) -> OutputCollector:
        c = OutputCollector(ctx)
        self.collectors.append(c)
        return c

    def reset_for_execution(self) -> None:
        self.collectors = []

    def rows(self) -> List[tuple]:
        out = []
        for c in self.collectors:
            out.extend(c.rows())
        return out
