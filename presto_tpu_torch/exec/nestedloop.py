"""Cross join + scalar-subquery guard operators.

Reference models: NestedLoopJoinOperator/NestedLoopBuildOperator
(presto-main/.../operator/NestedLoopJoinOperator.java:36) and
EnforceSingleRowOperator (EnforceSingleRowOperator.java:27).  The dominant
use is the scalar-subquery shape the planner emits (EnforceSingleRow ->
cross join of exactly one row), so the product is built for a small build
side: probe rows are repeated ``k`` build rows at a time with plain
gathers — no keys, no sort.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, null_column
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import (
    Operator, OperatorFactory, device_concat,
)


# each product batch holds at most this many rows (one probe batch against
# a chunk of the build)
MAX_OUTPUT_ROWS = 1 << 22


class NestedLoopBuildOperator(Operator):
    """Materializes the build side into the shared holder."""

    def __init__(self, ctx: OperatorContext,
                 factory: "NestedLoopBuildOperatorFactory"):
        super().__init__(ctx)
        self.f = factory
        self._batches: List[Batch] = []

    def add_input(self, batch: Batch) -> None:
        self._batches.append(batch)
        self.ctx.stats.input_rows += batch.num_rows
        self.ctx.memory.reserve(batch.size_bytes)

    def finish(self) -> None:
        if self._finishing:
            return
        super().finish()
        # None for an empty build: the product is then empty
        self.f.data = device_concat(self._batches, 1)
        self.f.finished = True
        self._batches = []

    def get_output(self) -> Optional[Batch]:
        return None

    def is_finished(self) -> bool:
        return self._finishing


class NestedLoopBuildOperatorFactory(OperatorFactory):
    def __init__(self, input_types: Sequence[T.Type]):
        self.input_types = list(input_types)
        self.data: Optional[Batch] = None
        self.finished = False

    def create(self, ctx: OperatorContext) -> NestedLoopBuildOperator:
        return NestedLoopBuildOperator(ctx, self)

    def reset_for_execution(self) -> None:
        # the build pipeline re-fills this next run; dropping it now
        # releases the previous execution's build rows
        self.data = None
        self.finished = False


class NestedLoopJoinOperator(Operator):
    """Probe side: emits the cartesian product probe x build, probe-row
    major.  Output layout matches LookupJoinOperator: probe channels then
    build channels."""

    def __init__(self, ctx: OperatorContext,
                 build: NestedLoopBuildOperatorFactory):
        super().__init__(ctx)
        self.build = build
        self._out: List[Batch] = []

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        if not self.build.finished:
            raise RuntimeError("cross-join build side not finished")
        if self.build.data is None or batch.num_rows == 0:
            return
        build = self.build.data
        device = batch.device
        if device != build.device:
            raise ValueError(f"probe rows on {device} meet a build on "
                             f"{build.device}")
        nb, npr = build.num_rows, batch.num_rows
        # chunk the build side so each product batch stays bounded
        chunk = max(1, MAX_OUTPUT_ROWS // npr)
        for lo in range(0, nb, chunk):
            k = min(chunk, nb - lo)
            j = torch.arange(npr * k, device=device)
            pi = j // k
            bi = lo + j % k
            cols = [Column(c.type, c.values[pi],
                           None if c.valid is None else c.valid[pi],
                           c.dictionary) for c in batch.columns]
            cols += [Column(c.type, c.values[bi],
                            None if c.valid is None else c.valid[bi],
                            c.dictionary) for c in build.columns]
            self.ctx.stats.output_rows += npr * k
            self._out.append(Batch(tuple(cols), npr * k))

    def get_output(self) -> Optional[Batch]:
        if self._out:
            return self._out.pop(0)
        return None

    def is_finished(self) -> bool:
        return self._finishing and not self._out


class NestedLoopJoinOperatorFactory(OperatorFactory):
    def __init__(self, build: NestedLoopBuildOperatorFactory):
        self.build = build

    def create(self, ctx: OperatorContext) -> NestedLoopJoinOperator:
        return NestedLoopJoinOperator(ctx, self.build)


class EnforceSingleRowOperator(Operator):
    """Scalar subqueries must yield exactly one row; zero rows yield one
    all-NULL row (SQL scalar subquery semantics).  The row comes out on
    the query's device."""

    def __init__(self, ctx: OperatorContext, types: Sequence[T.Type],
                 device):
        super().__init__(ctx)
        self.types = list(types)
        self.device = device
        self._rows = 0
        self._batches: List[Batch] = []
        self._emitted = False

    def add_input(self, batch: Batch) -> None:
        self._rows += batch.num_rows
        if self._rows > 1:
            raise RuntimeError(
                "scalar subquery returned more than one row")
        self._batches.append(batch)

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        if self._rows == 1:
            return self._batches[0]
        return Batch(tuple(null_column(t, 1, self.device)
                           for t in self.types), 1)

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class EnforceSingleRowOperatorFactory(OperatorFactory):
    def __init__(self, types: Sequence[T.Type], device):
        self.types = list(types)
        self.device = torch.device(device)

    def create(self, ctx: OperatorContext) -> EnforceSingleRowOperator:
        return EnforceSingleRowOperator(ctx, self.types, self.device)
