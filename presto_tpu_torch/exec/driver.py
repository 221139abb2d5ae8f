"""Driver: the innermost control loop.

A faithful port of the reference's control plane — Driver.processInternal
iterates adjacent operator pairs moving one batch per hop and propagates
finish (presto-main/.../operator/Driver.java:347,367-420) — because this
loop is hardware-agnostic glue.  What differs: a "page" hop hands off a
device array struct (kernel launch already queued asynchronously by jax),
so the host loop is the pipeline feeder, not the compute.

Pipelines (DriverFactory analogue) are instantiated per driver; the
single-process runner executes them in dependency order (build pipelines
before probe pipelines), which substitutes for the reference's
blocked-future dance on LookupSourceFactory.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from presto_tpu_torch.connectors.api import Split
from presto_tpu_torch.exec.context import OperatorContext, TaskContext
from presto_tpu_torch.exec.operator import Operator, OperatorFactory, SourceOperator


class Driver:
    def __init__(self, operators: Sequence[Operator],
                 pipeline_name: str = ""):
        self.operators = list(operators)
        self.pipeline_name = pipeline_name

    @property
    def source(self) -> Optional[SourceOperator]:
        op = self.operators[0]
        return op if isinstance(op, SourceOperator) else None

    def process(self) -> bool:
        """One scheduling quantum (Driver.processInternal).  Returns True if
        the driver is fully finished."""
        ops = self.operators
        moved = False
        for i in range(len(ops) - 1):
            current, nxt = ops[i], ops[i + 1]
            if not current.is_finished() and nxt.needs_input():
                t0 = time.perf_counter_ns()
                batch = current.get_output()
                current.ctx.stats.wall_ns += time.perf_counter_ns() - t0
                if batch is not None and batch.num_rows > 0:
                    t0 = time.perf_counter_ns()
                    nxt.add_input(batch)
                    nxt.ctx.stats.wall_ns += time.perf_counter_ns() - t0
                    moved = True
            if current.is_finished() and not nxt._finishing:
                t0 = time.perf_counter_ns()
                nxt.finish()
                nxt.ctx.stats.finish_wall_ns += time.perf_counter_ns() - t0
                moved = True
        # let the terminal operator drain even with no downstream
        return ops[-1].is_finished()

    def run_to_completion(self, max_iterations: int = 10_000_000,
                          deadline: Optional[float] = None) -> None:
        # Mirror Driver.close(): operators always release their resources
        # (memory reservations, exchange fetcher threads), success or not.
        try:
            for i in range(max_iterations):
                if self.process():
                    return
                # query_max_run_time enforcement between quanta (checked
                # sparsely — monotonic() per quantum is cheap but the
                # loop can spin fast on tiny batches)
                if deadline is not None and (i & 0xF) == 0 \
                        and time.monotonic() > deadline:
                    raise RuntimeError(
                        "Query exceeded maximum run time")
            raise RuntimeError(
                "driver did not converge (operator protocol bug)")
        finally:
            for op in self.operators:
                try:
                    op.close()
                except Exception:  # noqa: BLE001 - close is best-effort
                    pass
            self._record_driver_stats()

    def _record_driver_stats(self) -> None:
        """Append this run's DriverStats rollup to the TaskContext (the
        OperatorStats -> DriverStats -> TaskStats chain, SURVEY §5.1).
        Rows in = the source operator's output (what entered the chain);
        rows out = the terminal operator's output."""
        if not self.operators:
            return
        from presto_tpu_torch.exec.context import DriverStats

        ops = self.operators
        ds = DriverStats(
            pipeline=self.pipeline_name, operators=len(ops),
            input_rows=ops[0].ctx.stats.output_rows,
            output_rows=ops[-1].ctx.stats.output_rows,
            wall_ns=sum(o.ctx.stats.wall_ns + o.ctx.stats.finish_wall_ns
                        for o in ops))
        ops[0].ctx.task.driver_stats.append(ds)


class Pipeline:
    """An ordered chain of operator factories (DriverFactory)."""

    def __init__(self, factories: Sequence[OperatorFactory],
                 splits: Sequence[Split] = (), name: str = "pipeline"):
        self.factories = list(factories)
        self.splits = list(splits)
        self.name = name

    def instantiate(self, task: TaskContext) -> Driver:
        ops: List[Operator] = []
        for i, f in enumerate(self.factories):
            ctx = OperatorContext(task, f"{self.name}.{i}.{f.name}")
            ops.append(f.create(ctx))
        driver = Driver(ops, pipeline_name=self.name)
        src = driver.source
        if src is not None:
            for s in self.splits:
                src.add_split(s)
            src.no_more_splits()
        return driver
