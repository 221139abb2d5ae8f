"""Execution contexts: memory accounting + operator statistics.

Mirrors the reference's context tree — QueryContext -> TaskContext ->
PipelineContext -> DriverContext -> OperatorContext
(presto-main/.../memory/QueryContext.java, operator/OperatorContext.java) —
and its hierarchical memory contexts (presto-memory-context, SURVEY §2.2):
reservations roll up to the query root, which enforces a limit.

Stats mirror the OperatorStats -> DriverStats -> TaskStats -> StageStats
rollups (SURVEY §5.1): the Driver records per-operator wall time and
row/batch counts around every get_output/add_input call, and the runner's
QueryCompletedEvent carries them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from presto_tpu_torch.config import DEFAULT, EngineConfig


class MemoryReservationError(RuntimeError):
    pass


class MemoryContext:
    """One node in the reservation tree (LocalMemoryContext analogue)."""

    def __init__(self, parent: Optional["MemoryContext"], name: str,
                 limit: Optional[int] = None):
        self.parent = parent
        self.name = name
        self.limit = limit
        self.reserved = 0
        self.peak = 0
        self._tree_lock = (parent._tree_lock if parent is not None
                           else threading.Lock())

    def reserve(self, bytes_: int) -> None:
        self.set_bytes(self.reserved + bytes_)

    def set_bytes(self, bytes_: int) -> None:
        # one lock per reservation TREE (root-owned): concurrent feed
        # drivers of one task serialize, unrelated queries do not
        with self._tree_lock:
            delta = bytes_ - self.reserved
            node = self
            while node is not None:
                new = node.reserved + delta
                if delta > 0 and node.limit is not None and new > node.limit:
                    raise MemoryReservationError(
                        f"memory limit exceeded at {node.name}: "
                        f"{new} > {node.limit}")
                node = node.parent
            node = self
            while node is not None:
                node.reserved += delta
                node.peak = max(node.peak, node.reserved)
                node = node.parent

    def free(self) -> None:
        self.set_bytes(0)


@dataclasses.dataclass
class OperatorStats:
    operator: str = ""
    input_batches: int = 0
    input_rows: int = 0
    output_batches: int = 0
    output_rows: int = 0
    wall_ns: int = 0
    finish_wall_ns: int = 0
    # which kernel tier served the operator: "direct", "sort", "hash" or
    # "hash+sort" for a GROUP BY; "hash" or "sorted" for a join
    kernel_tier: str = ""

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DriverStats:
    """One driver run (one instantiated pipeline) — the DriverStats
    rollup level between OperatorStats and TaskStats (SURVEY §5.1)."""

    pipeline: str = ""
    operators: int = 0
    input_rows: int = 0
    output_rows: int = 0
    wall_ns: int = 0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TaskStats:
    """Task-level rollup of every operator the task ran."""

    task_id: str = ""
    start_time: float = 0.0
    elapsed_s: float = 0.0
    # sums over operator stats
    wall_ns: int = 0
    input_rows: int = 0
    input_batches: int = 0
    output_rows: int = 0
    output_batches: int = 0
    peak_memory_bytes: int = 0

    def add_operator(self, s: OperatorStats) -> None:
        self.wall_ns += s.wall_ns + s.finish_wall_ns
        self.input_rows += s.input_rows
        self.input_batches += s.input_batches
        self.output_rows += s.output_rows
        self.output_batches += s.output_batches

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StageStats:
    """Per-fragment aggregation across that stage's tasks: additive
    counters sum, wall is the slowest task (the stage critical path),
    peak memory is the largest task (StageStats rollup role)."""

    fragment_id: int = -1
    tasks: int = 0          # tasks placed
    reporting: int = 0      # tasks whose stats were folded in
    input_rows: int = 0
    output_rows: int = 0
    wall_ns: int = 0        # max over tasks
    total_wall_ns: int = 0  # sum over tasks
    peak_memory_bytes: int = 0

    def add_task(self, ts: TaskStats) -> None:
        self.reporting += 1
        self.input_rows += ts.input_rows
        self.output_rows += ts.output_rows
        self.wall_ns = max(self.wall_ns, ts.wall_ns)
        self.total_wall_ns += ts.wall_ns
        self.peak_memory_bytes = max(self.peak_memory_bytes,
                                     ts.peak_memory_bytes)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class QueryContext:
    def __init__(self, config: EngineConfig = DEFAULT,
                 memory_limit: Optional[int] = None):
        self.config = config
        self.memory = MemoryContext(None, "query", limit=memory_limit)
        self.start_time = time.time()


class TaskContext:
    def __init__(self, query: QueryContext, task_id: str = "task-0"):
        self.query = query
        self.task_id = task_id
        self.config = query.config
        self.memory = MemoryContext(query.memory, f"task:{task_id}")
        self.operator_stats: List[OperatorStats] = []
        self.driver_stats: List[DriverStats] = []
        self.start_time = time.time()

    def task_stats(self) -> TaskStats:
        """Roll every operator's stats up into one TaskStats."""
        ts = TaskStats(task_id=self.task_id, start_time=self.start_time)
        for s in list(self.operator_stats):
            ts.add_operator(s)
        ts.peak_memory_bytes = self.memory.peak
        return ts


class OperatorContext:
    def __init__(self, task: TaskContext, name: str):
        self.task = task
        self.config = task.config
        self.name = name
        self.memory = MemoryContext(task.memory, f"op:{name}")
        self.stats = OperatorStats(operator=name)
        task.operator_stats.append(self.stats)
