"""Single-process pipeline runner (LocalQueryRunner's execution half).

The reference's LocalQueryRunner plans SQL then hand-pumps drivers in one
process (presto-main/.../testing/LocalQueryRunner.java:214,616-665).  This
module is the pumping half: it executes a DAG of Pipelines in dependency
order.  The SQL half (sql/ package) lowers plans into these pipelines.

Multi-split pipelines whose leading operators are parallel-safe run as
``config.task_concurrency`` concurrent feed drivers stitched to the rest
of the chain through a LocalExchange (the reference's
AddLocalExchanges.java:95 + LocalExchange.java:53 shape) — host-side scan
decode overlaps the consumer's device work.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

from presto_tpu_torch.config import DEFAULT, EngineConfig
from presto_tpu_torch.exec.context import QueryContext, TaskContext
from presto_tpu_torch.exec.driver import Pipeline


def _parallel_prefix(p: Pipeline, config: EngineConfig) -> int:
    """Length of the leading factory run that may replicate into N
    drivers (0 = run the pipeline single-driver)."""
    if config.task_concurrency <= 1 or len(p.splits) <= 1:
        return 0
    if any(getattr(f, "requires_ordered_input", False)
           for f in p.factories):
        # round-robin feeds would interleave the clustered key order a
        # streaming aggregation depends on
        return 0
    k = 0
    for f in p.factories:
        if getattr(f, "parallel_safe", False):
            k += 1
        else:
            break
    # the whole chain being safe means there is no consumer stage left
    # to protect — still split before the terminal sink
    return min(k, len(p.factories) - 1)


def _run_parallel(p: Pipeline, task: TaskContext, prefix: int,
                  width: int, deadline=None) -> None:
    from presto_tpu_torch.exec.localexchange import (
        LocalExchange, LocalExchangeSinkOperatorFactory,
        LocalExchangeSourceOperatorFactory,
    )

    exchange = LocalExchange(width)
    errors: List[BaseException] = []

    def feed(i: int) -> None:
        feeder = Pipeline(
            p.factories[:prefix]
            + [LocalExchangeSinkOperatorFactory(exchange, producer=i)],
            p.splits[i::width], name=f"{p.name}.feed{i}")
        try:
            feeder.instantiate(task).run_to_completion(deadline=deadline)
        except BaseException as e:  # noqa: BLE001 - crossed to consumer
            errors.append(e)
            exchange.fail(e)

    threads = [threading.Thread(target=feed, args=(i,), daemon=True,
                                name=f"{p.name}.feed{i}")
               for i in range(width)]
    for t in threads:
        t.start()
    consumer = Pipeline(
        [LocalExchangeSourceOperatorFactory(exchange)]
        + p.factories[prefix:], name=p.name)
    try:
        consumer.instantiate(task).run_to_completion(deadline=deadline)
        # a consumer that finished before draining (LIMIT) releases the
        # feeders instead of leaving them blocked on backpressure
        exchange.close()
    except BaseException as e:
        # unblock feeders stuck in put() backpressure, then re-raise
        exchange.fail(e)
        raise
    finally:
        for t in threads:
            t.join(timeout=30)
    if errors:
        raise errors[0]


def execute_pipelines(pipelines: Sequence[Pipeline],
                      config: EngineConfig = DEFAULT,
                      memory_limit: Optional[int] = None) -> TaskContext:
    """Run pipelines sequentially in the given (dependency) order.

    Build pipelines come before their probe pipelines — the planner emits
    them in that order, mirroring how the reference sequences via
    LookupSourceFactory futures.  Returns the TaskContext (stats).
    """
    task = TaskContext(QueryContext(config, memory_limit))
    deadline = (time.monotonic() + config.query_max_run_time_s
                if config.query_max_run_time_s > 0 else None)
    for p in pipelines:
        if deadline is not None and time.monotonic() > deadline:
            raise RuntimeError(
                "Query exceeded maximum run time "
                f"({config.query_max_run_time_s:g}s)")
        prefix = _parallel_prefix(p, config)
        width = min(config.task_concurrency, len(p.splits))
        if prefix > 0 and width > 1:
            _run_parallel(p, task, prefix, width, deadline=deadline)
        else:
            p.instantiate(task).run_to_completion(deadline=deadline)
    return task
