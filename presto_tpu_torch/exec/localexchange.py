"""Intra-task driver parallelism: N scan-feed drivers, one consumer.

The reference runs several drivers per pipeline and stitches them with
LocalExchange (presto-main/.../operator/exchange/LocalExchange.java:53),
planned by AddLocalExchanges (sql/planner/optimizations/
AddLocalExchanges.java:95).  On TPU the kernels are internally parallel,
so the win is HOST-side: several drivers pull splits, decode pages, and
queue device work concurrently while the consumer chain drains — the
scan feed no longer starves the accumulating operator between batches.

``LocalExchange`` is a bounded rendezvous (backpressure both ways):
producers block when the buffer is full (OutputBufferMemoryManager role),
the consumer waits briefly when it is empty.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, List, Optional

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import Operator, OperatorFactory


class LocalExchange:
    """Deterministic N-producer rendezvous: the consumer drains batches
    in strict producer round-robin, so the DOWNSTREAM batch order is a
    pure function of each producer's (deterministic) output — float
    aggregation results stay reproducible run-to-run even though the
    producers execute concurrently (the reference pins the same property
    with PlanDeterminismChecker / TestQueryPlanDeterminism)."""

    def __init__(self, n_producers: int, capacity: int = 16):
        self._queues: List[Deque[Batch]] = [deque()
                                            for _ in range(n_producers)]
        self._done = [False] * n_producers
        self._cursor = 0
        self._capacity = max(capacity // max(n_producers, 1), 2)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._cond = threading.Condition()

    def put(self, producer: int, batch: Batch) -> None:
        with self._cond:
            q = self._queues[producer]
            while (len(q) >= self._capacity and self._error is None
                   and not self._closed):
                self._cond.wait(timeout=1.0)
            if self._error is not None:
                raise self._error
            if not self._closed:
                q.append(batch)
            self._cond.notify_all()

    def close(self) -> None:
        """The consumer finished early (a LIMIT was reached): producers
        stop, and whatever they still send is dropped."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def producer_finished(self, producer: int) -> None:
        with self._cond:
            self._done[producer] = True
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = exc
            self._cond.notify_all()

    def _next_ready_locked(self) -> Optional[int]:
        """The producer whose turn it is, skipping finished-and-empty
        ones; None when every producer is drained.  Waits for the
        CURRENT producer rather than taking whatever arrived first —
        that wait is what buys determinism."""
        n = len(self._queues)
        for _ in range(n):
            q = self._queues[self._cursor]
            if q:
                return self._cursor
            if self._done[self._cursor]:
                self._cursor = (self._cursor + 1) % n
                continue
            return self._cursor  # its turn, but not ready yet
        return None

    def poll(self, wait_s: float = 0.005) -> Optional[Batch]:
        """One batch in deterministic order, or None; raises a
        producer's error."""
        with self._cond:
            if self._error is not None:
                raise self._error
            cur = self._next_ready_locked()
            if cur is not None and not self._queues[cur]:
                self._cond.wait(timeout=wait_s)
                if self._error is not None:
                    raise self._error
                cur = self._next_ready_locked()
            if cur is None or not self._queues[cur]:
                return None
            out = self._queues[cur].popleft()
            self._cursor = (cur + 1) % len(self._queues)
            self._cond.notify_all()
            return out

    def drained(self) -> bool:
        with self._cond:
            return all(self._done) and not any(self._queues)


class LocalExchangeSinkOperator(Operator):
    def __init__(self, ctx: OperatorContext, exchange: LocalExchange,
                 producer: int, signal_finish: bool):
        super().__init__(ctx)
        self.exchange = exchange
        self.producer = producer
        self.signal_finish = signal_finish

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        self.exchange.put(self.producer, batch)

    def needs_input(self) -> bool:
        return not self._finishing and not self.exchange.closed

    def finish(self) -> None:
        if not self._finishing and self.signal_finish:
            self.exchange.producer_finished(self.producer)
        super().finish()

    def is_finished(self) -> bool:
        return self._finishing or self.exchange.closed


class LocalExchangeSinkOperatorFactory(OperatorFactory):
    def __init__(self, exchange: LocalExchange, producer: int = 0,
                 signal_finish: bool = True):
        """``signal_finish=False`` for SEQUENTIAL pipelines sharing one
        producer slot (grouped-execution lifespans): the owner signals
        once after the last pipeline, since a strict round-robin
        consumer must never wait on a producer that has not started."""
        self.exchange = exchange
        self.producer = producer
        self.signal_finish = signal_finish

    def create(self, ctx: OperatorContext) -> LocalExchangeSinkOperator:
        return LocalExchangeSinkOperator(ctx, self.exchange,
                                         self.producer,
                                         self.signal_finish)


class LocalExchangeSourceOperator(Operator):
    def __init__(self, ctx: OperatorContext, exchange: LocalExchange):
        super().__init__(ctx)
        self.exchange = exchange

    def needs_input(self) -> bool:
        return False

    def get_output(self) -> Optional[Batch]:
        batch = self.exchange.poll()
        if batch is not None:
            self.ctx.stats.output_rows += batch.num_rows
        return batch

    def is_finished(self) -> bool:
        return self.exchange.drained()


class LocalExchangeSourceOperatorFactory(OperatorFactory):
    def __init__(self, exchange: LocalExchange):
        self.exchange = exchange

    def create(self, ctx: OperatorContext) -> LocalExchangeSourceOperator:
        return LocalExchangeSourceOperator(ctx, self.exchange)
