"""Query event stream: the EventListener SPI.

Role model: presto-spi/.../eventlistener/ + QueryMonitor
(presto-main/.../event/QueryMonitor.java:74,116,184): the engine emits
queryCreated / queryCompleted events to pluggable listeners (audit,
metrics shipping, query logs).  Listeners receive typed dataclasses;
exceptions in listeners are swallowed (an observer must never fail a
query), matching the reference's isolation stance.  The distributed
tier's fault-tolerance events come with that tier (ROADMAP A13).
``QueryKilledEvent`` is fired by ``CALL system.runtime.kill_query``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    user: str
    sql: str
    create_time: float
    trace_token: str = ""


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    user: str
    sql: str
    state: str                      # FINISHED | FAILED
    error: Optional[str]
    create_time: float
    end_time: float
    output_rows: int
    peak_memory_bytes: int
    operator_stats: List[Dict[str, Any]]
    trace_token: str = ""
    # per-stage rollup (StageStats.as_dict() per fragment); the local
    # tier reports its single task as one stage
    stage_stats: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def wall_s(self) -> float:
        return self.end_time - self.create_time


#: (errorName, errorType, errorCode) of an administrative kill
#: (StandardErrorCode layout: USER_ERROR codes are based at 0x0000_0000),
#: as the JAX package's coordinator defines it
ADMINISTRATIVELY_KILLED = ("ADMINISTRATIVELY_KILLED", "USER_ERROR",
                           0x0000_0005)


@dataclasses.dataclass(frozen=True)
class QueryKilledEvent:
    """An operator failed a query via CALL system.runtime.kill_query:
    ``reason`` names the path ('kill_query'), and the error name is the
    one the client sees (ADMINISTRATIVELY_KILLED)."""

    query_id: str
    trace_token: str
    user: str
    reason: str
    error_name: str
    message: str
    time: float


class EventListener:
    """Implement any subset (EventListener SPI surface)."""

    def query_created(self, event: QueryCreatedEvent) -> None:
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        pass

    def query_killed(self, event: QueryKilledEvent) -> None:
        pass


class EventBus:
    def __init__(self):
        self.listeners: List[EventListener] = []

    def register(self, listener: EventListener) -> None:
        self.listeners.append(listener)

    def _fire(self, method: str, event) -> None:
        for lst in self.listeners:
            try:
                getattr(lst, method)(event)
            except Exception:  # noqa: BLE001 - observers never fail queries
                pass

    def query_created(self, event: QueryCreatedEvent) -> None:
        self._fire("query_created", event)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        self._fire("query_completed", event)

    def query_killed(self, event: QueryKilledEvent) -> None:
        self._fire("query_killed", event)


def now() -> float:
    return time.time()
