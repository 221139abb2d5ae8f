"""LocalQueryRunner: SQL in, rows out, one process, on one device.

The reference's LocalQueryRunner (presto-main/.../testing/LocalQueryRunner
.java:214,577) runs the full stack — parser, analyzer, planner, operators —
in one process with hand-pumped drivers.  Same role here:

    runner = LocalQueryRunner.tpch(scale=1.0)          # on cuda
    result = runner.execute("select count(*) from lineitem")
    result.rows

The runner carries its device: ``cuda`` unless the caller names another
(``device="cpu"``, as the tests do).  It runs ``SELECT`` and ``EXPLAIN``;
every other statement raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import List, Tuple

from presto_tpu_torch import events as ev
from presto_tpu_torch import types as T
from presto_tpu_torch.config import DEFAULT, EngineConfig, resolve_device
from presto_tpu_torch.connectors.api import ConnectorRegistry
from presto_tpu_torch.exec.runner import execute_pipelines
from presto_tpu_torch.session import AllowAllAccessControl, Session
from presto_tpu_torch.sql import tree as t
from presto_tpu_torch.sql.optimizer import optimize
from presto_tpu_torch.sql.parser import parse_statement
from presto_tpu_torch.sql.physical import PhysicalPlanner
from presto_tpu_torch.sql.plan import TableScanNode, format_plan
from presto_tpu_torch.sql.planner import Metadata, Planner


@dataclasses.dataclass
class QueryResult:
    column_names: List[str]
    column_types: List[T.Type]
    rows: List[Tuple]


class LocalQueryRunner:
    def __init__(self, registry: ConnectorRegistry, default_catalog: str,
                 config: EngineConfig = DEFAULT, session=None,
                 access_control=None, device=None):
        self.registry = registry
        self.metadata = Metadata(registry, default_catalog)
        self.config = config
        self.device = resolve_device(device)
        self.session = session or Session(catalog=default_catalog)
        self.access_control = access_control or AllowAllAccessControl()
        self.event_bus = ev.EventBus()
        self._last_task = None
        self._query_seq = 0

    @classmethod
    def tpch(cls, scale: float = 0.01, config: EngineConfig = DEFAULT,
             session=None, access_control=None,
             device=None) -> "LocalQueryRunner":
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector
        from presto_tpu_torch.connectors.tpch import TpchConnector

        reg = ConnectorRegistry()
        reg.register("tpch", TpchConnector(scale=scale))
        reg.register("tpcds", TpcdsConnector(scale=scale))
        return cls(reg, "tpch", config, session=session,
                   access_control=access_control, device=device)

    # --- statements --------------------------------------------------------
    def execute(self, sql: str) -> QueryResult:
        self._query_seq += 1
        qid = f"local-{self._query_seq}"
        trace = f"tt-{uuid.uuid4().hex[:12]}"
        created = ev.now()
        self.event_bus.query_created(ev.QueryCreatedEvent(
            qid, self.session.user, sql, created, trace_token=trace))
        self._last_task = None
        try:
            result = self._execute_statement(parse_statement(sql))
        except Exception as e:
            self.event_bus.query_completed(ev.QueryCompletedEvent(
                qid, self.session.user, sql, "FAILED", str(e), created,
                ev.now(), 0, 0, [], trace_token=trace))
            raise
        task = self._last_task
        # the single-process tier reports its one task as one stage, so
        # local and distributed QueryCompletedEvents share a shape
        stage_stats = []
        if task is not None:
            from presto_tpu_torch.exec.context import StageStats

            st = StageStats(fragment_id=0, tasks=1)
            ts = task.task_stats()
            ts.elapsed_s = ev.now() - created
            st.add_task(ts)
            stage_stats = [st.as_dict()]
        self.event_bus.query_completed(ev.QueryCompletedEvent(
            qid, self.session.user, sql, "FINISHED", None, created,
            ev.now(), len(result.rows),
            task.memory.peak if task is not None else 0,
            [s.as_dict() for s in task.operator_stats]
            if task is not None else [],
            trace_token=trace, stage_stats=stage_stats))
        return result

    def _execute_statement(self, stmt: t.Node) -> QueryResult:
        if isinstance(stmt, t.Explain):
            if stmt.analyze or stmt.plan_type != "logical":
                raise NotImplementedError(
                    "EXPLAIN ANALYZE and the typed EXPLAIN variants are not "
                    "in presto_tpu_torch yet: ROADMAP A4")
            text = self.explain_text(stmt.statement)
            return QueryResult(["Query Plan"], [T.VARCHAR],
                               [(line,) for line in text.splitlines()])
        if not isinstance(stmt, (t.Query, t.SetOperation)):
            raise NotImplementedError(
                f"{type(stmt).__name__} statements are not in "
                "presto_tpu_torch yet: ROADMAP A4 (the single-node "
                "statements) ports them")
        return self._execute_query(stmt)

    def explain(self, sql: str) -> str:
        stmt = parse_statement(sql)
        if isinstance(stmt, t.Explain):
            stmt = stmt.statement
        return self.explain_text(stmt)

    def explain_text(self, stmt: t.Node) -> str:
        if not isinstance(stmt, (t.Query, t.SetOperation)):
            raise ValueError("EXPLAIN requires a query")
        cfg = self.config
        logical = Planner(self.metadata).plan(stmt)
        optimized = optimize(logical, self.metadata, cfg)
        # surface the optimizer's estimates alongside the plan (the
        # PlanPrinter stats/cost annotation role)
        annotator = None
        if cfg.optimizer_use_memo:
            from presto_tpu_torch.sql.memo import cost_annotator

            annotator = cost_annotator(self.metadata, cfg)
        return format_plan(optimized, annotator=annotator)

    def _check_scans(self, node) -> None:
        if isinstance(node, TableScanNode):
            self.access_control.check_can_select(
                self.session.user, node.catalog, node.table)
        for s in node.sources:
            self._check_scans(s)

    def _execute_query(self, q: t.Node) -> QueryResult:
        cfg = self.config
        logical = Planner(self.metadata).plan(q)
        optimized = optimize(logical, self.metadata, cfg)
        self._check_scans(optimized)
        phys = PhysicalPlanner(self.registry, self.device, cfg).plan(
            optimized)
        self._last_task = execute_pipelines(
            phys.pipelines, cfg,
            memory_limit=cfg.query_max_memory_bytes or None)
        return QueryResult(phys.column_names, phys.column_types,
                           phys.collector.rows())
