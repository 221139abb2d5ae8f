"""LocalQueryRunner: SQL in, rows out, one process, on one device.

The reference's LocalQueryRunner (presto-main/.../testing/LocalQueryRunner
.java:214,577) runs the full stack — parser, analyzer, planner, operators —
in one process with hand-pumped drivers.  Same role here:

    runner = LocalQueryRunner.tpch(scale=1.0)          # on cuda
    runner.execute("create table memory.li as select * from lineitem")
    result = runner.execute("select count(*) from memory.li")
    result.rows

The runner carries its device: ``cuda`` unless the caller names another
(``device="cpu"``, as the tests do).  Its ``memory`` catalog keeps its
tables on that device, and the ``system`` and ``information_schema``
catalogs build their batches there.  It runs queries; EXPLAIN, EXPLAIN
ANALYZE and EXPLAIN (TYPE IO | VALIDATE); CREATE TABLE [AS], INSERT,
DELETE, DROP TABLE, ALTER TABLE ... RENAME, ANALYZE and SHOW STATS;
CREATE [OR REPLACE] VIEW, DROP VIEW and SHOW CREATE VIEW; PREPARE,
EXECUTE, DEALLOCATE and DESCRIBE INPUT/OUTPUT; SHOW CATALOGS, SCHEMAS,
FUNCTIONS, TABLES, COLUMNS/DESCRIBE and CREATE TABLE; SET/RESET/SHOW
SESSION; USE; START TRANSACTION, COMMIT and ROLLBACK; GRANT and REVOKE;
and CALL system.runtime.kill_query.  ARRAY, MAP and ROW result columns
come back as Python lists, dicts and tuples, as presto_tpu's do.
EXPLAIN (TYPE DISTRIBUTED), which
prints the distributed tier's fragments, raises ``NotImplementedError``
naming ROADMAP A13.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import List, Optional, Tuple

import torch

from presto_tpu_torch import events as ev
from presto_tpu_torch import types as T
from presto_tpu_torch.config import DEFAULT, EngineConfig, resolve_device
from presto_tpu_torch.connectors.api import (
    ColumnMetadata, ConnectorRegistry, TableSchema,
)
from presto_tpu_torch.exec.runner import execute_pipelines
from presto_tpu_torch.session import (
    AllowAllAccessControl, GrantStore, Session, TransactionManager,
)
from presto_tpu_torch.sql import tree as t
from presto_tpu_torch.sql.optimizer import optimize
from presto_tpu_torch.sql.parser import parse_statement
from presto_tpu_torch.sql.physical import PhysicalPlanner
from presto_tpu_torch.sql.plan import TableScanNode, format_plan
from presto_tpu_torch.sql.planner import Metadata, Planner

# ``nodes`` row of the single-process runner's system catalog
_LOCAL_NODE = ("local", "local://", "dev", True, "ACTIVE")


@dataclasses.dataclass
class QueryResult:
    column_names: List[str]
    column_types: List[T.Type]
    rows: List[Tuple]


class _StagingSink:
    """PageSink wrapper that buffers until the enclosing explicit
    transaction commits (TransactionManager commit action)."""

    def __init__(self, inner):
        self.inner = inner
        self.batches = []
        self._rows = 0

    def append(self, batch) -> None:
        self.batches.append(batch)
        self._rows += batch.num_rows

    def finish(self) -> int:
        return self._rows

    def publish(self) -> None:
        for b in self.batches:
            self.inner.append(b)
        self.inner.finish()
        self.batches = []


def _like(value: str, pattern: Optional[str]) -> bool:
    """SQL LIKE for SHOW ... LIKE filters (% and _ wildcards)."""
    if pattern is None:
        return True
    import re

    rx = "".join(".*" if c == "%" else "." if c == "_" else re.escape(c)
                 for c in pattern)
    return re.fullmatch(rx, value) is not None


class LocalQueryRunner:
    def __init__(self, registry: ConnectorRegistry, default_catalog: str,
                 config: EngineConfig = DEFAULT, session=None,
                 access_control=None, session_property_manager=None,
                 device=None):
        self.registry = registry
        self.metadata = Metadata(registry, default_catalog)
        self.config = config
        self.device = resolve_device(device)
        self.session = session or Session(catalog=default_catalog)
        if session_property_manager is not None:
            # rule-based session defaults (SET SESSION still overrides)
            session_property_manager.apply(self.session)
        self.access_control = access_control or AllowAllAccessControl()
        self.grants = GrantStore()
        if hasattr(self.access_control, "grants") and \
                self.access_control.grants is None:
            self.access_control.grants = self.grants
        self.transaction_manager = TransactionManager()
        self.event_bus = ev.EventBus()
        self._last_task = None
        self._query_seq = 0
        # kill_query's view of the runner: ids it has executed (all
        # terminal: execution is synchronous) and the statement on the
        # caller's thread
        self._query_ids: set = set()
        self._current_query_id: Optional[str] = None

    @classmethod
    def tpch(cls, scale: float = 0.01, config: EngineConfig = DEFAULT,
             session=None, access_control=None,
             device=None) -> "LocalQueryRunner":
        from presto_tpu_torch.connectors.memory import (
            BlackHoleConnector, MemoryConnector,
        )
        from presto_tpu_torch.connectors.system import (
            InformationSchemaConnector, SystemConnector,
        )
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector
        from presto_tpu_torch.connectors.tpch import TpchConnector

        device = resolve_device(device)
        reg = ConnectorRegistry()
        reg.register("tpch", TpchConnector(scale=scale))
        reg.register("tpcds", TpcdsConnector(scale=scale))
        reg.register("memory", MemoryConnector(device))
        reg.register("blackhole", BlackHoleConnector())
        reg.register("system", SystemConnector(
            device, nodes_fn=lambda: [_LOCAL_NODE]))
        reg.register("information_schema",
                     InformationSchemaConnector(reg, device))
        return cls(reg, "tpch", config, session=session,
                   access_control=access_control, device=device)

    # --- statements --------------------------------------------------------
    def execute(self, sql: str) -> QueryResult:
        self._query_seq += 1
        qid = f"local-{self._query_seq}"
        self._current_query_id = qid
        self._query_ids.add(qid)
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
        if isinstance(stmt, t.CallProcedure):
            return self._run_kill_query(stmt)
        if isinstance(stmt, t.Explain):
            if stmt.analyze:
                text = self.explain_analyze_text(stmt.statement)
            elif stmt.plan_type == "distributed":
                raise NotImplementedError(
                    "EXPLAIN (TYPE DISTRIBUTED) prints the distributed "
                    "tier's fragments: ROADMAP A13")
            elif stmt.plan_type == "validate":
                self._validate(stmt.statement)
                return QueryResult(["Valid"], [T.BOOLEAN], [(True,)])
            elif stmt.plan_type == "io":
                return self._explain_io(stmt.statement)
            else:
                text = self.explain_text(stmt.statement)
            return QueryResult(["Query Plan"], [T.VARCHAR],
                               [(line,) for line in text.splitlines()])
        if isinstance(stmt, t.ShowTables):
            cat = stmt.catalog or self.metadata.default_catalog
            names = set(self.registry.get(cat).list_tables())
            names.update(n for c, n in self.registry.views if c == cat)
            return QueryResult(["Table"], [T.VARCHAR],
                               [(n,) for n in sorted(names)
                                if _like(n, stmt.like)])
        if isinstance(stmt, t.ShowColumns):
            _, _, _, schema = self.metadata.resolve_table(stmt.table)
            return QueryResult(
                ["Column", "Type"], [T.VARCHAR, T.VARCHAR],
                [(n, schema.column_type(n).display())
                 for n in schema.column_names()])
        if isinstance(stmt, t.SetSession):
            self.session.set_property(stmt.name, stmt.value)
            return self._ok()
        if isinstance(stmt, t.ResetSession):
            self.session.reset_property(stmt.name)
            return self._ok()
        if isinstance(stmt, t.ShowSession):
            return QueryResult(
                ["Name", "Value", "Default"],
                [T.VARCHAR, T.VARCHAR, T.VARCHAR],
                self.session.show_properties(self.config))
        if isinstance(stmt, t.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, t.CreateTableAs):
            return self._create_table_as(stmt)
        if isinstance(stmt, t.Insert):
            return self._insert(stmt)
        if isinstance(stmt, t.DropTable):
            # unknown catalog is an error even under IF EXISTS; only a
            # missing table is forgiven
            cat, _tbl = self.metadata.split_name(stmt.table)
            self.registry.get(cat)
            try:
                catalog, name, conn, _ = self.metadata.resolve_table(
                    stmt.table)
            except Exception:
                if stmt.if_exists:
                    return self._ok()
                raise
            self.access_control.check_can_drop_table(
                self.session.user, catalog, name)
            conn.drop_table(name)
            return self._ok()
        if isinstance(stmt, t.Delete):
            return self._delete(stmt)
        if isinstance(stmt, t.RenameTable):
            catalog, name, conn, _ = self.metadata.resolve_table(stmt.table)
            if len(stmt.new_name) == 1:
                new_cat, new_name = catalog, stmt.new_name[0]
            else:
                new_cat, new_name = self.metadata.split_name(stmt.new_name)
            if new_cat != catalog:
                raise ValueError("RENAME cannot move between catalogs")
            self.access_control.check_can_rename_table(
                self.session.user, catalog, name)
            conn.rename_table(name, new_name)
            self.grants.rename_table(catalog, name, new_name)
            self.access_control.notify_table_renamed(catalog, name,
                                                     new_name)
            return self._ok()
        if isinstance(stmt, t.CreateView):
            self.metadata.create_view(stmt.view, stmt.original_sql,
                                      stmt.replace)
            return self._ok()
        if isinstance(stmt, t.DropView):
            self.metadata.drop_view(stmt.view, stmt.if_exists)
            return self._ok()
        if isinstance(stmt, t.Prepare):
            self.session.prepared[stmt.name] = stmt.statement
            return self._ok()
        if isinstance(stmt, t.ExecutePrepared):
            prepared = self._get_prepared(stmt.name)
            return self._execute_statement(
                t.substitute_parameters(prepared, stmt.parameters))
        if isinstance(stmt, t.Deallocate):
            self._get_prepared(stmt.name)
            del self.session.prepared[stmt.name]
            return self._ok()
        if isinstance(stmt, t.DescribeInput):
            n = t.parameter_count(self._get_prepared(stmt.name))
            return QueryResult(
                ["Position", "Type"], [T.BIGINT, T.VARCHAR],
                [(i, "unknown") for i in range(n)])
        if isinstance(stmt, t.DescribeOutput):
            return self._describe_output(self._get_prepared(stmt.name))
        if isinstance(stmt, t.ShowCatalogs):
            rows = [(c,) for c in self.registry.catalogs()
                    if _like(c, stmt.like)]
            return QueryResult(["Catalog"], [T.VARCHAR], rows)
        if isinstance(stmt, t.ShowSchemas):
            cat = stmt.catalog or self.metadata.default_catalog
            self.registry.get(cat)  # raises for unknown catalog
            rows = [(s,) for s in ("default", "information_schema")
                    if _like(s, stmt.like)]
            return QueryResult(["Schema"], [T.VARCHAR], rows)
        if isinstance(stmt, t.ShowFunctions):
            from presto_tpu_torch.expr.functions import function_names

            rows = [(n, kind) for n, kind in function_names()
                    if _like(n, stmt.like)]
            return QueryResult(["Function", "Function Type"],
                               [T.VARCHAR, T.VARCHAR], rows)
        if isinstance(stmt, t.ShowStats):
            return self._show_stats(stmt)
        if isinstance(stmt, t.ShowCreateTable):
            _, name, _, schema = self.metadata.resolve_table(stmt.table)
            cols = ",\n".join(
                f"   {n} {schema.column_type(n).display()}"
                for n in schema.column_names())
            ddl = f"CREATE TABLE {'.'.join(stmt.table)} (\n{cols}\n)"
            return QueryResult(["Create Table"], [T.VARCHAR], [(ddl,)])
        if isinstance(stmt, t.ShowCreateView):
            sql = self.metadata.get_view(stmt.view)
            if sql is None:
                raise ValueError(
                    f"view {'.'.join(stmt.view)} does not exist")
            ddl = f"CREATE VIEW {'.'.join(stmt.view)} AS\n{sql}"
            return QueryResult(["Create View"], [T.VARCHAR], [(ddl,)])
        if isinstance(stmt, t.Use):
            self.registry.get(stmt.catalog)  # raises for unknown catalog
            self.session.catalog = stmt.catalog
            self.session.schema = stmt.schema
            self.metadata.default_catalog = stmt.catalog
            return self._ok()
        if isinstance(stmt, t.StartTransaction):
            if self.session.txn is not None:
                raise ValueError("transaction already in progress")
            self.session.txn = self.transaction_manager.begin(
                auto_commit=False)
            return self._ok()
        if isinstance(stmt, t.Commit):
            if self.session.txn is None:
                raise ValueError("no transaction in progress")
            self.transaction_manager.commit(self.session.txn)
            self.session.txn = None
            return self._ok()
        if isinstance(stmt, t.Rollback):
            if self.session.txn is None:
                raise ValueError("no transaction in progress")
            self.transaction_manager.abort(self.session.txn)
            self.session.txn = None
            return self._ok()
        if isinstance(stmt, t.Analyze):
            _, name, conn, _ = self.metadata.resolve_table(stmt.table)
            conn.collect_statistics(conn.get_table(name))
            return self._ok()
        if isinstance(stmt, (t.Grant, t.Revoke)):
            catalog, name = self.metadata.split_name(stmt.table)
            self.access_control.check_can_grant(
                self.session.user, catalog, name)
            apply = (self.grants.grant if isinstance(stmt, t.Grant)
                     else self.grants.revoke)
            apply(stmt.grantee, catalog, name, stmt.privileges)
            return self._ok()
        if not isinstance(stmt, (t.Query, t.SetOperation)):
            raise ValueError(f"unsupported statement {type(stmt).__name__}")
        return self._execute_query(stmt)

    @staticmethod
    def _ok() -> QueryResult:
        return QueryResult(["result"], [T.BOOLEAN], [(True,)])

    def _get_prepared(self, name: str) -> t.Node:
        stmt = self.session.prepared.get(name)
        if stmt is None:
            raise ValueError(f"prepared statement not found: {name}")
        return stmt

    def _describe_output(self, stmt: t.Node) -> QueryResult:
        if isinstance(stmt, (t.Query, t.SetOperation)):
            n_params = t.parameter_count(stmt)
            bound = t.substitute_parameters(
                stmt, tuple(t.NullLiteral() for _ in range(n_params)))
            logical = Planner(self.metadata).plan(bound)
            rows = [(cn, ty.display()) for cn, ty in logical.columns]
        elif isinstance(stmt, (t.Insert, t.CreateTableAs, t.Delete)):
            rows = [("rows", "bigint")]
        else:
            rows = [("result", "boolean")]
        return QueryResult(["Column Name", "Type"], [T.VARCHAR, T.VARCHAR],
                           rows)

    def _run_kill_query(self, stmt: t.CallProcedure) -> QueryResult:
        """CALL system.runtime.kill_query, the coordinator procedure's
        single-process twin (KillQueryProcedure.java role): the JAX
        package's name and argument checks and messages, and the
        ADMINISTRATIVELY_KILLED shape in the fired ``QueryKilledEvent``.
        Statements run synchronously on the caller's thread, so any valid
        target is already terminal and the kill itself is the no-op the
        coordinator applies to terminal queries."""
        name = ".".join(stmt.name)
        if name not in ("system.runtime.kill_query", "kill_query"):
            raise ValueError(f"unknown procedure {name}")
        if len(stmt.args) < 1 or not isinstance(stmt.args[0],
                                                t.StringLiteral):
            raise ValueError("kill_query(query_id) requires a string id")
        qid = stmt.args[0].value
        message = "Query killed via kill_query"
        if len(stmt.args) > 1:
            if not isinstance(stmt.args[1], t.StringLiteral):
                raise ValueError(
                    "kill_query(query_id, message) requires a string "
                    "message")
            if stmt.args[1].value:
                message = f"Query killed via kill_query: " \
                          f"{stmt.args[1].value}"
        if qid == self._current_query_id:
            raise ValueError("a query cannot kill itself")
        if qid not in self._query_ids:
            raise ValueError(f"no such query {qid!r}")
        self.event_bus.query_killed(ev.QueryKilledEvent(
            qid, "", self.session.user, "kill_query",
            ev.ADMINISTRATIVELY_KILLED[0], message, ev.now()))
        return QueryResult(["result"], [T.VARCHAR], [("killed",)])

    def _show_stats(self, stmt: t.ShowStats) -> QueryResult:
        _, name, conn, schema = self.metadata.resolve_table(stmt.table)
        stats = conn.table_statistics(conn.get_table(name))
        names = ["column_name", "data_size", "distinct_values_count",
                 "nulls_fraction", "row_count", "low_value", "high_value"]
        types = [T.VARCHAR, T.DOUBLE, T.DOUBLE, T.DOUBLE, T.DOUBLE,
                 T.VARCHAR, T.VARCHAR]
        rows: List[Tuple] = []
        if stats is not None:
            for cn in schema.column_names():
                rows.append((
                    cn,
                    stats.data_size.get(cn),
                    stats.ndv.get(cn),
                    stats.nulls_fraction.get(cn),
                    None,
                    str(stats.low[cn]) if cn in stats.low else None,
                    str(stats.high[cn]) if cn in stats.high else None))
            rows.append((None, None, None, None, float(stats.row_count),
                         None, None))
        return QueryResult(names, types, rows)

    def _delete(self, stmt: t.Delete) -> QueryResult:
        """DELETE FROM t WHERE pred: the predicate is evaluated
        connector-side on each stored batch's device, as the filter of
        FilterProjectOperator is (the reference's beginDelete +
        DeleteOperator + rowId path, presto-main/.../operator/
        DeleteOperator.java:39, collapsed to a mask-rewrite since storage
        is engine-local).  A NULL predicate deletes nothing."""
        from presto_tpu_torch.expr.compile import evaluate
        from presto_tpu_torch.expr.xp import TorchXp
        from presto_tpu_torch.sql.planner import Field, Scope, Translator

        catalog, name, conn, schema = self.metadata.resolve_table(
            stmt.table)
        self.access_control.check_can_delete(
            self.session.user, catalog, name)
        handle = conn.get_table(name)
        if stmt.where is None:
            def mask_fn(b):
                return torch.ones(b.num_rows, dtype=torch.bool,
                                  device=b.device)
        else:
            scope = Scope([Field(n, name, schema.column_type(n))
                           for n in schema.column_names()], None)
            pred = Translator(scope).translate(stmt.where)
            if pred.type != T.BOOLEAN:
                raise ValueError("DELETE predicate must be boolean")

            def mask_fn(b):
                xp = TorchXp(b.device)
                col = evaluate(pred, b, xp)
                mask = xp.asarray(col.values)[:b.num_rows].bool()
                if col.valid is not None:
                    mask = mask & xp.asarray(col.valid)[:b.num_rows]
                return mask

        deleted = conn.delete_rows(handle, mask_fn)
        return QueryResult(["rows"], [T.BIGINT], [(deleted,)])

    # --- DML (TableWriter path, SURVEY §2.6 write operators) ---------------
    def _resolve_write_target(self, table):
        """catalog + bare table name for CREATE/INSERT targets."""
        parts = tuple(table)
        if len(parts) == 1:
            return self.metadata.default_catalog, parts[0]
        if len(parts) == 2:
            return parts[0], parts[1]
        raise ValueError(f"bad table name {'.'.join(parts)}")

    def _create_table(self, stmt: t.CreateTable) -> QueryResult:
        catalog, name = self._resolve_write_target(stmt.table)
        self.access_control.check_can_create_table(
            self.session.user, catalog, name)
        conn = self.registry.get(catalog)
        if stmt.if_not_exists and self._table_exists(conn, name):
            return self._ok()
        schema = TableSchema(name, tuple(
            ColumnMetadata(cn, T.parse_type(ct))
            for cn, ct in stmt.columns))
        conn.create_table(name, schema, dict(stmt.properties) or None)
        return self._ok()

    @staticmethod
    def _table_exists(conn, name: str) -> bool:
        try:
            return conn.get_table(name) is not None
        except Exception:
            return False

    def prepare_ctas(self, stmt: t.CreateTableAs):
        """Plan CTAS: returns (logical OutputNode | None-if-exists, conn,
        handle, catalog, name)."""
        logical = Planner(self.metadata).plan(stmt.query)
        catalog, name = self._resolve_write_target(stmt.table)
        self.access_control.check_can_create_table(
            self.session.user, catalog, name)
        conn = self.registry.get(catalog)
        if stmt.if_not_exists and self._table_exists(conn, name):
            return None, conn, None, catalog, name
        schema = TableSchema(name, tuple(
            ColumnMetadata(cn, typ) for cn, typ in logical.columns))
        handle = conn.create_table(name, schema,
                                   dict(stmt.properties) or None)
        return logical, conn, handle, catalog, name

    def _create_table_as(self, stmt: t.CreateTableAs) -> QueryResult:
        logical, conn, handle, _, _ = self.prepare_ctas(stmt)
        if logical is None:
            return QueryResult(["rows"], [T.BIGINT], [(0,)])
        return self._write(logical, conn, handle)

    def prepare_insert(self, stmt: t.Insert):
        """Plan INSERT with column alignment/coercion: returns
        (logical OutputNode, conn, handle, catalog, name)."""
        from presto_tpu_torch.expr import build as B
        from presto_tpu_torch.sql.plan import OutputNode, ProjectNode

        catalog, name = self._resolve_write_target(stmt.table)
        self.access_control.check_can_insert(
            self.session.user, catalog, name)
        conn = self.registry.get(catalog)
        handle = conn.get_table(name)
        schema = conn.table_schema(handle)

        if isinstance(stmt.source, t.InlineValues):
            query: t.Node = t.Query(
                (t.SelectItem(t.Star()),), (stmt.source,))
        else:
            query = stmt.source
        logical = Planner(self.metadata).plan(query)

        src_cols = stmt.columns or tuple(schema.column_names())
        if len(logical.columns) != len(src_cols):
            raise ValueError(
                f"INSERT has {len(logical.columns)} columns, expected "
                f"{len(src_cols)}")
        # align + coerce to the table's column order and types; unnamed
        # target columns get NULL
        by_name = dict(zip(src_cols, range(len(src_cols))))
        exprs = []
        for cn in schema.column_names():
            typ = schema.column_type(cn)
            if cn in by_name:
                i = by_name[cn]
                ref = B.ref(i, logical.columns[i][1])
                exprs.append(ref if ref.type == typ else B.cast(ref, typ))
            else:
                exprs.append(B.null(typ))
        cols = tuple((cn, schema.column_type(cn))
                     for cn in schema.column_names())
        project = ProjectNode(logical.source, tuple(exprs), cols)
        return OutputNode(project, cols), conn, handle, catalog, name

    def _insert(self, stmt: t.Insert) -> QueryResult:
        logical, conn, handle, _, _ = self.prepare_insert(stmt)
        return self._write(logical, conn, handle)

    def _write(self, logical, conn, handle) -> QueryResult:
        from presto_tpu_torch.exec.operators import TableWriterOperatorFactory

        cfg = self.session.effective_config(self.config)
        # the JAX package plans writes with the default optimizer
        # settings; the session's apply to their execution
        optimized = optimize(logical, self.metadata)
        self._check_scans(optimized)
        planner = PhysicalPlanner(self.registry, self.device, cfg)
        sink = conn.page_sink(handle)
        explicit = self.session.txn
        if explicit is not None:
            # START TRANSACTION write: stage pages; publish at COMMIT
            # (ROLLBACK discards).  DDL stays non-transactional, matching
            # most reference connectors.
            sink = _StagingSink(sink)
            explicit.commit_actions.append(sink.publish)
        writer = TableWriterOperatorFactory(sink)
        pipelines = planner.plan_fragment(optimized.source, writer)
        # auto-commit: the PageSink's finish IS the commit point; failures
        # before it leave the table untouched
        txn = explicit or self.transaction_manager.begin()
        try:
            execute_pipelines(pipelines, cfg)
        except Exception:
            self.transaction_manager.abort(txn)
            if explicit is not None:
                self.session.txn = None
            raise
        if explicit is None:
            self.transaction_manager.commit(txn)
        return QueryResult(["rows"], [T.BIGINT],
                           [(writer.op.rows_written,)])

    def explain(self, sql: str) -> str:
        stmt = parse_statement(sql)
        if isinstance(stmt, t.Explain):
            stmt = stmt.statement
        return self.explain_text(stmt)

    def explain_text(self, stmt: t.Node) -> str:
        if not isinstance(stmt, (t.Query, t.SetOperation)):
            raise ValueError("EXPLAIN requires a query")
        cfg = self.session.effective_config(self.config)
        logical = Planner(self.metadata).plan(stmt)
        optimized = optimize(logical, self.metadata, cfg)
        # surface the optimizer's estimates alongside the plan (the
        # PlanPrinter stats/cost annotation role)
        annotator = None
        if cfg.optimizer_use_memo:
            from presto_tpu_torch.sql.memo import cost_annotator

            annotator = cost_annotator(self.metadata, cfg)
        return format_plan(optimized, annotator=annotator)

    def _validate(self, stmt: t.Node) -> None:
        """EXPLAIN (TYPE VALIDATE): analyze/plan without executing.
        Queries plan fully; DML validates its target and source; DDL
        validates names/types; errors raise instead of reporting Valid."""
        if isinstance(stmt, (t.Query, t.SetOperation)):
            optimize(Planner(self.metadata).plan(stmt), self.metadata)
            return
        if isinstance(stmt, t.Insert):
            catalog, name = self._resolve_write_target(stmt.table)
            conn = self.registry.get(catalog)
            conn.table_schema(conn.get_table(name))
            source = (t.Query((t.SelectItem(t.Star()),), (stmt.source,))
                      if isinstance(stmt.source, t.InlineValues)
                      else stmt.source)
            Planner(self.metadata).plan(source)
            return
        if isinstance(stmt, t.CreateTableAs):
            Planner(self.metadata).plan(stmt.query)
            return
        if isinstance(stmt, t.CreateTable):
            for _cn, ct in stmt.columns:
                T.parse_type(ct)
            return
        if isinstance(stmt, (t.Delete, t.ShowStats, t.Analyze)):
            self.metadata.resolve_table(stmt.table)
            return
        if isinstance(stmt, (t.DropTable, t.RenameTable)):
            if not getattr(stmt, "if_exists", False):
                self.metadata.resolve_table(stmt.table)
            return
        # session/metadata statements: parsing was the validation

    def _explain_io(self, stmt: t.Node) -> QueryResult:
        """EXPLAIN (TYPE IO): the tables the query reads (IoPlanPrinter
        role), as one JSON row."""
        import json

        if not isinstance(stmt, (t.Query, t.SetOperation)):
            raise ValueError("EXPLAIN requires a query")
        optimized = optimize(Planner(self.metadata).plan(stmt),
                             self.metadata)
        tables = []

        def walk(node):
            if isinstance(node, TableScanNode):
                entry = {"catalog": node.catalog, "table": node.table,
                         "columns": list(node.column_names)}
                if entry not in tables:
                    tables.append(entry)
            for s in node.sources:
                walk(s)

        walk(optimized)
        return QueryResult(
            ["Query Input"], [T.VARCHAR],
            [(json.dumps({"inputTables": tables}),)])

    def explain_analyze_text(self, stmt: t.Node) -> str:
        """EXPLAIN ANALYZE: run the query on the runner's device, then
        render the plan and the per-operator wall/row rollup the Driver
        recorded (ExplainAnalyzeOperator.java:34 + planPrinter role).
        The table is the JAX package's; its jit compile, dispatch and
        pre-reduce columns read 0, since eager torch compiles nothing
        and the port has no pre-reduce (ROADMAP S7)."""
        import time

        from presto_tpu_torch.exec.context import hot_operator_lines

        if not isinstance(stmt, (t.Query, t.SetOperation)):
            raise ValueError("EXPLAIN ANALYZE requires a query")
        t0 = time.perf_counter()
        optimized = optimize(Planner(self.metadata).plan(stmt),
                             self.metadata)
        self._check_scans(optimized)
        phys = PhysicalPlanner(self.registry, self.device,
                               self.config).plan(optimized)
        task = execute_pipelines(phys.pipelines, self.config)
        self._last_task = task   # the completion event reports its stats
        execution_s = time.perf_counter() - t0
        lines = [format_plan(optimized).rstrip(), "", "Operator stats:"]
        header = (f"{'operator':<40} {'in rows':>10} {'out rows':>10} "
                  f"{'wall ms':>9} {'finish ms':>9} {'compile ms':>10} "
                  f"{'jit disp':>8} {'jit comp':>8} {'prereduce':>9}")
        lines += [header, "-" * len(header)]
        for s in task.operator_stats:
            lines.append(
                f"{s.operator:<40} {s.input_rows:>10} {s.output_rows:>10} "
                f"{s.wall_ns / 1e6:>9.1f} {s.finish_wall_ns / 1e6:>9.1f} "
                f"{0.0:>10.1f} {0:>8} {0:>8} {0:>9}")
        lines.extend(hot_operator_lines([
            dict(s.as_dict(), wall_ns=s.wall_ns + s.finish_wall_ns)
            for s in task.operator_stats]))
        lines.append(
            f"peak memory: {task.memory.peak / (1 << 20):.1f} MiB; "
            f"jit dispatches: 0, compiles: 0 (0.0 ms compile); "
            f"prereduce rows: 0")
        # the single-process runner executes synchronously: queued is 0
        lines.append(f"serving: queued 0.000 s, "
                     f"execution {execution_s:.3f} s")
        for d in task.driver_stats:
            lines.append(
                f"driver {d.pipeline}: {d.operators} operators, "
                f"{d.input_rows} -> {d.output_rows} rows, "
                f"{d.wall_ns / 1e6:.1f} ms")
        return "\n".join(lines)

    def _check_scans(self, node) -> None:
        if isinstance(node, TableScanNode):
            self.access_control.check_can_select(
                self.session.user, node.catalog, node.table)
        for s in node.sources:
            self._check_scans(s)

    def _execute_query(self, q: t.Node) -> QueryResult:
        cfg = self.session.effective_config(self.config)
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
