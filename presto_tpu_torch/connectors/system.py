"""System + information_schema connectors.

The reference exposes engine state as SQL tables: ``system.runtime.nodes/
queries/tasks`` (presto-main/.../connector/system/ —
GlobalSystemConnector.java) and the ANSI ``information_schema`` views
(presto-main/.../connector/informationschema/).  Same here: each table is
a schema and a callable that gives its rows from live engine state (the
runner's node, the registry's catalogs); a scan builds them into one
batch on the connector's device (the runner's).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import batch_from_pylist
from presto_tpu_torch.connectors.api import (
    ColumnMetadata, Connector, PageSource, Split, TableHandle, TableSchema,
)


class _RowsPageSource(PageSource):
    def __init__(self, types, rows, channels, device):
        self.types = [types[c] for c in channels]
        self.rows = [tuple(r[c] for c in channels) for r in rows]
        self.device = device

    def __iter__(self):
        yield batch_from_pylist(self.types, self.rows, self.device)


class _VirtualConnector(Connector):
    """Tables defined as (schema, row-producing callable)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._tables: Dict[str, Tuple[TableSchema,
                                      Callable[[], List[tuple]]]] = {}

    def add_table(self, name: str, columns: List[Tuple[str, T.Type]],
                  rows_fn: Callable[[], List[tuple]]) -> None:
        schema = TableSchema(name, tuple(
            ColumnMetadata(n, typ) for n, typ in columns))
        self._tables[name] = (schema, rows_fn)

    def list_tables(self) -> List[str]:
        return sorted(self._tables)

    def get_table(self, table: str) -> Optional[TableHandle]:
        if table not in self._tables:
            raise KeyError(f"{self.name} table not found: {table}")
        return TableHandle(self.name, table)

    def table_schema(self, handle: TableHandle) -> TableSchema:
        return self._tables[handle.table][0]

    def get_splits(self, handle: TableHandle,
                   desired_splits: int) -> List[Split]:
        return [Split(handle, None)]

    def page_source(self, split: Split, columns: Sequence[str],
                    batch_rows: int = 65536) -> PageSource:
        schema, rows_fn = self._tables[split.handle.table]
        channels = [schema.column_index(c) for c in columns]
        types = [c.type for c in schema.columns]
        return _RowsPageSource(types, rows_fn(), channels, self.device)


class SystemConnector(_VirtualConnector):
    """system.runtime.* (`runtime_` prefix flattens the schema level —
    this engine's tables are single-level per catalog)."""

    name = "system"

    def __init__(self, device, nodes_fn: Callable[[], List[tuple]]):
        super().__init__(device)
        self.add_table("nodes", [
            ("node_id", T.VARCHAR), ("http_uri", T.VARCHAR),
            ("node_version", T.VARCHAR), ("coordinator", T.BOOLEAN),
            ("state", T.VARCHAR)], nodes_fn)
        # queries/tasks carry the JAX package's columns, so a query over
        # them plans alike; they hold no rows until the serving tier that
        # fills them comes (ROADMAP A13)
        self.add_table("queries", [
            ("query_id", T.VARCHAR), ("state", T.VARCHAR),
            ("user", T.VARCHAR), ("query", T.VARCHAR),
            ("output_rows", T.BIGINT), ("wall_s", T.DOUBLE),
            ("peak_memory_bytes", T.BIGINT),
            ("stage_retry_rounds", T.BIGINT),
            ("recovery_rounds", T.BIGINT),
            ("trace_token", T.VARCHAR),
            ("spooled_pages", T.BIGINT),
            ("producer_reruns", T.BIGINT),
            ("queued_s", T.DOUBLE),
            ("resource_group", T.VARCHAR),
            ("plan_cached", T.BOOLEAN),
            ("completed_splits", T.BIGINT),
            ("total_splits", T.BIGINT),
            ("progress_percent", T.DOUBLE),
            ("result_cached", T.BOOLEAN),
            ("result_cache_bytes", T.BIGINT),
            ("error_name", T.VARCHAR)], lambda: [])
        self.add_table("tasks", [
            ("task_id", T.VARCHAR), ("state", T.VARCHAR),
            ("query_id", T.VARCHAR), ("output_rows", T.BIGINT),
            ("wall_ms", T.DOUBLE),
            ("peak_memory_bytes", T.BIGINT),
            ("elapsed_s", T.DOUBLE)], lambda: [])


class InformationSchemaConnector(_VirtualConnector):
    """information_schema.tables / columns over the live registry."""

    name = "information_schema"

    def __init__(self, registry, device):
        super().__init__(device)

        def tables_rows() -> List[tuple]:
            out = []
            for catalog in registry.catalogs():
                conn = registry.get(catalog)
                try:
                    names = conn.list_tables()
                except NotImplementedError:
                    continue
                for t_name in names:
                    out.append((catalog, "default", t_name, "BASE TABLE"))
            return out

        def columns_rows() -> List[tuple]:
            out = []
            for catalog in registry.catalogs():
                conn = registry.get(catalog)
                try:
                    names = conn.list_tables()
                except NotImplementedError:
                    continue
                for t_name in names:
                    schema = conn.table_schema(conn.get_table(t_name))
                    for pos, col in enumerate(schema.columns, 1):
                        out.append((catalog, "default", t_name, col.name,
                                    pos, col.type.display()))
            return out

        self.add_table("tables", [
            ("table_catalog", T.VARCHAR), ("table_schema", T.VARCHAR),
            ("table_name", T.VARCHAR), ("table_type", T.VARCHAR)],
            tables_rows)
        self.add_table("columns", [
            ("table_catalog", T.VARCHAR), ("table_schema", T.VARCHAR),
            ("table_name", T.VARCHAR), ("column_name", T.VARCHAR),
            ("ordinal_position", T.BIGINT), ("data_type", T.VARCHAR)],
            columns_rows)
