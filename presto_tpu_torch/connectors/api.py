"""Connector SPI.

The reference externalizes all storage behind a connector SPI
(presto-spi/.../connector/, 60 files: Connector, ConnectorMetadata,
ConnectorSplitManager, ConnectorPageSourceProvider, ConnectorPageSinkProvider,
loaded by PluginManager into ConnectorManager —
presto-main/.../connector/ConnectorManager.java:83).

This is the same contract collapsed to its essentials, columnar-first:

- ``Connector`` exposes metadata (schemas/tables/columns + optional stats),
- ``get_splits`` partitions a table scan into independently-generatable
  ``Split``s (the unit of scheduling, P5 in SURVEY §2.13),
- ``page_source(split, columns)`` yields host-side ``Batch``es for the
  requested channels only (column pruning is the connector's job, the
  ``ConnectorPageSource`` + lazy-block analogue); the runtime stages them
  into HBM asynchronously.

Write support (``ConnectorPageSink``) is the ``begin_insert``/``PageSink``
pair, used by the memory and blackhole connectors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch


@dataclasses.dataclass(frozen=True)
class ColumnMetadata:
    name: str
    type: T.Type


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[ColumnMetadata, ...]

    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)

    def column_type(self, name: str) -> T.Type:
        return self.columns[self.column_index(name)].type


@dataclasses.dataclass(frozen=True)
class TableHandle:
    """Connector-scoped table reference (ConnectorTableHandle analogue)."""

    catalog: str
    table: str
    extra: Any = None  # connector-private (e.g. tpch scale factor)


@dataclasses.dataclass(frozen=True)
class Split:
    """An independently scannable shard of a table
    (presto-spi ConnectorSplit analogue)."""

    handle: TableHandle
    info: Any  # connector-private split descriptor (e.g. a row range)
    # Estimated rows, for scheduler balancing; -1 when unknown.
    estimated_rows: int = -1


@dataclasses.dataclass
class TableStatistics:
    """Coarse table stats for the cost-based optimizer
    (presto-spi/.../statistics/TableStatistics.java role)."""

    row_count: float
    # per-column distinct-count estimates, keyed by column name
    ndv: Dict[str, float] = dataclasses.field(default_factory=dict)
    # optional richer column stats (SHOW STATS / ANALYZE output;
    # presto-spi ColumnStatistics role) — absent keys mean unknown
    nulls_fraction: Dict[str, float] = dataclasses.field(default_factory=dict)
    low: Dict[str, Any] = dataclasses.field(default_factory=dict)
    high: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data_size: Dict[str, float] = dataclasses.field(default_factory=dict)


class DictionaryPool:
    """Per-table shared interning tables: one append-only ``Dictionary``
    per (table, column), handed to every split's page source.

    Kernel caches key compiled programs by dictionary binding
    (token, length): a connector that interns each split's strings into
    a FRESH dictionary forces one re-trace per split for every
    expression over that column.  Splits sharing one interning table
    instead compile once per (table, expression) — the per-split
    compile-amplification fix ROADMAP #12 names.  Thread-safe: feed
    drivers decode splits concurrently, and ``Dictionary.intern`` is
    itself code-stable under concurrency.
    """

    def __init__(self):
        import threading

        from presto_tpu_torch.batch import Dictionary as _D

        self._dict_cls = _D
        self._lock = threading.Lock()
        self._dicts: Dict[Tuple[str, str], Any] = {}

    def get(self, table: str, column: str, values=None):
        """The shared dictionary for (table, column), created on first
        use (pre-seeded with ``values`` when given)."""
        key = (table, column)
        with self._lock:
            d = self._dicts.get(key)
            if d is None:
                d = self._dict_cls(values or ())
                self._dicts[key] = d
            return d

    def drop(self, table: str) -> None:
        """Forget a table's dictionaries (DROP/RENAME invalidation)."""
        with self._lock:
            for key in [k for k in self._dicts if k[0] == table]:
                del self._dicts[key]


class PageSource:
    """Iterator of Batches for one split
    (ConnectorPageSource.getNextPage analogue)."""

    def __iter__(self) -> Iterator[Batch]:
        raise NotImplementedError


class PageSink:
    """Write target for INSERT/CTAS (ConnectorPageSink analogue)."""

    def append(self, batch: Batch) -> None:
        raise NotImplementedError

    def finish(self) -> int:
        """Commit; returns row count written."""
        raise NotImplementedError

    def fragment(self) -> Optional[str]:
        """Opaque per-task commit token, valid after finish() (the
        ConnectorPageSink.finish() Slice fragments role): a distributed
        write's TableFinish step passes every task's fragment to
        Connector.finish_write for the atomic commit.  None for sinks
        whose finish() IS the commit (single-process path)."""
        return None


class Connector:
    """One mounted catalog (Connector + ConnectorMetadata +
    ConnectorSplitManager + ConnectorPageSourceProvider in one object)."""

    name: str = "connector"

    # -- metadata -------------------------------------------------------
    def list_tables(self) -> List[str]:
        raise NotImplementedError

    def get_table(self, table: str) -> Optional[TableHandle]:
        raise NotImplementedError

    def table_schema(self, handle: TableHandle) -> TableSchema:
        raise NotImplementedError

    def table_statistics(self, handle: TableHandle) -> Optional[TableStatistics]:
        return None

    # -- reads ----------------------------------------------------------
    def get_splits(self, handle: TableHandle, desired_splits: int) -> List[Split]:
        raise NotImplementedError

    def prune_splits(self, handle: TableHandle, splits: List[Split],
                     constraints: List[Tuple[str, str, Any]]) -> List[Split]:
        """Filter-pushdown negotiation (ConnectorMetadata.applyFilter +
        HivePartitionManager pruning role): ``constraints`` is a
        TupleDomain-lite list of (column, op, literal) conjuncts with op
        in {eq, ne, lt, le, gt, ge, in}; connectors may drop splits that
        cannot match (e.g. whole partitions).  The engine still applies
        the full filter to surviving rows, so pruning is best-effort."""
        return splits

    def page_source(self, split: Split, columns: Sequence[str],
                    batch_rows: int = 65536) -> PageSource:
        raise NotImplementedError

    def sort_order(self, handle: TableHandle) -> List[str]:
        """Columns the table's rows are clustered/sorted by, in order
        (the LocalProperties/StreamPropertyDerivations source): scans
        emit rows grouped by any prefix of this list, enabling
        streaming aggregation.  Empty = no declared order."""
        return []

    def bucket_splits(self, handle: TableHandle, column: str,
                      n_buckets: int
                      ) -> Optional[Tuple[Tuple[int, int],
                                          List[List[Split]]]]:
        """Co-bucketed split groups for grouped execution (P9): when the
        table can be range-bucketed on ``column``, return ((domain_lo,
        domain_hi), [splits of bucket 0, ...]).  Two scans co-partition
        iff their domains match — the ConnectorNodePartitioningProvider
        role (presto-spi/.../connector/ConnectorNodePartitioningProvider
        .java) driving Lifespan.java:26 bucket-by-bucket execution.
        None = not bucketable on that column."""
        return None

    # -- writes (optional) ----------------------------------------------
    def create_table(self, name: str, schema: TableSchema,
                     properties: Optional[Dict[str, Any]] = None
                     ) -> TableHandle:
        raise NotImplementedError(f"{self.name}: CREATE TABLE not supported")

    def page_sink(self, handle: TableHandle) -> PageSink:
        raise NotImplementedError(f"{self.name}: INSERT not supported")

    # -- distributed writes (P6, optional) ------------------------------
    # The two-phase write protocol behind scaled writers
    # (SCALED_WRITER_DISTRIBUTION, SystemPartitioningHandle.java:62 +
    # TableWriterOperator.java:58 / TableFinishOperator.java:46): worker
    # tasks stream rows into task_sink()s whose finish() stages data
    # WITHOUT publishing and whose fragment() returns a commit token;
    # the single TableFinish task then calls finish_write(tokens) for the
    # all-or-nothing publish.
    supports_distributed_write: bool = False

    def begin_write(self, handle: TableHandle) -> str:
        """Start a distributed write; returns an opaque write id."""
        raise NotImplementedError(
            f"{self.name}: distributed write not supported")

    def task_sink(self, handle: TableHandle, write_id: str,
                  task_id: str) -> PageSink:
        """Per-task staging sink.  finish() stages (returns rows);
        fragment() returns the commit token."""
        raise NotImplementedError(
            f"{self.name}: distributed write not supported")

    def finish_write(self, handle: TableHandle, write_id: str,
                     fragments: Sequence[str]) -> None:
        """Atomically publish every staged fragment."""
        raise NotImplementedError(
            f"{self.name}: distributed write not supported")

    def abort_write(self, handle: TableHandle, write_id: str) -> None:
        """Discard staged state for an abandoned write (best-effort)."""

    def drop_table(self, name: str) -> None:
        raise NotImplementedError(f"{self.name}: DROP TABLE not supported")

    def rename_table(self, name: str, new_name: str) -> None:
        raise NotImplementedError(f"{self.name}: RENAME not supported")

    def delete_rows(self, handle: TableHandle, mask_fn) -> int:
        """DELETE support (ConnectorMetadata.beginDelete/DeleteOperator
        role): ``mask_fn(batch) -> bool ndarray`` marks rows to delete;
        returns the number of rows removed."""
        raise NotImplementedError(f"{self.name}: DELETE not supported")

    def collect_statistics(self, handle: TableHandle) -> None:
        """ANALYZE support: recompute and store table statistics so
        ``table_statistics`` reflects current data."""
        raise NotImplementedError(f"{self.name}: ANALYZE not supported")


class ConnectorRegistry:
    """Mounted catalogs (ConnectorManager/catalog properties analogue).

    Also holds logical views, keyed (catalog, name) -> defining SQL —
    the ConnectorMetadata.createView/getView storage role, kept engine-
    side since views are pure SQL-on-SQL."""

    def __init__(self):
        self._catalogs: Dict[str, Connector] = {}
        self.views: Dict[tuple, str] = {}

    def register(self, catalog: str, connector: Connector) -> None:
        self._catalogs[catalog] = connector

    def get(self, catalog: str) -> Connector:
        if catalog not in self._catalogs:
            raise KeyError(f"catalog not registered: {catalog}")
        return self._catalogs[catalog]

    def catalogs(self) -> List[str]:
        return sorted(self._catalogs)


def coerce_value(typ: T.Type, v: Any, lenient: bool = False) -> Any:
    """External value (text or driver-native) -> engine python-domain
    value for ``typ``.  Shared by the file/jdbc/decoder connectors so
    conversion semantics stay uniform.  ``lenient`` maps undecodable
    cells to NULL (record-decoder behavior) instead of raising."""
    import datetime

    if v is None:
        return None
    try:
        if isinstance(typ, T.BooleanType):
            if isinstance(v, str):
                s = v.lower()
                return (s in ("true", "1", "t", "yes")
                        if lenient else s == "true")
            return bool(v)
        if isinstance(typ, T.DateType):
            return (datetime.date.fromisoformat(v)
                    if isinstance(v, str) else v)
        if isinstance(typ, T.TimestampType):
            return (datetime.datetime.fromisoformat(v)
                    if isinstance(v, str) else v)
        if isinstance(typ, (T.VarcharType, T.CharType, T.VarbinaryType)):
            return v if isinstance(v, (str, bytes)) else str(v)
        if isinstance(typ, T.DecimalType) or typ.np_dtype.kind == "f":
            return float(v)
        return int(v)
    except (ValueError, TypeError):
        if lenient:
            return None
        raise


def compute_statistics(schema: TableSchema, batches) -> TableStatistics:
    """Full-scan column statistics from host batches (ANALYZE support
    shared by storage connectors; presto-spi ColumnStatistics role)."""
    import numpy as np

    nrows = sum(b.num_rows for b in batches)
    stats = TableStatistics(row_count=float(nrows))
    for ci, cn in enumerate(schema.column_names()):
        vals = []
        nulls = 0
        for b in batches:
            col = b.columns[ci]
            n = b.num_rows
            v = np.asarray(col.values)[:n]
            if col.valid is not None:
                ok = np.asarray(col.valid)[:n].astype(bool)
                nulls += int(n - ok.sum())
                v = v[ok]
            if col.dictionary is not None:
                v = np.asarray(
                    [col.dictionary.values[int(c)] for c in v], object)
            vals.append(v)
        allv = (np.concatenate(vals) if vals
                else np.asarray([], np.int64))
        if nrows:
            stats.nulls_fraction[cn] = nulls / nrows
        if allv.size:
            stats.ndv[cn] = float(len(set(allv.tolist())))
            try:
                lo, hi = allv.min(), allv.max()
                stats.low[cn] = lo.item() if hasattr(lo, "item") else lo
                stats.high[cn] = hi.item() if hasattr(hi, "item") else hi
            except (TypeError, ValueError):
                pass
            stats.data_size[cn] = float(
                sum(len(str(x)) for x in allv)
                if allv.dtype == object else allv.nbytes)
    return stats
