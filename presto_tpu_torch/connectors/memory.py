"""In-memory writable connector (the presto-memory analogue), and the
blackhole sink.

The reference's memory connector stores inserted pages per table and
serves them back for scans (presto-memory; used across the test suite as
the writable fixture).  Here a table holds compact Batches whose tensors
lie on the connector's device, the runner's: a batch that arrives
elsewhere (a VALUES row, a global aggregate's row, a batch staged on the
CPU) is moved there once, at write time, so a scan hands the stored
tensors on without a copy.  CREATE TABLE / INSERT / CTAS land through the
PageSink API; scans serve the stored batches split by batch index.

Every stored varchar column shares one Dictionary per (table, column):
codes are re-mapped into it on the device with a small map from
``Dictionary.remap_into``, and never read back to the host.

The blackhole connector's distributed write protocol (begin_write,
task_sink, finish_write, abort_write) comes with the distributed tier,
ROADMAP A13.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch

from presto_tpu_torch.batch import Batch, Column, Dictionary, empty_column
from presto_tpu_torch.connectors.api import (
    Connector, PageSink, PageSource, Split, TableHandle, TableSchema,
    TableStatistics,
)


class _MemPageSource(PageSource):
    def __init__(self, batches: List[Batch], columns: Sequence[str],
                 schema: TableSchema):
        self.batches = batches
        self.channels = [schema.column_index(c) for c in columns]

    def __iter__(self):
        for b in self.batches:
            yield Batch(tuple(b.columns[c] for c in self.channels),
                        b.num_rows)


def _stored(batch: Batch, device: torch.device) -> Batch:
    """``batch`` as the table keeps it: compact, on ``device``, holding no
    storage beyond its rows (a padded batch's head is a view of the
    padded tensors, so it is copied)."""
    padded = batch.capacity > batch.num_rows
    batch = batch.compact().to_device(device)
    if not padded:
        return batch
    return Batch(tuple(_cloned(c) for c in batch.columns), batch.num_rows)


def _cloned(c: Column) -> Column:
    return Column(c.type, c.values.clone(),
                  None if c.valid is None else c.valid.clone(),
                  c.dictionary, tuple(_cloned(k) for k in c.children))


class _MemPageSink(PageSink):
    def __init__(self, table: "_MemTable"):
        self.table = table
        self.pending: List[Batch] = []

    def append(self, batch: Batch) -> None:
        self.pending.append(_stored(batch, self.table.device))

    def finish(self) -> int:
        rows = sum(b.num_rows for b in self.pending)
        self.table.append_all(self.pending)
        self.pending = []
        return rows


class _MemTable:
    def __init__(self, schema: TableSchema, device: torch.device):
        self.schema = schema
        self.device = device
        self.batches: List[Batch] = []
        self.stats: Optional[TableStatistics] = None  # set by ANALYZE
        # per-column shared interning tables: every stored batch's
        # dictionary columns re-code into these at insert, so scans
        # serve ONE dictionary per column
        self._dicts: List[Optional[Dictionary]] = [None] * len(
            schema.columns)
        # per column, the last source dictionary's code map on the device
        # (token, map): a scan's splits share one dictionary, so a CTAS
        # builds each column's map once, not once per batch
        self._maps: List = [None] * len(schema.columns)
        self._lock = threading.Lock()

    def _code_map(self, ci: int, source: Dictionary,
                  target: Dictionary) -> torch.Tensor:
        hit = self._maps[ci]
        # dictionaries only grow, so a map of the same source stays right
        # for the codes it covers
        if hit is None or hit[0] != source.token or \
                hit[1].shape[0] < len(source):
            hit = (source.token, torch.from_numpy(
                source.remap_into(target)).to(self.device))
            self._maps[ci] = hit
        return hit[1]

    def _intern_shared(self, batch: Batch) -> Batch:
        cols = []
        changed = False
        for ci, c in enumerate(batch.columns):
            if c.dictionary is None:
                cols.append(c)
                continue
            target = self._dicts[ci]
            if target is None:
                target = self._dicts[ci] = Dictionary()
            if c.dictionary is target:
                cols.append(c)
                continue
            remap = self._code_map(ci, c.dictionary, target)
            codes = c.values
            if remap.shape[0]:
                # a NULL row's code may lie outside its dictionary: gather
                # code 0 there (the row stays NULL)
                idx = (codes if c.valid is None
                       else torch.where(c.valid, codes, 0)).long()
                codes = remap.index_select(0, idx)
            cols.append(Column(c.type, codes, c.valid, target))
            changed = True
        return Batch(tuple(cols), batch.num_rows) if changed else batch

    def append_all(self, batches: List[Batch]) -> None:
        with self._lock:
            self.batches.extend(self._intern_shared(b) for b in batches)

    @property
    def row_count(self) -> int:
        with self._lock:
            return sum(b.num_rows for b in self.batches)


class MemoryConnector(Connector):
    """Tables on one device: ``device`` is the runner's."""

    name = "memory"

    def __init__(self, device):
        self.device = torch.device(device)
        self.tables: Dict[str, _MemTable] = {}
        self._lock = threading.Lock()

    # -- metadata -------------------------------------------------------
    def list_tables(self) -> List[str]:
        with self._lock:
            return sorted(self.tables)

    def get_table(self, table: str) -> Optional[TableHandle]:
        with self._lock:
            if table not in self.tables:
                raise KeyError(f"memory table not found: {table}")
        return TableHandle("memory", table)

    def table_schema(self, handle: TableHandle) -> TableSchema:
        return self.tables[handle.table].schema

    def table_statistics(self, handle: TableHandle
                         ) -> Optional[TableStatistics]:
        tbl = self.tables[handle.table]
        if tbl.stats is not None:
            return tbl.stats
        return TableStatistics(row_count=tbl.row_count)

    # -- reads ----------------------------------------------------------
    def get_splits(self, handle: TableHandle,
                   desired_splits: int) -> List[Split]:
        tbl = self.tables[handle.table]
        n = max(1, len(tbl.batches))
        per = -(-n // max(1, desired_splits))
        return [Split(handle, (lo, min(lo + per, n)))
                for lo in range(0, n, per)] or [Split(handle, (0, 0))]

    def page_source(self, split: Split, columns: Sequence[str],
                    batch_rows: int = 65536) -> PageSource:
        tbl = self.tables[split.handle.table]
        lo, hi = split.info
        return _MemPageSource(tbl.batches[lo:hi], columns, tbl.schema)

    # -- writes ---------------------------------------------------------
    def create_table(self, name: str, schema: TableSchema,
                     properties=None) -> TableHandle:
        with self._lock:
            if name in self.tables:
                raise ValueError(f"table already exists: {name}")
            self.tables[name] = _MemTable(schema, self.device)
        return TableHandle("memory", name)

    def drop_table(self, name: str) -> None:
        with self._lock:
            if name not in self.tables:
                raise KeyError(f"memory table not found: {name}")
            del self.tables[name]

    def page_sink(self, handle: TableHandle) -> PageSink:
        return _MemPageSink(self.tables[handle.table])

    def rename_table(self, name: str, new_name: str) -> None:
        with self._lock:
            if name not in self.tables:
                raise KeyError(f"memory table not found: {name}")
            if new_name in self.tables:
                raise ValueError(f"table already exists: {new_name}")
            self.tables[new_name] = self.tables.pop(name)

    def delete_rows(self, handle: TableHandle, mask_fn) -> int:
        """Filter every stored batch through ``mask_fn`` (a bool tensor on
        the batch's device, True = delete), keeping the survivors with a
        device gather; rewrites in place under the table lock.  One host
        read a stored batch: the survivors' positions."""
        tbl = self.tables[handle.table]
        deleted = 0
        with tbl._lock:
            kept: List[Batch] = []
            for b in tbl.batches:
                mask = mask_fn(b)[:b.num_rows]
                keep_idx = torch.nonzero(~mask).squeeze(1)
                n_del = b.num_rows - keep_idx.shape[0]
                if n_del == 0:
                    kept.append(b)
                    continue
                deleted += n_del
                if n_del == b.num_rows:
                    continue
                kept.append(b.take(keep_idx))
            tbl.batches = kept
            tbl.stats = None
        return deleted

    def collect_statistics(self, handle: TableHandle) -> None:
        """ANALYZE: full-scan column stats (row count, NDV, null fraction,
        min/max, data size) stored on the table."""
        from presto_tpu_torch.connectors.api import compute_statistics

        tbl = self.tables[handle.table]
        with tbl._lock:
            tbl.stats = compute_statistics(tbl.schema, tbl.batches)


class BlackHoleConnector(Connector):
    """Write sink that discards everything (presto-blackhole role: write
    benchmarking and DML plumbing tests).  Scans return zero rows."""

    name = "blackhole"

    def __init__(self):
        self.schemas: Dict[str, TableSchema] = {}
        self.rows_swallowed: Dict[str, int] = {}

    def list_tables(self) -> List[str]:
        return sorted(self.schemas)

    def get_table(self, table: str) -> Optional[TableHandle]:
        if table not in self.schemas:
            raise KeyError(f"blackhole table not found: {table}")
        return TableHandle("blackhole", table)

    def table_schema(self, handle: TableHandle) -> TableSchema:
        return self.schemas[handle.table]

    def get_splits(self, handle: TableHandle,
                   desired_splits: int) -> List[Split]:
        return [Split(handle, None)]

    def page_source(self, split: Split, columns: Sequence[str],
                    batch_rows: int = 65536) -> PageSource:
        schema = self.schemas[split.handle.table]
        empty = Batch(tuple(empty_column(schema.column_type(c))
                            for c in columns), 0)

        class _Empty(PageSource):
            def __iter__(self):
                yield empty

        return _Empty()

    def create_table(self, name: str, schema: TableSchema,
                     properties=None) -> TableHandle:
        self.schemas[name] = schema
        self.rows_swallowed[name] = 0
        return TableHandle("blackhole", name)

    def drop_table(self, name: str) -> None:
        del self.schemas[name]

    def page_sink(self, handle: TableHandle) -> PageSink:
        connector = self
        table = handle.table

        class _Sink(PageSink):
            def __init__(self):
                self.count = 0

            def append(self, batch: Batch) -> None:
                self.count += batch.num_rows

            def finish(self) -> int:
                connector.rows_swallowed[table] += self.count
                return self.count

        return _Sink()
