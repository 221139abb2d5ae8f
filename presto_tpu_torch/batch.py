"""Columnar batches: the Page, as torch tensors.

The reference's unit of data flow is the ``Page`` — a horizontal batch of
immutable columnar ``Block``s (presto-spi/.../Page.java:34).  Here it is
``Batch``: one ``Column`` per channel, where

- fixed-width blocks become value arrays of the type's dtype,
- null flags become an optional bool validity array (None == no nulls,
  matching ``Block.mayHaveNull``),
- strings become int32 dictionary codes + a host-side ``Dictionary``
  (strings never live on the device).

A column's arrays are numpy arrays on the host (connectors produce
those) or torch tensors on one device (``Batch.to_device``); the
operators downstream of a scan see tensors.  Batches are immutable:
every transformation returns a new ``Batch`` sharing untouched arrays.

Arrays may be padded beyond ``num_rows`` (``pad_rows``, the shape-bucket
policy ``next_bucket``); logical rows always occupy ``[0, num_rows)``.

Nested types (ARRAY/MAP/ROW) are not part of this package yet
(ROADMAP A5); a nested column raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from presto_tpu_torch import types as T

Array = Union[np.ndarray, torch.Tensor]


def next_bucket(n: int, minimum: int = 1024) -> int:
    """Smallest power-of-two >= max(n, minimum): the shape-bucket policy."""
    cap = max(int(n), int(minimum), 1)
    return 1 << (cap - 1).bit_length()


# process-unique monotonic dictionary identities (never reused, unlike id())
_DICT_TOKENS = itertools.count(1)


class Dictionary:
    """A host-side value dictionary for string-ish columns.

    Append-only interning table: code -> value and value -> code.  Shared by
    reference between columns; never mutated through a Column (codes remain
    stable), so sharing is safe.
    """

    __slots__ = ("values", "token", "_index", "_lock")

    def __init__(self, values: Sequence[str] = ()):
        self.values: List[str] = list(values)
        self.token: int = next(_DICT_TOKENS)
        self._index = {v: i for i, v in enumerate(self.values)}
        # concurrent feed drivers (LocalExchange tier) may intern into a
        # shared dictionary; appends must stay code-stable
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.values)

    def intern(self, value: str) -> int:
        code = self._index.get(value)
        if code is None:
            with self._lock:
                code = self._index.get(value)
                if code is None:
                    code = len(self.values)
                    self.values.append(value)
                    self._index[value] = code
        return code

    def sort_ranks(self) -> np.ndarray:
        """rank[code] = lexicographic rank; used to ORDER BY a dictionary
        column on the device without materializing strings."""
        order = np.argsort(np.asarray(self.values, dtype=object),
                           kind="stable")
        ranks = np.empty(len(self.values), dtype=np.int32)
        ranks[order] = np.arange(len(self.values), dtype=np.int32)
        return ranks

    def remap_into(self, target: "Dictionary") -> np.ndarray:
        """Return old-code -> target-code mapping, interning as needed."""
        return np.fromiter(
            (target.intern(v) for v in self.values), dtype=np.int32,
            count=len(self.values),
        )


def _host(a) -> np.ndarray:
    """Any column array as a numpy array (copies a tensor to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _nbytes(a: Array) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def _xp(arr):
    """numpy-or-torch dispatch for code shared by the host and device
    paths: ``numpy`` for a host array, the torch namespace of the
    tensor's device otherwise (see expr/xp.py)."""
    from presto_tpu_torch.expr.xp import NUMPY, TorchXp

    if isinstance(arr, torch.Tensor):
        return TorchXp(arr.device)
    return NUMPY


@dataclasses.dataclass(frozen=True)
class Column:
    """One channel of a Batch: values + optional validity (+ dictionary)."""

    type: T.Type
    values: Array
    valid: Optional[Array] = None  # bool array; None == all valid
    dictionary: Optional[Dictionary] = None

    def __post_init__(self):
        if self.type.is_dictionary and self.dictionary is None:
            raise ValueError(f"{self.type} column requires a dictionary")
        if self.type.is_nested:
            raise NotImplementedError(
                f"{self.type.display()} columns: ROADMAP A5 ports nested "
                "types")

    @property
    def device(self) -> Optional[torch.device]:
        """The tensor device, or None for host (numpy) arrays."""
        if isinstance(self.values, torch.Tensor):
            return self.values.device
        return None

    def take(self, indices: Array) -> "Column":
        if isinstance(self.values, torch.Tensor):
            idx = _to_tensor(indices, self.values.device).long()
            values = self.values.index_select(0, idx)
            valid = (None if self.valid is None
                     else self.valid.index_select(0, idx))
        else:
            idx = _host(indices)
            values = self.values[idx]
            valid = None if self.valid is None else self.valid[idx]
        return Column(self.type, values, valid, self.dictionary)

    def head(self, n: int) -> "Column":
        return Column(self.type, self.values[:n],
                      None if self.valid is None else self.valid[:n],
                      self.dictionary)

    def pad(self, capacity: int) -> "Column":
        """Pad to ``capacity`` rows (zero fill, invalid)."""
        n = int(self.values.shape[0])
        if n >= capacity:
            return self
        extra = capacity - n
        xp = _xp(self.values)
        values = xp.concatenate(
            [self.values,
             xp.zeros((extra,) + tuple(self.values.shape[1:]),
                      self.values.dtype)])
        valid = self.valid
        if valid is not None:
            valid = xp.concatenate([valid, xp.zeros((extra,), bool)])
        return Column(self.type, values, valid, self.dictionary)

    def to_numpy(self) -> "Column":
        valid = None if self.valid is None else _host(self.valid)
        return Column(self.type, _host(self.values), valid, self.dictionary)

    def to_device(self, device) -> "Column":
        valid = None if self.valid is None else _to_tensor(self.valid,
                                                           device)
        return Column(self.type, _to_tensor(self.values, device), valid,
                      self.dictionary)

    def to_pylist(self, num_rows: int) -> List[Any]:
        vals = _host(self.values)[:num_rows]
        valid = None if self.valid is None else _host(self.valid)[:num_rows]
        if self.type.is_dictionary:
            d = self.dictionary
            out = [d.values[int(c)] if 0 <= int(c) < len(d) else None
                   for c in vals]
        else:
            out = [self.type.to_python(v) for v in vals]
        if valid is not None:
            out = [v if ok else None for v, ok in zip(out, valid)]
        return out


@dataclasses.dataclass(frozen=True)
class Batch:
    """A horizontal slice of columnar data (the Page equivalent)."""

    columns: Tuple[Column, ...]
    num_rows: int

    def __post_init__(self):
        for c in self.columns:
            if c.values.shape[0] < self.num_rows:
                raise ValueError(
                    f"column has {c.values.shape[0]} rows < "
                    f"num_rows={self.num_rows}")

    # -- structural ------------------------------------------------------
    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def capacity(self) -> int:
        return (int(self.columns[0].values.shape[0]) if self.columns
                else self.num_rows)

    @property
    def device(self) -> Optional[torch.device]:
        """Device of the batch's tensors (None for a host batch)."""
        for c in self.columns:
            if c.device is not None:
                return c.device
        return None

    # -- data movement ---------------------------------------------------
    def take(self, indices: Array) -> "Batch":
        """Page.getPositions analogue: gather rows."""
        n = int(indices.shape[0])
        return Batch(tuple(c.take(indices) for c in self.columns), n)

    def head(self, n: int) -> "Batch":
        n = min(n, self.num_rows)
        return Batch(tuple(c.head(n) for c in self.columns), n)

    def pad_rows(self, capacity: int) -> "Batch":
        """Pad every column to ``capacity`` rows (zero fill, invalid)."""
        if self.capacity >= capacity:
            return self
        return Batch(tuple(c.pad(capacity) for c in self.columns),
                     self.num_rows)

    def compact(self) -> "Batch":
        """Drop padding."""
        if self.capacity == self.num_rows:
            return self
        return self.head(self.num_rows)

    def to_numpy(self) -> "Batch":
        return Batch(tuple(c.to_numpy() for c in self.columns), self.num_rows)

    def to_device(self, device) -> "Batch":
        """Every column as tensors on ``device`` (``.to(device)``)."""
        device = torch.device(device)
        return Batch(tuple(c.to_device(device) for c in self.columns),
                     self.num_rows)

    # -- interop ---------------------------------------------------------
    def to_pylist(self) -> List[Tuple[Any, ...]]:
        cols = [c.to_pylist(self.num_rows) for c in self.columns]
        return list(zip(*cols)) if cols else [() for _ in range(self.num_rows)]

    @property
    def size_bytes(self) -> int:
        total = 0
        for c in self.columns:
            total += _nbytes(c.values)
            if c.valid is not None:
                total += _nbytes(c.valid)
        return total

    def __repr__(self) -> str:  # pragma: no cover
        ts = ", ".join(c.type.display() for c in self.columns)
        return f"Batch[{self.num_rows} rows; {ts}]"


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def batch_from_arrays(columns, device) -> Batch:
    """A Batch on ``device`` from plain host arrays.

    ``columns`` holds one ``(type, values, valid, dictionary_values)``
    per column: ``type`` is a ``types.Type`` or its SQL text
    (``"double"``, ``"decimal(12,2)"``), ``values`` and ``valid`` numpy
    arrays (``valid`` None for no nulls), ``dictionary_values`` the
    strings of a dictionary column's codes (else None).  This is how
    state made elsewhere (another engine's batches, a test's fixtures)
    enters the engine.
    """
    cols = []
    n = None
    for typ, values, valid, dict_values in columns:
        if isinstance(typ, str):
            typ = T.parse_type(typ)
        values = np.asarray(values)
        if values.dtype != typ.np_dtype:
            values = values.astype(typ.np_dtype)
        valid = None if valid is None else np.asarray(valid, dtype=bool)
        dictionary = (Dictionary(list(dict_values))
                      if dict_values is not None else None)
        cols.append(Column(typ, values, valid, dictionary))
        n = values.shape[0] if n is None else min(n, values.shape[0])
    return Batch(tuple(cols), n or 0).to_device(device)


def column_from_pylist(typ: T.Type, values: Sequence[Any]) -> Column:
    """A host Column from Python values (None == NULL): the BlockBuilder
    role for the flat types (nested ones are ROADMAP A5)."""
    n = len(values)
    valid = None
    if any(v is None for v in values):
        valid = np.fromiter((v is not None for v in values), dtype=bool,
                            count=n)
    if typ.is_dictionary:
        dictionary = Dictionary()
        codes = np.fromiter(
            (dictionary.intern(v) if v is not None else 0 for v in values),
            dtype=np.int32, count=n)
        return Column(typ, codes, valid, dictionary)
    storage = np.zeros(n, dtype=typ.np_dtype)
    for i, v in enumerate(values):
        if v is not None:
            storage[i] = typ.from_python(v)
    return Column(typ, storage, valid)


def batch_from_pylist(schema: Sequence[T.Type],
                      rows: Sequence[Sequence[Any]], device) -> Batch:
    """A Batch on ``device`` from rows of Python values (a VALUES list;
    the RowPagesBuilder role)."""
    cols = tuple(column_from_pylist(typ, [r[i] for r in rows])
                 for i, typ in enumerate(schema))
    return Batch(cols, len(rows)).to_device(device)


def null_column(typ: T.Type, n: int, device) -> Column:
    """``n`` NULLs of ``typ`` as tensors on ``device``."""
    from presto_tpu_torch.expr.xp import torch_dtype

    values = torch.zeros(n, dtype=torch_dtype(typ.np_dtype), device=device)
    dictionary = Dictionary() if typ.is_dictionary else None
    return Column(typ, values, torch.zeros(n, dtype=torch.bool,
                                           device=device), dictionary)


def _concat_columns(cols: Sequence[Column],
                    row_counts: Sequence[int]) -> Column:
    """Concatenate row-count-exact host columns of one channel."""
    typ = cols[0].type
    if any(c.valid is not None for c in cols):
        valid = np.concatenate([
            _host(c.valid)[:n] if c.valid is not None
            else np.ones(n, bool)
            for c, n in zip(cols, row_counts)])
    else:
        valid = None
    if typ.is_dictionary:
        target = Dictionary()
        parts = []
        for c, n in zip(cols, row_counts):
            remap = c.dictionary.remap_into(target)
            codes = _host(c.values)[:n]
            parts.append(remap[codes] if len(remap) else codes)
        values = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return Column(typ, values, valid, target)
    values = np.concatenate(
        [_host(c.values)[:n] for c, n in zip(cols, row_counts)])
    return Column(typ, values, valid)


def concat_batches(batches: Sequence[Batch]) -> Batch:
    """Concatenate compacted batches on the host (dictionary columns are
    re-coded into a shared dictionary — the DictionaryBlock 'compact'
    analogue)."""
    batches = [b.compact().to_numpy() for b in batches if b.num_rows > 0]
    if not batches:
        raise ValueError("concat of zero rows needs a schema")
    first = batches[0]
    counts = [b.num_rows for b in batches]
    out_cols = [
        _concat_columns([b.columns[ci] for b in batches], counts)
        for ci in range(first.num_columns)]
    return Batch(tuple(out_cols), sum(counts))


def empty_column(typ: T.Type) -> Column:
    if typ.is_nested:
        raise NotImplementedError(
            f"{typ.display()} columns: ROADMAP A5 ports nested types")
    dictionary = Dictionary() if typ.is_dictionary else None
    return Column(typ, np.zeros(0, typ.np_dtype), None, dictionary)

