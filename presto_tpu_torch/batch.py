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

Nested columns (ARRAY/MAP/ROW, the reference's ArrayBlock/MapBlock/
RowBlock) carry flattened ``children`` on the same device as their
``values``: an ARRAY's ``values`` are int32 element counts (lengths; the
offsets are their cumsum) and ``children=(elements,)``; a MAP's the same
with ``children=(keys, values)``; a ROW's ``values`` are an int8
placeholder and its children are row-aligned field columns.  An ARRAY's
or MAP's children hold exactly ``sum(lengths)`` rows (padding rows have
length 0), so their size is known without reading the device.
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

    def code_of(self, value: str) -> Optional[int]:
        return self._index.get(value)

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


_UNSET = object()  # sentinel: "keep existing validity" in with_values


def _cat(parts):
    """Concatenate numpy arrays or tensors of one device."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts))
    return np.concatenate(parts)


def range_gather_indices(starts, lengths, total: Optional[int] = None):
    """The positions ``[starts[i], starts[i] + lengths[i])`` of every row
    i, concatenated: the ragged take of a nested column's children.  On
    a tensor it is a device gather; ``total`` (the sum of ``lengths``)
    saves the one read of the device that counts the output."""
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.long()
        if total is None:
            total = int(lengths.sum())
        dev = lengths.device
        if total == 0:
            return torch.zeros(0, dtype=torch.int64, device=dev)
        rows = torch.repeat_interleave(
            torch.arange(lengths.shape[0], device=dev), lengths,
            output_size=total)
        begins = torch.cumsum(lengths, 0) - lengths
        ramp = torch.arange(total, device=dev) - begins[rows]
        return starts.long()[rows] + ramp
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum()) if total is None else total
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lengths)
    begins = ends - lengths
    ramp = np.arange(total, dtype=np.int64) - np.repeat(begins, lengths)
    return np.repeat(np.asarray(starts, np.int64), lengths) + ramp


@dataclasses.dataclass(frozen=True)
class Column:
    """One channel of a Batch: values + optional validity (+ dictionary,
    + flattened ``children`` for the nested types; see the module
    docstring)."""

    type: T.Type
    values: Array
    valid: Optional[Array] = None  # bool array; None == all valid
    dictionary: Optional[Dictionary] = None
    children: Tuple["Column", ...] = ()

    def __post_init__(self):
        if self.type.is_dictionary and self.dictionary is None:
            raise ValueError(f"{self.type} column requires a dictionary")
        if self.type.is_nested and not self.children:
            raise ValueError(f"{self.type} column requires children")

    @property
    def device(self) -> Optional[torch.device]:
        """The tensor device, or None for host (numpy) arrays."""
        if isinstance(self.values, torch.Tensor):
            return self.values.device
        return None

    @property
    def has_offsets(self) -> bool:
        """ARRAY/MAP: values are element counts into flattened children."""
        return isinstance(self.type, (T.ArrayType, T.MapType))

    def starts(self):
        """Each row's first child position (the offsets without the
        last)."""
        if isinstance(self.values, torch.Tensor):
            lengths = self.values.long()
            return torch.cumsum(lengths, 0) - lengths
        lengths = np.asarray(self.values, np.int64)
        return np.cumsum(lengths) - lengths

    def with_values(self, values: Array, valid=_UNSET) -> "Column":
        return Column(self.type, values,
                      self.valid if valid is _UNSET else valid,
                      self.dictionary, self.children)

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
        if self.has_offsets:
            child_idx = range_gather_indices(self.starts()[idx], values)
            kids = tuple(c.take(child_idx) for c in self.children)
            return Column(self.type, values, valid, None, kids)
        kids = tuple(c.take(idx) for c in self.children)
        return Column(self.type, values, valid, self.dictionary, kids)

    def head(self, n: int) -> "Column":
        """First n rows (an ARRAY's or MAP's children cut to match: one
        read of a device's lengths)."""
        lengths = self.values[:n]
        valid = None if self.valid is None else self.valid[:n]
        if self.has_offsets:
            total = int(lengths.sum())
            kids = tuple(c.head(total) for c in self.children)
            return Column(self.type, lengths, valid, None, kids)
        kids = tuple(c.head(n) for c in self.children)
        return Column(self.type, lengths, valid, self.dictionary, kids)

    def pad(self, capacity: int) -> "Column":
        """Pad to ``capacity`` rows (zero fill, invalid; an ARRAY's or
        MAP's padding rows are empty, its children unchanged)."""
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
        kids = self.children if self.has_offsets else tuple(
            c.pad(capacity) for c in self.children)
        return Column(self.type, values, valid, self.dictionary, kids)

    def to_numpy(self) -> "Column":
        valid = None if self.valid is None else _host(self.valid)
        return Column(self.type, _host(self.values), valid, self.dictionary,
                      tuple(c.to_numpy() for c in self.children))

    def to_device(self, device) -> "Column":
        valid = None if self.valid is None else _to_tensor(self.valid,
                                                           device)
        return Column(self.type, _to_tensor(self.values, device), valid,
                      self.dictionary,
                      tuple(c.to_device(device) for c in self.children))

    def to_pylist(self, num_rows: int) -> List[Any]:
        col = self.to_numpy()
        vals = col.values[:num_rows]
        valid = None if col.valid is None else col.valid[:num_rows]
        if self.has_offsets:
            offsets = np.concatenate([np.zeros(1, np.int64),
                                      np.cumsum(vals, dtype=np.int64)])
            kid_lists = [c.to_pylist(int(offsets[-1]))
                         for c in col.children]
            if isinstance(self.type, T.MapType):
                out = [dict(zip(kid_lists[0][lo:hi], kid_lists[1][lo:hi]))
                       for lo, hi in zip(offsets[:-1], offsets[1:])]
            else:
                out = [kid_lists[0][lo:hi]
                       for lo, hi in zip(offsets[:-1], offsets[1:])]
        elif isinstance(self.type, T.RowType):
            kid_lists = [c.to_pylist(num_rows) for c in col.children]
            out = [tuple(k[i] for k in kid_lists) for i in range(num_rows)]
        elif self.type.is_dictionary:
            d = self.dictionary
            out = [d.values[int(c)] if 0 <= int(c) < len(d) else None
                   for c in vals]
        else:
            out = [self.type.to_python(v) for v in vals]
        if valid is not None:
            out = [v if ok else None for v, ok in zip(out, valid)]
        return out

    @property
    def size_bytes(self) -> int:
        total = _nbytes(self.values)
        if self.valid is not None:
            total += _nbytes(self.valid)
        return total + sum(c.size_bytes for c in self.children)


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
        return sum(c.size_bytes for c in self.columns)

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


def column_from_pylist(typ: T.Type, values: Sequence[Any],
                       dictionary: Optional[Dictionary] = None) -> Column:
    """A host Column from Python values (None == NULL): the BlockBuilder
    role.  Nested values: ARRAY from lists/tuples, MAP from dicts, ROW
    from tuples."""
    n = len(values)
    valid = None
    if any(v is None for v in values):
        valid = np.fromiter((v is not None for v in values), dtype=bool,
                            count=n)
    if isinstance(typ, (T.ArrayType, T.MapType)):
        lengths = np.fromiter((0 if v is None else len(v) for v in values),
                              dtype=np.int32, count=n)
        if isinstance(typ, T.MapType):
            kids = (column_from_pylist(typ.key, [
                        k for v in values if v is not None for k in v]),
                    column_from_pylist(typ.value, [
                        x for v in values if v is not None
                        for x in v.values()]))
        else:
            kids = (column_from_pylist(typ.element, [
                e for v in values if v is not None for e in v]),)
        return Column(typ, lengths, valid, None, kids)
    if isinstance(typ, T.RowType):
        kids = tuple(
            column_from_pylist(ft, [None if v is None else v[fi]
                                    for v in values])
            for fi, ft in enumerate(typ.field_types))
        return Column(typ, np.zeros(n, np.int8), valid, None, kids)
    if typ.is_dictionary:
        dictionary = dictionary if dictionary is not None else Dictionary()
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
    """``n`` NULLs of ``typ`` as tensors on ``device`` (an ARRAY or MAP
    of empty rows, a ROW of NULL fields)."""
    col = empty_column(typ).to_device(device).pad(n)
    return col.with_values(col.values, torch.zeros(n, dtype=torch.bool,
                                                   device=device))


def _concat_columns(cols: Sequence[Column],
                    row_counts: Sequence[int]) -> Column:
    """Concatenate the first ``row_counts[i]`` rows of each column of one
    channel: numpy columns on the host, tensors on their one device.
    Dictionary columns are re-coded into a fresh shared dictionary (a
    child column's too); an ARRAY's or MAP's children follow their rows
    (one read of a device's lengths a part)."""
    typ = cols[0].type
    first = cols[0].values
    on_device = isinstance(first, torch.Tensor)

    def ones(k):
        return (torch.ones(k, dtype=torch.bool, device=first.device)
                if on_device else np.ones(k, bool))

    if any(c.valid is not None for c in cols):
        valid = _cat([c.valid[:k] if c.valid is not None else ones(k)
                      for c, k in zip(cols, row_counts)])
    else:
        valid = None
    values = _cat([c.values[:k] for c, k in zip(cols, row_counts)])
    if isinstance(typ, (T.ArrayType, T.MapType)):
        kid_counts = [int(c.values[:k].sum())
                      for c, k in zip(cols, row_counts)]
        kids = tuple(
            _concat_columns([c.children[ki] for c in cols], kid_counts)
            for ki in range(len(cols[0].children)))
        return Column(typ, values, valid, None, kids)
    if isinstance(typ, T.RowType):
        kids = tuple(
            _concat_columns([c.children[ki] for c in cols], row_counts)
            for ki in range(len(cols[0].children)))
        return Column(typ, values, valid, None, kids)
    if typ.is_dictionary:
        target = Dictionary()
        parts = []
        for c, k in zip(cols, row_counts):
            remap = c.dictionary.remap_into(target)
            codes = c.values[:k]
            if len(remap) and k:
                if on_device:
                    # a NULL row's code may lie outside its dictionary
                    idx = codes.long().clamp(0, len(remap) - 1)
                    codes = torch.from_numpy(remap).to(codes.device)[idx]
                else:
                    codes = remap[np.clip(codes, 0, len(remap) - 1)]
            parts.append(codes)
        return Column(typ, _cat(parts), valid, target)
    return Column(typ, values, valid)


def concat_batches(batches: Sequence[Batch]) -> Batch:
    """Concatenate batches (dictionary columns are re-coded into a shared
    dictionary — the DictionaryBlock 'compact' analogue).  Batches whose
    columns all lie on one device are concatenated there; otherwise on
    the host."""
    live = [b for b in batches if b.num_rows > 0]
    if not live:
        raise ValueError("concat of zero rows needs a schema")
    devices = {b.device for b in live}
    if len(devices) != 1 or None in devices or any(
            c.device is None for b in live for c in b.columns):
        live = [b.to_numpy() for b in live]
    counts = [b.num_rows for b in live]
    out_cols = [
        _concat_columns([b.columns[ci] for b in live], counts)
        for ci in range(live[0].num_columns)]
    return Batch(tuple(out_cols), sum(counts))


def empty_column(typ: T.Type) -> Column:
    """A host column of no rows."""
    if isinstance(typ, T.ArrayType):
        return Column(typ, np.zeros(0, np.int32), None, None,
                      (empty_column(typ.element),))
    if isinstance(typ, T.MapType):
        return Column(typ, np.zeros(0, np.int32), None, None,
                      (empty_column(typ.key), empty_column(typ.value)))
    if isinstance(typ, T.RowType):
        return Column(typ, np.zeros(0, np.int8), None, None,
                      tuple(empty_column(ft) for ft in typ.field_types))
    dictionary = Dictionary() if typ.is_dictionary else None
    return Column(typ, np.zeros(0, typ.np_dtype), None, dictionary)
