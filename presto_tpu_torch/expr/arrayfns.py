"""Array, map and row functions over nested columns, as torch ops.

The reference's array/map library lives in presto-main/.../operator/
scalar/ (ArraySubscriptOperator, MapSubscriptOperator, ArrayContains,
ArrayMinFunction, MapConstructor, ...).  A nested column is lengths plus
flattened children (batch.py), so each function is offset arithmetic and
gathers over the flat children on the column's device: ``cumsum`` of the
lengths gives each row's first element, ``repeat_interleave`` maps each
element to its row, and per-row results are scatter reductions.  The
children of an ARRAY or MAP hold exactly ``sum(lengths)`` rows, so the
element count is a shape, never a read of the device.  ``split`` works
per dictionary entry on the host, as the reference does (strings never
live on the device), and its result goes to the column's device.

This slice holds the functions the collect aggregates and UNNEST need
(the constructors, subscripts, ``cardinality``, ``contains``,
``array_position``, ``array_min``/``array_max``, ``map(keys, values)``,
``split``, row fields and the ``$rows_*`` finalizers); the rest of the
library and the lambdas are ROADMAP A6b.

Calling convention (compile.py ``kind == "nested"``, ``on_device``):
``impl(args, valids, n, xp) -> (values, valid|None)``; ``xp`` is the
``TorchXp`` of the batch's device and each arg is

- a Column (tensors) for nested- and string-typed inputs (a string
  Column carries its Dictionary),
- a Python str for a string constant,
- a tensor of ``n`` values otherwise;

nested and string results come back as Columns, the rest as tensors.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import (
    Column, Dictionary, _concat_columns, null_column, range_gather_indices,
)
from presto_tpu_torch.ops.keys import to_sortable_i64

Pair = Tuple[Any, Optional[torch.Tensor]]

_BIG = 1 << 62


def _lengths(col: Column) -> torch.Tensor:
    return col.values.long()


def _row_ids(col: Column) -> torch.Tensor:
    """Flat-element -> parent-row index (no read of the device: the
    children's size is the element count)."""
    lengths = _lengths(col)
    total = col.children[0].values.shape[0]
    return torch.repeat_interleave(
        torch.arange(lengths.shape[0], device=lengths.device), lengths,
        output_size=total)


def _and_all(*valids) -> Optional[torch.Tensor]:
    out = None
    for v in valids:
        if v is not None:
            out = v if out is None else out & v
    return out


def _kid_result(kid: Column) -> Any:
    """A child column as a nested-call result value (its validity goes
    in the valid of the pair)."""
    if kid.type.is_nested or kid.type.is_dictionary:
        return kid.with_values(kid.values, None)
    return kid.values


def _null_result(typ: T.Type, n: int, device) -> Pair:
    return _kid_result(null_column(typ, n, device)), torch.zeros(
        n, dtype=torch.bool, device=device)


def _sort_keys(kid: Column) -> torch.Tensor:
    """int64 keys in the element type's order (a dictionary's codes as
    their lexicographic ranks)."""
    if kid.type.is_dictionary:
        ranks = torch.from_numpy(kid.dictionary.sort_ranks()
                                 .astype(np.int64)).to(kid.values.device)
        if ranks.shape[0] == 0:
            return torch.zeros_like(kid.values, dtype=torch.int64)
        return ranks[kid.values.long().clamp(0, ranks.shape[0] - 1)]
    return to_sortable_i64(kid.values, kid.type)


def _needle_codes(kid: Column, needle, n: int) -> torch.Tensor:
    """The searched value of each row in the element column's terms:
    kid's codes for strings (-1 where the string is not in kid's
    dictionary), the values otherwise."""
    dev = kid.values.device
    if isinstance(needle, str):
        code = kid.dictionary.code_of(needle)
        return torch.full((n,), -1 if code is None else code,
                          dtype=torch.int64, device=dev)
    if isinstance(needle, Column) and needle.type.is_dictionary:
        table = np.asarray([
            -1 if kid.dictionary.code_of(v) is None
            else kid.dictionary.code_of(v)
            for v in needle.dictionary.values] or [-1], np.int64)
        idx = needle.values.long().clamp(0, table.shape[0] - 1)
        return torch.from_numpy(table).to(dev)[idx]
    if isinstance(needle, Column):
        needle = needle.values
    return torch.as_tensor(needle, device=dev).expand(n)


def _matches(col: Column, needle, n: int,
             row_of: torch.Tensor) -> torch.Tensor:
    """elementwise kid[i] == needle[row_of[i]] (a NULL element compares
    unequal)."""
    kid = col.children[0]
    want = _needle_codes(kid, needle, n)
    eq = kid.values == want[row_of]
    if kid.valid is not None:
        eq = eq & kid.valid
    return eq


def _per_row_any(flags: torch.Tensor, row_of: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int32, device=flags.device)
    return out.index_add_(0, row_of, flags.to(torch.int32)) > 0


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def cardinality(args, valids, n, xp) -> Pair:
    (col,) = args
    return _lengths(col), _and_all(*valids)


def array_subscript(args, valids, n, xp) -> Pair:
    """arr[i] / element_at(arr, i): 1-based; negative = from the end;
    out of range yields NULL (element_at semantics)."""
    col, idx = args
    lengths = _lengths(col)
    kid = col.children[0]
    m = kid.values.shape[0]
    if m == 0:
        return _null_result(kid.type, n, lengths.device)
    idx = torch.as_tensor(idx, device=lengths.device).long().expand(n)
    pos = torch.where(idx < 0, lengths + idx, idx - 1)     # 0-based
    ok = (pos >= 0) & (pos < lengths)
    safe = torch.where(ok, col.starts() + pos.clamp(min=0), 0)
    taken = kid.take(safe.clamp(0, m - 1))
    if taken.valid is not None:
        ok = ok & taken.valid
    return _kid_result(taken), _and_all(ok, *valids)


def map_subscript(args, valids, n, xp) -> Pair:
    """m[k] / element_at(m, k): NULL when the key is absent; with
    duplicate keys the last wins."""
    col, key = args
    vcol = col.children[1]
    m = vcol.values.shape[0]
    dev = col.values.device
    if m == 0:
        return _null_result(vcol.type, n, dev)
    row_of = _row_ids(col)
    eq = _matches(col, key, n, row_of)
    pos = torch.where(eq, torch.arange(m, device=dev), -1)
    sel = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sel = sel.scatter_reduce(0, row_of, pos, "amax")
    found = sel >= 0
    taken = vcol.take(sel.clamp(0, m - 1))
    if taken.valid is not None:
        found = found & taken.valid
    return _kid_result(taken), _and_all(found, *valids)


def contains(args, valids, n, xp) -> Pair:
    col, needle = args
    row_of = _row_ids(col)
    eq = _matches(col, needle, n, row_of)
    return _per_row_any(eq, row_of, n), _and_all(*valids)


def array_position(args, valids, n, xp) -> Pair:
    """1-based position of the first match; 0 when absent."""
    col, needle = args
    row_of = _row_ids(col)
    eq = _matches(col, needle, n, row_of)
    dev = col.values.device
    local = torch.arange(row_of.shape[0], device=dev) - col.starts()[row_of]
    first = torch.full((n,), _BIG, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, row_of,
                                 torch.where(eq, local, _BIG), "amin")
    return torch.where(first == _BIG, 0, first + 1), _and_all(*valids)


def _extreme_index(keys: torch.Tensor, live: torch.Tensor,
                   row_of: torch.Tensor, n: int, largest: bool):
    """Per row, the element index of the least (or greatest) key among
    ``live`` elements, ties to the first (greatest: the last) element, as
    the reference's stable argsort picks; and whether the row had one."""
    dev = keys.device
    m = keys.shape[0]
    fill = torch.iinfo(torch.int64).min if largest else \
        torch.iinfo(torch.int64).max
    best = torch.full((n,), fill, dtype=torch.int64, device=dev)
    best = best.scatter_reduce(0, row_of, torch.where(live, keys, fill),
                               "amax" if largest else "amin")
    cand = live & (keys == best[row_of])
    pos = torch.arange(m, device=dev)
    if largest:
        at = torch.full((n,), -1, dtype=torch.int64, device=dev)
        at = at.scatter_reduce(0, row_of, torch.where(cand, pos, -1), "amax")
        return at.clamp(min=0), at >= 0
    at = torch.full((n,), _BIG, dtype=torch.int64, device=dev)
    at = at.scatter_reduce(0, row_of, torch.where(cand, pos, _BIG), "amin")
    return torch.where(at == _BIG, 0, at), at != _BIG


def _minmax(col: Column, largest: bool, n: int) -> Pair:
    kid = col.children[0]
    m = kid.values.shape[0]
    dev = col.values.device
    if m == 0:
        return _null_result(kid.type, n, dev)
    row_of = _row_ids(col)
    live = (torch.ones(m, dtype=torch.bool, device=dev)
            if kid.valid is None else kid.valid)
    # a NULL element makes the result NULL (Presto array_min/max)
    has_null = _per_row_any(~live, row_of, n)
    at, _ = _extreme_index(_sort_keys(kid), live, row_of, n, largest)
    taken = kid.take(at)
    return _kid_result(taken), (_lengths(col) > 0) & ~has_null


def array_min(args, valids, n, xp) -> Pair:
    out, valid = _minmax(args[0], False, n)
    return out, _and_all(valid, *valids)


def array_max(args, valids, n, xp) -> Pair:
    out, valid = _minmax(args[0], True, n)
    return out, _and_all(valid, *valids)


def split_fn(typ: T.Type):
    """split(string, delim [, limit]) -> array(varchar): each dictionary
    entry of the batch is split once on the host (one read of the codes
    a batch); the lengths and the pieces' codes, interned into the call
    site's dictionary, go to the column's device."""
    out_dict = Dictionary()

    def impl(args, valids, n, xp) -> Pair:
        src, delim = args[0], args[1]
        # a constant limit, read once a batch (an empty batch needs none)
        limit = int(args[2][0]) if len(args) > 2 and n else None

        def split_one(s: str) -> List[str]:
            return s.split(delim) if limit is None \
                else s.split(delim, limit - 1)

        if isinstance(src, str):       # a constant string
            parts = split_one(src)
            lengths = np.full(n, len(parts), np.int32)
            flat = np.tile(np.fromiter(
                (out_dict.intern(p) for p in parts), np.int32,
                len(parts)), n)
            dev = xp.device
        else:
            dev = src.values.device
            codes = src.values[:n].cpu().numpy()
            uniq, inverse = np.unique(codes, return_inverse=True)
            dvals = src.dictionary.values
            pieces: List[str] = []
            ulen = np.zeros(uniq.shape[0], np.int64)
            for j, c in enumerate(uniq.tolist()):
                got = split_one(dvals[c]) if 0 <= c < len(dvals) else []
                ulen[j] = len(got)
                pieces.extend(got)
            upieces = np.fromiter((out_dict.intern(p) for p in pieces),
                                  np.int32, len(pieces))
            lengths = ulen[inverse]
            ustart = np.cumsum(ulen) - ulen
            flat = upieces[range_gather_indices(ustart[inverse], lengths)]
            lengths = lengths.astype(np.int32)
        kid = Column(T.VARCHAR, torch.from_numpy(flat).to(dev), None,
                     out_dict)
        return Column(typ, torch.from_numpy(lengths).to(dev), None, None,
                      (kid,)), _and_all(*valids)

    return impl


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

def map_from_arrays(typ: T.Type):
    """map(keys, values): a row whose arrays differ in length is NULL
    (and empty)."""

    def impl(args, valids, n, xp) -> Pair:
        kcol, vcol = args
        ok = _lengths(kcol) == _lengths(vcol)
        keys, vals = kcol.children[0], vcol.children[0]
        if keys.values.shape[0] != vals.values.shape[0] or not bool(
                ok.all()):
            keep = torch.where(ok, _lengths(kcol), 0)
            keys = keys.take(range_gather_indices(kcol.starts(), keep))
            vals = vals.take(range_gather_indices(vcol.starts(), keep))
        lengths = torch.where(ok, kcol.values, 0)
        return Column(typ, lengths, None, None, (keys, vals)), \
            _and_all(ok, *valids)

    return impl


def rows_map(typ: T.Type):
    """map_agg's finalizer: array(row(k, v)) -> map(k, v)."""

    def impl(args, valids, n, xp) -> Pair:
        (col,) = args
        k, v = col.children[0].children
        return Column(typ, col.values, None, None, (k, v)), \
            _and_all(*valids)

    return impl


# ---------------------------------------------------------------------------
# the collect aggregates' finalizers, over array(row(...)) state
# ---------------------------------------------------------------------------

def rows_extreme_by(mode: str):
    """x at the min/max y over array(row(x, y)) (min_by/max_by); a NULL y
    never wins."""

    def impl(args, valids, n, xp) -> Pair:
        (col,) = args
        xcol, ycol = col.children[0].children
        m = ycol.values.shape[0]
        dev = col.values.device
        if m == 0:
            return _null_result(xcol.type, n, dev)
        live = (torch.ones(m, dtype=torch.bool, device=dev)
                if ycol.valid is None else ycol.valid)
        at, seen = _extreme_index(_sort_keys(ycol), live, _row_ids(col), n,
                                  mode == "max_by")
        taken = xcol.take(at)
        valid = seen if taken.valid is None else seen & taken.valid
        return _kid_result(taken), _and_all(valid, *valids)

    return impl


def rows_statistic(stat: str):
    """corr / covar_samp / covar_pop / regr_slope / regr_intercept over
    collected array(row(y, x)) pairs, by the reference's two passes (the
    means, then the centered sums; DoubleCovarianceAggregation and
    DoubleRegressionAggregation's formulas).  Each sum runs over a row's
    elements in order (``sorted_segment_sums``): the same bits on every
    run, in another order than numpy's pairwise sums."""
    from presto_tpu_torch.ops.groupby import sorted_segment_sums

    def impl(args, valids, n, xp) -> Pair:
        (col,) = args
        ycol, xcol = col.children[0].children
        dev = col.values.device
        y = ycol.values.to(torch.float64)
        x = xcol.values.to(torch.float64)
        row_of = _row_ids(col)
        live = _and_all(ycol.valid, xcol.valid)
        if live is not None:
            keep = torch.nonzero(live).squeeze(1)
            y, x, row_of = y[keep], x[keep], row_of[keep]
        cnt = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, row_of, torch.ones_like(row_of))
        c = cnt.to(torch.float64)
        safe = c.clamp(min=1)
        mx = sorted_segment_sums(x, cnt) / safe
        my = sorted_segment_sums(y, cnt) / safe
        dx = x - mx[row_of]
        dy = y - my[row_of]
        cxy = sorted_segment_sums(dx * dy, cnt)
        cxx = sorted_segment_sums(dx * dx, cnt)
        cyy = sorted_segment_sums(dy * dy, cnt)
        if stat == "covar_pop":
            out, ok = cxy / safe, cnt > 0
        elif stat == "covar_samp":
            out, ok = cxy / (c - 1).clamp(min=1), cnt > 1
        elif stat == "corr":
            ok = (cnt > 0) & (cxx > 0) & (cyy > 0)
            out = cxy / torch.sqrt(torch.where(ok, cxx * cyy, 1.0))
        else:
            ok = (cnt > 0) & (cxx > 0)
            slope = cxy / torch.where(ok, cxx, 1.0)
            out = slope if stat == "regr_slope" else my - slope * mx
        out = torch.where(ok, out, 0.0)
        return out, _and_all(ok, *valids)

    return impl


# ---------------------------------------------------------------------------
# rows and constructors
# ---------------------------------------------------------------------------

def row_field(field_index: int):
    def impl(args, valids, n, xp) -> Pair:
        (col,) = args
        kid = col.children[field_index]
        return _kid_result(kid), _and_all(kid.valid, *valids)

    return impl


def _arg_column(typ: T.Type, v, valid, n: int, dev) -> Column:
    """One constructor argument as a column of ``typ`` on ``dev``."""
    if isinstance(v, Column):
        return Column(typ, v.values, valid, v.dictionary, v.children)
    if isinstance(v, str):
        return Column(typ, torch.zeros(n, dtype=torch.int32, device=dev),
                      valid, Dictionary([v]))
    from presto_tpu_torch.expr.xp import torch_dtype

    vals = torch.as_tensor(v, device=dev).to(
        torch_dtype(typ.np_dtype)).expand(n).contiguous()
    return Column(typ, vals, valid)


def array_constructor(typ: T.Type, k: int):
    """ARRAY[e1, ..., ek]: k element expressions -> length-k rows.  NULL
    elements stay as null entries; the array itself is never NULL."""

    def impl(args, valids, n, xp) -> Pair:
        dev = xp.device
        lengths = torch.full((n,), k, dtype=torch.int32, device=dev)
        if k == 0:
            kid = null_column(typ.element, 0, dev)
            return Column(typ, lengths, None, None, (kid,)), None
        kids = [_arg_column(typ.element, v, vv, n, dev)
                for v, vv in zip(args, valids)]
        if not typ.element.is_nested and not typ.element.is_dictionary:
            # row-major [i * k + j] straight from the stacked arguments
            values = torch.stack([c.values for c in kids], 1).reshape(-1)
            valid = None
            if any(c.valid is not None for c in kids):
                valid = torch.stack([
                    c.valid if c.valid is not None else
                    torch.ones(n, dtype=torch.bool, device=dev)
                    for c in kids], 1).reshape(-1)
            flat = Column(typ.element, values, valid)
        else:
            flat = _concat_columns(kids, [n] * k) if k > 1 else kids[0]
            # the concat's layout is [j * n + i]; rows need [i * k + j]
            g = (torch.arange(k, device=dev)[None, :] * n
                 + torch.arange(n, device=dev)[:, None]).reshape(-1)
            flat = flat.take(g)
        return Column(typ, lengths, None, None, (flat,)), None

    return impl


def row_constructor(typ: T.Type):
    def impl(args, valids, n, xp) -> Pair:
        dev = xp.device
        kids = tuple(_arg_column(ft, v, vv, n, dev)
                     for ft, v, vv in zip(typ.field_types, args, valids))
        return Column(typ, torch.zeros(n, dtype=torch.int8, device=dev),
                      None, None, kids), None

    return impl
