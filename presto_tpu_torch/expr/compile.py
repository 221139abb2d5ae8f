"""RowExpression -> executable closure (the ExpressionCompiler replacement).

The reference compiles RowExpressions to JVM bytecode PageProcessors
(presto-main/.../sql/gen/ExpressionCompiler.java:55,
PageFunctionCompiler.java:98).  Here compilation produces a Python closure
over the ``xp`` array namespace:

- run it with numpy             -> the host path (constant folding,
  string functions evaluated per dictionary entry),
- run it with ``TorchXp(device)`` -> eager torch ops on the batch's
  device; ``expr/xp.py`` gives torch numpy's names.

String expressions never execute on device: they are computed ONCE per
*dictionary entry* at compile time (dictionaries are compile-time constants
bound to the input schema) and become lookup-table gathers on device — the
generalization of the reference's DictionaryAwarePageProjection
(presto-main/.../operator/project/PageProcessor.java:54).

Null semantics are the SQL three-valued logic: each compiled node yields
``(values, valid)`` with ``valid=None`` meaning "no nulls" (the
Block.mayHaveNull fast path).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, Dictionary, _host
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr.ir import (
    Call, Constant, InputRef, LambdaExpr, RowExpression, SpecialForm, VarRef,
)
from presto_tpu_torch.expr.xp import NUMPY

Pair = Tuple[Any, Optional[Any]]  # (values, valid|None)


@dataclasses.dataclass
class CompiledExpr:
    """One compiled expression node graph.

    ``run(cols, n, xp)``: cols is the list of input-channel (values, valid)
    pairs, n the row count (only used when the expr has no inputs), xp the
    array namespace.  Returns (values, valid|None).
    """

    type: T.Type
    run: Callable[[Sequence[Pair], Any, Any], Pair]
    dictionary: Optional[Dictionary] = None   # set when type is string-ish
    const_str: Optional[str] = None           # set for string constants


def _and_valid(xp, a: Optional[Any], b: Optional[Any]) -> Optional[Any]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _filled(xp, values, valid, fill):
    if valid is None:
        return values
    return xp.where(valid, values, fill)


class ExprCompiler:
    def __init__(self, dictionaries: Dict[int, Dictionary],
                 vars: Optional[Dict[str, CompiledExpr]] = None):
        self.dicts = dictionaries
        self.vars = vars or {}

    def compile(self, expr: RowExpression) -> CompiledExpr:
        if isinstance(expr, InputRef):
            return self._input(expr)
        if isinstance(expr, Constant):
            return self._constant(expr)
        if isinstance(expr, VarRef):
            bound = self.vars.get(expr.name)
            if bound is None:
                raise ValueError(f"unbound lambda variable {expr.name}")
            return bound
        if isinstance(expr, LambdaExpr):
            raise ValueError("lambda outside an array/map function call")
        if isinstance(expr, Call):
            return self._call(expr)
        if isinstance(expr, SpecialForm):
            return self._special(expr)
        raise TypeError(f"unknown expression node: {expr!r}")

    # -- leaves ----------------------------------------------------------
    def _input(self, expr: InputRef) -> CompiledExpr:
        i = expr.index

        def run(cols, n, xp):
            return cols[i]

        d = self.dicts.get(i) if expr.type.is_dictionary else None
        if expr.type.is_dictionary and d is None:
            raise ValueError(f"no dictionary bound for string channel {i}")
        return CompiledExpr(expr.type, run, dictionary=d)

    def _constant(self, expr: Constant) -> CompiledExpr:
        t = expr.type
        if expr.value is None:
            if t.is_nested:
                raise NotImplementedError(
                    f"{t.display()} values: ROADMAP A6 ports nested types")
            dt = t.np_dtype

            def run(cols, n, xp):
                nn = _rowcount(cols, n, xp)
                return xp.zeros(nn, dt), xp.zeros(nn, bool)

            d = Dictionary([""]) if t.is_dictionary else None
            return CompiledExpr(t, run, dictionary=d)
        if t.is_dictionary:
            s = str(expr.value)
            d = Dictionary([s])

            def run(cols, n, xp):
                return xp.zeros(_rowcount(cols, n, xp), np.int32), None

            return CompiledExpr(t, run, dictionary=d, const_str=s)
        value = expr.value
        dt = t.np_dtype

        def run(cols, n, xp):
            return xp.full(_rowcount(cols, n, xp), value, dt), None

        return CompiledExpr(t, run)

    # -- calls -----------------------------------------------------------
    def _call(self, expr: Call) -> CompiledExpr:
        fn: F.Scalar = expr.fn
        if fn is None:
            raise ValueError(f"unresolved call {expr.name}")
        if fn.kind == "nested":  # before arg compile: lambdas aren't exprs
            return self._nested_call(expr, fn)
        cargs = [self.compile(a) for a in expr.args]
        if fn.null_mode == "is_null":
            (a,) = cargs

            def run(cols, n, xp):
                v, valid = a.run(cols, n, xp)
                if valid is None:
                    return xp.zeros(_value_len(v), bool), None
                return ~valid, None

            return CompiledExpr(T.BOOLEAN, run)
        if fn.null_mode == "is_not_null":
            (a,) = cargs

            def run(cols, n, xp):
                v, valid = a.run(cols, n, xp)
                if valid is None:
                    return xp.ones(_value_len(v), bool), None
                return valid, None

            return CompiledExpr(T.BOOLEAN, run)
        if fn.null_mode == "hash64":
            raise NotImplementedError(
                "hash64: ROADMAP A13 ports the row hashing (ops/hashing.py)")
        if fn.kind == "string":
            return self._string_call(expr, fn, cargs)
        impl = fn.impl
        if fn.null_mode == "custom_divzero":
            a, b = cargs

            def run(cols, n, xp):
                av, avalid = a.run(cols, n, xp)
                bv, bvalid = b.run(cols, n, xp)
                nonzero = bv != 0
                safe_b = xp.where(nonzero, bv, xp.ones_like(bv))
                out = impl(xp, av, safe_b)
                valid = _and_valid(xp, _and_valid(xp, avalid, bvalid), nonzero)
                return out, valid

            return CompiledExpr(fn.result_type, run)

        def run(cols, n, xp):
            vals = []
            valid = None
            for c in cargs:
                v, cv = c.run(cols, n, xp)
                vals.append(v)
                valid = _and_valid(xp, valid, cv)
            return impl(xp, *vals), valid

        return CompiledExpr(fn.result_type, run)

    def _nested_call(self, expr: Call, fn: F.Scalar) -> CompiledExpr:
        """Host-side functions over whole columns (value -> string casts,
        date_format).  Array/map/row functions and lambdas are ROADMAP
        A6."""
        if any(isinstance(a, LambdaExpr) for a in expr.args):
            raise NotImplementedError(
                f"lambda in {expr.name}: ROADMAP A6 ports nested types")
        cvals = [self.compile(a) for a in expr.args]
        impl = fn.impl
        rt = fn.result_type
        out_dict = getattr(fn, "out_dictionary", None)

        def as_arg(c: CompiledExpr, v):
            if isinstance(v, Column):
                return v
            if c.const_str is not None:
                return c.const_str
            if c.type.is_dictionary:
                return Column(c.type, np.asarray(v), None, c.dictionary)
            return np.asarray(v)

        def run(cols, n, xp):
            # host-side by design (strings are built on the host)
            host_cols = [(_host_value(v), None if valid is None
                          else _host(valid)) for v, valid in cols]
            args, valids = [], []
            for c in cvals:
                v, valid = c.run(host_cols, n, NUMPY)
                args.append(as_arg(c, v))
                valids.append(valid)
            return impl(args, valids, n, NUMPY)

        return CompiledExpr(rt, run, dictionary=out_dict)

    def _string_call(self, expr: Call, fn: F.Scalar,
                     cargs: List[CompiledExpr]) -> CompiledExpr:
        """Host-side per-dictionary-entry evaluation, device gather."""
        # Identify the (single) dictionary-column argument; all others must
        # be constants.
        dict_arg_idx = None
        const_vals: List[Any] = []
        for i, (ca, node) in enumerate(zip(cargs, expr.args)):
            if ca.const_str is not None:
                const_vals.append(ca.const_str)
            elif isinstance(node, Constant):
                const_vals.append(node.value)
            elif ca.type.is_dictionary:
                if dict_arg_idx is not None or ca.dictionary is None:
                    # several string columns, or a runtime-built dictionary
                    # (cast-to-varchar / array_join): evaluate row-wise on
                    # the host instead of per-dictionary-entry
                    return self._string_host_call(fn, cargs)
                dict_arg_idx = i
                const_vals.append(None)
            else:
                # non-constant non-string argument (e.g. strpos(s, col)):
                # host row-wise fallback
                return self._string_host_call(fn, cargs)
        if dict_arg_idx is None:
            # all-constant: fold at compile time
            result = fn.impl(*const_vals)
            return self._constant(Constant(result, fn.result_type))
        src = cargs[dict_arg_idx]
        entries = src.dictionary.values
        per_entry = []
        for e in entries:
            args = list(const_vals)
            args[dict_arg_idx] = e
            per_entry.append(fn.impl(*args))
        rt = fn.result_type
        # a None per-entry result means NULL for rows holding that code
        # (split_part past the end, regexp_extract without a match, ...)
        null_codes = [i for i, v in enumerate(per_entry) if v is None]
        ok_np = None
        if null_codes:
            ok_np = np.ones(len(per_entry), dtype=bool)
            ok_np[null_codes] = False
        if rt.is_dictionary:
            # intern (dedupe) results: equal strings MUST share a code —
            # group-by/join/compare on dictionary columns operate on codes
            # (e.g. substr over a per-row-distinct phone column yields few
            # distinct country codes from many entries)
            out_dict = Dictionary()
            remap_np = np.empty(max(len(per_entry), 1), np.int32)
            for i, v in enumerate(per_entry):
                remap_np[i] = out_dict.intern(v if v is not None else "")

            def run(cols, n, xp):
                codes, valid = src.run(cols, n, xp)
                if ok_np is not None:
                    ok = xp.take(xp.asarray(ok_np), codes, axis=0)
                    valid = ok if valid is None else (valid & ok)
                codes = xp.take(xp.asarray(remap_np), codes, axis=0)
                return codes, valid

            return CompiledExpr(rt, run, dictionary=out_dict)
        lookup_np = np.asarray(
            [v if v is not None else 0 for v in per_entry],
            dtype=rt.np_dtype)

        def run(cols, n, xp):
            codes, valid = src.run(cols, n, xp)
            table = xp.asarray(lookup_np)
            out = xp.take(table, codes, axis=0)
            if ok_np is not None:
                ok = xp.take(xp.asarray(ok_np), codes, axis=0)
                valid = ok if valid is None else (valid & ok)
            return out, valid

        return CompiledExpr(rt, run)

    def _string_host_call(self, fn: F.Scalar,
                          cargs: List[CompiledExpr]) -> CompiledExpr:
        """Row-wise host evaluation of a string function (used when the
        per-dictionary-entry binding can't apply: several string columns,
        runtime dictionaries, or non-constant non-string arguments).
        Results intern into a per-call-site append-only dictionary."""
        rt = fn.result_type
        impl = fn.impl
        out_dict = Dictionary() if rt.is_dictionary else None

        def decode(c: CompiledExpr, v, valid, n):
            if isinstance(v, Column):
                return v.to_pylist(n) if v.type.is_dictionary \
                    else list(_host(v.values)[:n])
            if c.const_str is not None:
                return [c.const_str] * n
            v = np.asarray(v)
            if c.type.is_dictionary:
                d = c.dictionary
                return [d.values[int(x)] if 0 <= int(x) < len(d) else None
                        for x in v[:n]]
            return [c.type.to_python(x) for x in v[:n]]

        def run(cols, n, xp):
            host_cols = [(_host_value(v), None if valid is None
                          else _host(valid)) for v, valid in cols]
            nn = _rowcount(host_cols, n, np)
            arg_lists = []
            valid_all = None
            for c in cargs:
                v, valid = c.run(host_cols, nn, NUMPY)
                arg_lists.append(decode(c, v, valid, nn))
                valid_all = _and_valid(np, valid_all,
                                       None if valid is None
                                       else np.asarray(valid))
            live = np.ones(nn, bool) if valid_all is None else valid_all
            ok = live.copy()
            if out_dict is not None:
                out = np.zeros(nn, np.int32)
            else:
                out = np.zeros(nn, rt.np_dtype)
            for i in range(nn):
                if not live[i]:
                    continue
                res = impl(*(al[i] for al in arg_lists))
                if res is None:
                    ok[i] = False
                elif out_dict is not None:
                    out[i] = out_dict.intern(res)
                else:
                    out[i] = res
            valid = None if bool(ok.all()) else ok
            return out, valid

        return CompiledExpr(rt, run, dictionary=out_dict)

    # -- special forms ---------------------------------------------------
    def _special(self, expr: SpecialForm) -> CompiledExpr:
        form = expr.form
        if form == "AND" or form == "OR":
            a, b = (self.compile(x) for x in expr.args)
            is_and = form == "AND"

            def run(cols, n, xp):
                av, avalid = a.run(cols, n, xp)
                bv, bvalid = b.run(cols, n, xp)
                fill = is_and  # AND fills nulls True; OR fills False
                af = _filled(xp, av, avalid, fill)
                bf = _filled(xp, bv, bvalid, fill)
                out = (af & bf) if is_and else (af | bf)
                if avalid is None and bvalid is None:
                    return out, None
                ones = xp.ones(af.shape[0], bool)
                avl = avalid if avalid is not None else ones
                bvl = bvalid if bvalid is not None else ones
                if is_and:
                    known = (avl & ~af) | (bvl & ~bf)
                else:
                    known = (avl & af) | (bvl & bf)
                return out, (avl & bvl) | known

            return CompiledExpr(T.BOOLEAN, run)
        if form == "IF":
            cond, then, other = (self.compile(x) for x in expr.args)
            return self._if(expr.type, cond, then, other)
        if form == "SWITCH":
            # args = [default, cond1, v1, cond2, v2, ...] -> nested IFs
            default = expr.args[0]
            pairs = list(zip(expr.args[1::2], expr.args[2::2]))
            node: RowExpression = default
            for cond, val in reversed(pairs):
                node = SpecialForm("IF", (cond, val, node), expr.type)
            return self.compile(node)
        if form == "COALESCE":
            cargs = [self.compile(a) for a in expr.args]
            return self._coalesce(expr.type, cargs)
        if form == "IN":
            return self._in(expr)
        raise ValueError(f"unknown special form {form}")

    def _if(self, rt: T.Type, cond: CompiledExpr, then: CompiledExpr,
            other: CompiledExpr) -> CompiledExpr:
        out_dict = None
        remap_then = remap_other = None
        if rt.is_dictionary:
            out_dict = Dictionary()
            remap_then = then.dictionary.remap_into(out_dict)
            remap_other = other.dictionary.remap_into(out_dict)

        def run(cols, n, xp):
            cv, cvalid = cond.run(cols, n, xp)
            tv, tvalid = then.run(cols, n, xp)
            ov, ovalid = other.run(cols, n, xp)
            take_then = _filled(xp, cv, cvalid, False)
            if remap_then is not None:
                tv = xp.take(xp.asarray(remap_then), tv, axis=0)
                ov = xp.take(xp.asarray(remap_other), ov, axis=0)
            out = xp.where(take_then, tv, ov)
            if tvalid is None and ovalid is None:
                return out, None
            ones = xp.ones(out.shape[0], bool)
            tvl = tvalid if tvalid is not None else ones
            ovl = ovalid if ovalid is not None else ones
            return out, xp.where(take_then, tvl, ovl)

        return CompiledExpr(rt, run, dictionary=out_dict)

    def _coalesce(self, rt: T.Type, cargs: List[CompiledExpr]) -> CompiledExpr:
        out_dict = None
        remaps = None
        if rt.is_dictionary:
            out_dict = Dictionary()
            remaps = [c.dictionary.remap_into(out_dict) for c in cargs]

        def run(cols, n, xp):
            acc_v = acc_valid = None
            for i, c in enumerate(cargs):
                v, valid = c.run(cols, n, xp)
                if remaps is not None:
                    v = xp.take(xp.asarray(remaps[i]), v, axis=0)
                if acc_v is None:
                    acc_v, acc_valid = v, valid
                else:
                    need = ~acc_valid  # positions still null
                    acc_v = xp.where(need, v, acc_v)
                    if valid is None:
                        acc_valid = None
                    else:
                        acc_valid = acc_valid | valid
                if acc_valid is None:
                    break
            return acc_v, acc_valid

        return CompiledExpr(rt, run, dictionary=out_dict)

    def _in(self, expr: SpecialForm) -> CompiledExpr:
        value = self.compile(expr.args[0])
        items = expr.args[1:]
        if value.type.is_dictionary:
            if not all(isinstance(i, Constant) and i.value is not None
                       for i in items):
                raise NotImplementedError("IN over non-constant string list")
            # a set: duplicate literals in the IN list are legal SQL
            consts = {str(i.value) for i in items}
            lookup_np = np.asarray(
                [e in consts for e in value.dictionary.values], dtype=bool)

            def run(cols, n, xp):
                codes, valid = value.run(cols, n, xp)
                return xp.take(xp.asarray(lookup_np), codes, axis=0), valid

            return CompiledExpr(T.BOOLEAN, run)
        citems = [self.compile(i) for i in items]

        def run(cols, n, xp):
            v, valid = value.run(cols, n, xp)
            out = None
            for ci in citems:
                iv, ivalid = ci.run(cols, n, xp)
                valid = _and_valid(xp, valid, ivalid)
                eq = v == iv
                out = eq if out is None else (out | eq)
            return out, valid

        return CompiledExpr(T.BOOLEAN, run)


def _value_len(v) -> int:
    return v.values.shape[0] if isinstance(v, Column) else v.shape[0]


def _rowcount(cols, n, xp):
    for v, _ in cols:
        return _value_len(v)
    return n


def _host_value(v):
    if isinstance(v, Column):
        return v.to_numpy()
    return _host(v)


# ---------------------------------------------------------------------------
# Convenience entry points
# ---------------------------------------------------------------------------

def compile_expr(expr: RowExpression,
                 dictionaries: Optional[Dict[int, Dictionary]] = None
                 ) -> CompiledExpr:
    return ExprCompiler(dictionaries or {}).compile(expr)


def batch_dictionaries(batch: Batch) -> Dict[int, Dictionary]:
    return {i: c.dictionary for i, c in enumerate(batch.columns)
            if c.dictionary is not None}


def needs_host_path(exprs: Sequence[RowExpression]) -> bool:
    """True when any expression touches nested types: those evaluate
    host-side (offset bookkeeping + flat-child math), so the enclosing
    operator must not jit-trace the column arrays."""
    from presto_tpu_torch.expr.ir import walk

    for expr in exprs:
        if expr is None:
            continue
        for e in walk(expr):
            ty = getattr(e, "type", None)
            if ty is not None and T.is_nested(ty):
                return True
            fn = getattr(e, "fn", None)
            if fn is None:
                continue
            if getattr(fn, "kind", None) == "nested":
                return True
            if getattr(fn, "kind", None) == "string":
                # row-wise host fallback cases (see _string_call)
                str_cols = sum(
                    1 for a in e.args
                    if a.type.is_dictionary and not isinstance(a, Constant))
                other_nonconst = any(
                    not a.type.is_dictionary and not isinstance(a, Constant)
                    for a in e.args)
                if str_cols > 1 or other_nonconst:
                    return True
    return False


def batch_pairs(batch: Batch) -> List[Pair]:
    """Input-channel (values, valid) pairs for compiled expressions."""
    return [(c.values, c.valid) for c in batch.columns]


def result_column(compiled: CompiledExpr, values, valid) -> Column:
    if isinstance(values, Column):
        return Column(values.type, values.values, valid, values.dictionary)
    return Column(compiled.type, values, valid, compiled.dictionary)


def evaluate(expr: RowExpression, batch: Batch, xp=NUMPY) -> Column:
    """Interpret one expression over a Batch (the oracle path)."""
    compiled = compile_expr(expr, batch_dictionaries(batch))
    values, valid = compiled.run(batch_pairs(batch), batch.num_rows, xp)
    return result_column(compiled, values, valid)
