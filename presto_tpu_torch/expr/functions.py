"""Scalar/aggregate function registry and overload resolution.

The reference registers ~243 built-ins in FunctionRegistry
(presto-main/.../metadata/FunctionRegistry.java:327) and resolves parametric
signatures at analysis time; implementations are @ScalarFunction methods the
codegen tier links against.  Here resolution produces a ``Scalar`` carrying
the implementation directly, in one of two execution kinds:

- ``array``: elementwise over device value arrays; body written against the
  ``xp`` namespace so the SAME code runs under numpy (the oracle/interpreter)
  and under jax tracing (the XLA path).  This is the TPU replacement for
  generated bytecode: resolution *is* specialization (dtype/rescale factors
  are closed over), XLA jit *is* the codegen cache.
- ``string``: computed host-side per *dictionary entry*, then gathered on
  device (strings never live in HBM; dictionary cardinality << row count).
  Covers LIKE/substr/comparisons-vs-literal/casts-from-varchar.

Null semantics: 'propagate' (NULL in -> NULL out, the reference's
RETURN_NULL_ON_NULL convention), 'never_null', or 'custom' (impl sees and
returns (values, valid) pairs).
"""

from __future__ import annotations

import dataclasses
import math
import re
from functools import lru_cache
from typing import Any, Callable, List, Optional, Sequence, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import datemath
from presto_tpu_torch.ops.keys import check_flat_key

# ---------------------------------------------------------------------------
# Scalar descriptor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scalar:
    name: str
    arg_types: Tuple[T.Type, ...]
    result_type: T.Type
    kind: str                      # 'array' | 'string'
    impl: Callable                 # array: (xp, *arrays)->array | string: (*py)->py
    null_mode: str = "propagate"   # 'propagate' | 'never_null' | 'custom'
    # re-resolution recipe for pickling (fragments travel to workers over
    # the task wire; impl closures don't pickle, so a Scalar serializes as
    # the recipe that re-resolves it — the same determinism the reference
    # relies on when workers re-run codegen per fragment)
    re_key: Optional[tuple] = None

    def __reduce__(self):
        key = self.re_key or ("scalar", self.name, self.arg_types)
        return (_rebuild_scalar, tuple(key))


def _rebuild_scalar(kind, *args):
    if kind == "scalar":
        return resolve_scalar(args[0], list(args[1]))
    if kind == "cast":
        return resolve_cast(args[0], args[1])
    if kind == "try_cast":
        return resolve_try_cast(args[0], args[1])
    if kind == "round":
        return resolve_round(args[0], args[1])
    if kind == "array_ctor":
        return resolve_array_constructor(args[0], args[1])
    if kind == "row_field":
        return resolve_row_field_index(args[0], args[1])
    if kind == "row":
        return resolve_row_constructor(list(args[0]))
    if kind == "date_format":
        return resolve_date_format(args[0], args[1])
    if kind == "format_datetime":
        return resolve_format_datetime(args[0], args[1])
    if kind == "array_percentile":
        return resolve_array_percentile(args[0], args[1])
    raise FunctionError(f"bad scalar pickle key {kind!r}")


class FunctionError(ValueError):
    pass


def _abs(xp, v):
    """|v| of an array or of a Python int divisor (a constant factor)."""
    return abs(v) if isinstance(v, int) else xp.abs(v)


def _trunc_div(xp, a, b):
    """SQL integer division truncates toward zero (5/2=2, -5/2=-2)."""
    q = xp.floor_divide(xp.abs(a), _abs(xp, b))
    return xp.where((a < 0) ^ (b < 0), -q, q)


def _round_half_up_div(xp, a, b):
    """round-half-away-from-zero of a/b in exact integer arithmetic."""
    q = xp.floor_divide(2 * xp.abs(a) + _abs(xp, b), 2 * _abs(xp, b))
    return xp.where((a < 0) ^ (b < 0), -q, q)


def _pow10(n: int) -> int:
    return 10 ** n


def _is_float(t: T.Type) -> bool:
    return t.name in ("double", "real")


def _decimal_of(t: T.Type) -> T.DecimalType:
    if isinstance(t, T.DecimalType):
        return t
    return T.DecimalType("decimal", {"tinyint": 3, "smallint": 5,
                                     "integer": 10, "bigint": 19}[t.name], 0)


# ---------------------------------------------------------------------------
# Arithmetic resolution
# ---------------------------------------------------------------------------

def _resolve_arith(name: str, a: T.Type, b: T.Type) -> Scalar:
    if _is_float(a) or _is_float(b):
        out = T.DOUBLE if "double" in (a.name, b.name) else T.REAL
        sa = _to_float_factor(a)
        sb = _to_float_factor(b)
        ops = {
            "add": lambda xp, x, y: _f(xp, x, sa, out) + _f(xp, y, sb, out),
            "subtract": lambda xp, x, y: _f(xp, x, sa, out) - _f(xp, y, sb, out),
            "multiply": lambda xp, x, y: _f(xp, x, sa, out) * _f(xp, y, sb, out),
            "divide": lambda xp, x, y: _f(xp, x, sa, out) / _f(xp, y, sb, out),
            "modulus": lambda xp, x, y: _fmod(xp, _f(xp, x, sa, out),
                                              _f(xp, y, sb, out)),
        }
        return Scalar(name, (a, b), out, "array", ops[name])
    if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
        da, db = _decimal_of(a), _decimal_of(b)
        if name in ("add", "subtract"):
            s = max(da.scale, db.scale)
            p = min(38, max(da.precision - da.scale, db.precision - db.scale) + s + 1)
            fa, fb = _pow10(s - da.scale), _pow10(s - db.scale)
            out = T.DecimalType("decimal", p, s)
            if name == "add":
                impl = lambda xp, x, y: x * fa + y * fb  # noqa: E731
            else:
                impl = lambda xp, x, y: x * fa - y * fb  # noqa: E731
            return Scalar(name, (a, b), out, "array", impl)
        if name == "multiply":
            out = T.DecimalType("decimal", min(38, da.precision + db.precision),
                                da.scale + db.scale)
            return Scalar(name, (a, b), out, "array", lambda xp, x, y: x * y)
        if name == "divide":
            # Presto: scale = max(s1, s2); precision grows accordingly.
            s = max(da.scale, db.scale)
            p = min(38, da.precision + db.scale + max(0, db.scale - da.scale) + 1)
            shift = _pow10(s - da.scale + db.scale)
            out = T.DecimalType("decimal", p, s)

            def impl(xp, x, y):
                return _round_half_up_div(xp, x * shift, y)

            return Scalar(name, (a, b), out, "array", impl, null_mode="custom_divzero")
        if name == "modulus":
            s = max(da.scale, db.scale)
            fa, fb = _pow10(s - da.scale), _pow10(s - db.scale)
            out = T.DecimalType("decimal", min(38, max(da.precision, db.precision)), s)

            def impl(xp, x, y):  # truncated modulus (sign of dividend)
                xs, ys = x * fa, y * fb
                return xs - _trunc_div(xp, xs, ys) * ys

            return Scalar(name, (a, b), out, "array", impl, null_mode="custom_divzero")
    if T.is_integral(a) and T.is_integral(b):
        out = T.common_super_type(a, b)
        ops = {
            "add": lambda xp, x, y: x + y,
            "subtract": lambda xp, x, y: x - y,
            "multiply": lambda xp, x, y: x * y,
            "divide": _trunc_div,
            "modulus": lambda xp, x, y: x - _trunc_div(xp, x, y) * y,
        }
        nm = "custom_divzero" if name in ("divide", "modulus") else "propagate"
        return Scalar(name, (a, b), out, "array", ops[name], null_mode=nm)
    # date/interval arithmetic is lowered to add_days/add_months by the
    # analyzer before reaching here.
    raise FunctionError(f"cannot resolve {name}({a.display()}, {b.display()})")


def _to_float_factor(t: T.Type) -> Optional[int]:
    return _pow10(t.scale) if isinstance(t, T.DecimalType) else None


def _f(xp, x, scale_factor, out_type):
    dt = out_type.np_dtype
    if scale_factor is not None:
        return xp.astype(x, dt) / scale_factor
    return xp.astype(x, dt)


def _fmod(xp, x, y):
    return x - xp.trunc(x / y) * y


# ---------------------------------------------------------------------------
# Comparison resolution
# ---------------------------------------------------------------------------

_CMP = {
    "eq": lambda xp, x, y: x == y,
    "ne": lambda xp, x, y: x != y,
    "lt": lambda xp, x, y: x < y,
    "le": lambda xp, x, y: x <= y,
    "gt": lambda xp, x, y: x > y,
    "ge": lambda xp, x, y: x >= y,
}

_PY_CMP = {
    "eq": lambda x, y: x == y,
    "ne": lambda x, y: x != y,
    "lt": lambda x, y: x < y,
    "le": lambda x, y: x <= y,
    "gt": lambda x, y: x > y,
    "ge": lambda x, y: x >= y,
}


def _resolve_cmp(name: str, a: T.Type, b: T.Type) -> Scalar:
    if T.is_string(a) and T.is_string(b):
        return Scalar(name, (a, b), T.BOOLEAN, "string", _PY_CMP[name])
    if a == b and not T.is_numeric(a):
        return Scalar(name, (a, b), T.BOOLEAN, "array", _CMP[name])
    common = T.common_super_type(a, b)
    if common is None or not (T.is_numeric(a) and T.is_numeric(b)):
        raise FunctionError(f"cannot compare {a.display()} and {b.display()}")
    if isinstance(common, T.DecimalType) and not (_is_float(a) or _is_float(b)):
        da, db = _decimal_of(a), _decimal_of(b)
        s = max(da.scale, db.scale)
        fa, fb = _pow10(s - da.scale), _pow10(s - db.scale)
        op = _CMP[name]
        return Scalar(name, (a, b), T.BOOLEAN, "array",
                      lambda xp, x, y: op(xp, x * fa, y * fb))
    sa, sb = _to_float_factor(a), _to_float_factor(b)
    out = T.DOUBLE if _is_float(a) or _is_float(b) or \
        isinstance(common, T.DecimalType) else common
    op = _CMP[name]
    if _is_float(out):
        return Scalar(name, (a, b), T.BOOLEAN, "array",
                      lambda xp, x, y: op(xp, _f(xp, x, sa, out), _f(xp, y, sb, out)))
    return Scalar(name, (a, b), T.BOOLEAN, "array", op)


# ---------------------------------------------------------------------------
# String functions (host-side per dictionary entry)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=4096)
def like_to_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _like(value: str, pattern: str, escape: Optional[str] = None) -> bool:
    return like_to_regex(pattern, escape).match(value) is not None


def _substr(s: str, start: int, length: Optional[int] = None) -> str:
    # SQL substr: 1-based; negative start counts from the end.
    n = len(s)
    start = int(start)
    if start == 0:
        begin = 0
    elif start > 0:
        begin = start - 1
    else:
        begin = n + start
    if begin < 0 or begin >= n:
        return ""
    end = n if length is None else min(n, begin + max(int(length), 0))
    return s[begin:end]


def _lpad(s: str, n: int, pad: str = " ") -> str:
    n = int(n)
    if len(s) >= n:
        return s[:n]
    fill = (pad * n)[:n - len(s)] if pad else s
    return fill + s


def _rpad(s: str, n: int, pad: str = " ") -> str:
    n = int(n)
    if len(s) >= n:
        return s[:n]
    fill = (pad * n)[:n - len(s)] if pad else s
    return s + fill


def _split_part(s: str, delim: str, index: int) -> Optional[str]:
    if not delim:
        return None
    parts = s.split(delim)
    i = int(index)
    if i < 1:
        raise FunctionError("split_part index must be positive")
    return parts[i - 1] if i <= len(parts) else None


def _translate3(s: str, frm: str, to: str) -> str:
    table = {}
    for i, ch in enumerate(frm):
        table[ord(ch)] = to[i] if i < len(to) else None
    return s.translate(table)


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _hamming(a: str, b: str) -> int:
    if len(a) != len(b):
        raise FunctionError("hamming_distance arguments must be same length")
    return sum(x != y for x, y in zip(a, b))


@lru_cache(maxsize=256)
def _re_compile(pattern: str):
    return re.compile(pattern)


def _regexp_extract(s: str, pattern: str, group: int = 0) -> Optional[str]:
    m = _re_compile(pattern).search(s)
    if m is None:
        return None
    return m.group(int(group))


# ---------------------------------------------------------------------------
# JSON functions (presto-main/.../operator/scalar/JsonFunctions.java,
# JsonExtract.java) — per-dictionary-entry host evaluation
# ---------------------------------------------------------------------------

def _json_path_steps(path: str):
    """Parse the supported JSONPath subset: $.a.b[0]["c"]."""
    import re as _re

    if not path.startswith("$"):
        raise FunctionError(f"bad JSON path {path!r}")
    steps = []
    for m in _re.finditer(
            r"\.(\w+)|\[\s*(\d+)\s*\]|\[\s*\"([^\"]*)\"\s*\]"
            r"|\[\s*'([^']*)'\s*\]", path[1:]):
        field, idx, q1, q2 = m.groups()
        if idx is not None:
            steps.append(int(idx))
        else:
            steps.append(field or q1 or q2)
    return steps


def _json_get(doc: str, path: str):
    import json as _json

    try:
        v = _json.loads(doc)
    except Exception:
        return None
    for step in _json_path_steps(path):
        if isinstance(step, int):
            if not isinstance(v, list) or step >= len(v):
                return None
            v = v[step]
        else:
            if not isinstance(v, dict) or step not in v:
                return None
            v = v[step]
    return v


def _json_extract(doc: str, path: str):
    import json as _json

    v = _json_get(doc, path)
    return None if v is None else _json.dumps(v, separators=(",", ":"))


def _json_extract_scalar(doc: str, path: str):
    v = _json_get(doc, path)
    if v is None or isinstance(v, (dict, list)):
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _json_array_length(doc: str):
    import json as _json

    try:
        v = _json.loads(doc)
    except Exception:
        return None
    return len(v) if isinstance(v, list) else None


def _json_array_get(doc: str, idx) -> Optional[str]:
    import json as _json

    try:
        v = _json.loads(doc)
    except Exception:
        return None
    i = int(idx)
    if not isinstance(v, list):
        return None
    if i < 0:
        i += len(v)
    if not 0 <= i < len(v):
        return None
    out = v[i]
    return out if isinstance(out, str) \
        else _json.dumps(out, separators=(",", ":"))


def _json_parse(doc: str) -> Optional[str]:
    import json as _json

    try:
        return _json.dumps(_json.loads(doc), separators=(",", ":"))
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Binary / hashing / URL functions (VarbinaryFunctions.java,
# UrlFunctions.java) — varbinary values ride the dictionary as latin-1
# strings so raw digest bytes round-trip through to_hex
# ---------------------------------------------------------------------------

def _digest(algo: str):
    import hashlib

    def impl(s: str) -> str:
        h = hashlib.new(algo, s.encode("latin-1", errors="replace"))
        return h.digest().decode("latin-1")

    return impl


def _to_hex(s: str) -> str:
    return s.encode("latin-1", errors="replace").hex().upper()


def _from_hex(s: str) -> str:
    return bytes.fromhex(s).decode("latin-1")


def _crc32(s: str) -> int:
    import zlib

    return zlib.crc32(s.encode("latin-1", errors="replace"))


def _url_part(part: str):
    def impl(s: str):
        from urllib.parse import urlparse

        try:
            u = urlparse(s)
            if part == "port":
                return u.port        # lazy parse; may raise ValueError
        except Exception:
            return None
        if part == "host":
            return u.hostname or ""
        if part == "protocol":
            return u.scheme or ""
        if part == "path":
            return u.path or ""
        if part == "query":
            return u.query or ""
        if part == "fragment":
            return u.fragment or ""
        return None

    return impl


def _url_extract_parameter(s: str, name: str):
    from urllib.parse import parse_qs, urlparse

    try:
        qs = parse_qs(urlparse(s).query, keep_blank_values=True)
    except Exception:
        return None
    vals = qs.get(name)
    return vals[0] if vals else None




_STRING_FNS = {
    "like": (_like, T.BOOLEAN),
    "substr": (_substr, T.VARCHAR),
    "substring": (_substr, T.VARCHAR),
    "lower": (lambda s: s.lower(), T.VARCHAR),
    "upper": (lambda s: s.upper(), T.VARCHAR),
    "trim": (lambda s: s.strip(), T.VARCHAR),
    "ltrim": (lambda s: s.lstrip(), T.VARCHAR),
    "rtrim": (lambda s: s.rstrip(), T.VARCHAR),
    "length": (lambda s: len(s), T.BIGINT),
    "concat": (lambda *parts: "".join(parts), T.VARCHAR),
    "replace": (lambda s, find, repl="": s.replace(find, repl), T.VARCHAR),
    "strpos": (lambda s, sub: s.find(sub) + 1, T.BIGINT),
    "reverse": (lambda s: s[::-1], T.VARCHAR),
    "starts_with": (lambda s, p: s.startswith(p), T.BOOLEAN),
    "ends_with": (lambda s, p: s.endswith(p), T.BOOLEAN),
    "lpad": (_lpad, T.VARCHAR),
    "rpad": (_rpad, T.VARCHAR),
    "split_part": (_split_part, T.VARCHAR),
    "codepoint": (lambda s: ord(s[0]) if s else None, T.BIGINT),
    "chr": (lambda n: chr(int(n)), T.VARCHAR),
    "translate": (_translate3, T.VARCHAR),
    "levenshtein_distance": (_levenshtein, T.BIGINT),
    "hamming_distance": (_hamming, T.BIGINT),
    "regexp_like": (lambda s, p: _re_compile(p).search(s) is not None,
                    T.BOOLEAN),
    "regexp_extract": (_regexp_extract, T.VARCHAR),
    "regexp_replace": (lambda s, p, r="": _re_compile(p).sub(r, s),
                       T.VARCHAR),
    "json_extract": (_json_extract, T.VARCHAR),
    "json_extract_scalar": (_json_extract_scalar, T.VARCHAR),
    "json_array_length": (_json_array_length, T.BIGINT),
    "json_array_get": (_json_array_get, T.VARCHAR),
    "json_parse": (_json_parse, T.VARCHAR),
    "json_format": (lambda s: s, T.VARCHAR),
    "json_size": (lambda s, p: (lambda v: None if v is None
                                else (len(v) if isinstance(v, (dict, list))
                                      else 0))(_json_get(s, p)), T.BIGINT),
    # varbinary rides the dictionary as latin-1 carrier strings: to_utf8
    # stores the UTF-8 BYTES (one latin-1 char per byte) so digests and
    # to_hex see the same bytes the reference hashes
    "to_utf8": (lambda s: s.encode("utf-8").decode("latin-1"), T.VARBINARY),
    "from_utf8": (lambda s: s.encode("latin-1").decode("utf-8", "replace"),
                  T.VARCHAR),
    "md5": (_digest("md5"), T.VARBINARY),
    "sha1": (_digest("sha1"), T.VARBINARY),
    "sha256": (_digest("sha256"), T.VARBINARY),
    "sha512": (_digest("sha512"), T.VARBINARY),
    "crc32": (_crc32, T.BIGINT),
    "to_hex": (_to_hex, T.VARCHAR),
    "from_hex": (_from_hex, T.VARBINARY),
    "to_base64": (lambda s: __import__("base64").b64encode(
        s.encode("latin-1", errors="replace")).decode(), T.VARCHAR),
    "from_base64": (lambda s: __import__("base64").b64decode(s)
                    .decode("latin-1"), T.VARBINARY),
    "url_encode": (lambda s: __import__("urllib.parse", fromlist=["quote"])
                   .quote(s, safe=""), T.VARCHAR),
    "url_decode": (lambda s: __import__("urllib.parse",
                                        fromlist=["unquote"]).unquote(s),
                   T.VARCHAR),
    "url_extract_host": (_url_part("host"), T.VARCHAR),
    "url_extract_protocol": (_url_part("protocol"), T.VARCHAR),
    "url_extract_path": (_url_part("path"), T.VARCHAR),
    "url_extract_query": (_url_part("query"), T.VARCHAR),
    "url_extract_fragment": (_url_part("fragment"), T.VARCHAR),
    "url_extract_port": (_url_part("port"), T.BIGINT),
    "url_extract_parameter": (_url_extract_parameter, T.VARCHAR),
    # approx_distinct finalize: HLL sketch payload -> estimate
    "$hll_cardinality": (lambda s: __import__(
        "presto_tpu_torch.sketch", fromlist=["hll_cardinality"])
        .hll_cardinality(s), T.BIGINT),
}


# ---------------------------------------------------------------------------
# Math / datetime
# ---------------------------------------------------------------------------

def _resolve_math(name: str, args: Tuple[T.Type, ...]) -> Optional[Scalar]:
    a = args[0]
    if name == "abs":
        return Scalar(name, args, a, "array", lambda xp, x: xp.abs(x))
    if name in ("ceil", "ceiling", "floor"):
        fn = "ceil" if name != "floor" else "floor"
        if isinstance(a, T.DecimalType):
            f = _pow10(a.scale)
            out = T.DecimalType("decimal", a.precision - a.scale + 1, 0)
            if fn == "ceil":
                return Scalar(name, args, out, "array",
                              lambda xp, x: -xp.floor_divide(-x, f))
            return Scalar(name, args, out, "array",
                          lambda xp, x: xp.floor_divide(x, f))
        if T.is_integral(a):
            return Scalar(name, args, a, "array", lambda xp, x: x)
        return Scalar(name, args, a, "array",
                      getattr(_XpOps, fn))
    if name == "round":
        d = 0
        if len(args) == 2:
            # second arg must be a constant integer; the compiler folds it
            # into the closure via resolve_round_digits
            raise FunctionError("round(x, d) requires constant d; "
                                "use resolve_round(digits=...)")
        return resolve_round(a, d)
    if name == "sqrt":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.sqrt(_as_double(xp, x, a)))
    if name in ("ln", "log"):
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.log(_as_double(xp, x, a)))
    if name == "exp":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.exp(_as_double(xp, x, a)))
    if name == "power" or name == "pow":
        b = args[1]
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x, y: xp.power(_as_double(xp, x, a),
                                                _as_double(xp, y, b)))
    if name == "mod":
        return _resolve_arith("modulus", args[0], args[1])
    if name == "sign":
        return Scalar(name, args, a, "array", lambda xp, x: xp.sign(x))
    if name in _TRIG:
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: getattr(xp, name)(_as_double(xp, x, a)))
    if name == "atan2" and len(args) == 2:
        b = args[1]
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x, y: xp.arctan2(_as_double(xp, x, a),
                                                  _as_double(xp, y, b)))
    if name in ("asin", "acos", "atan"):
        np_name = {"asin": "arcsin", "acos": "arccos", "atan": "arctan"}[name]
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: getattr(xp, np_name)(_as_double(xp, x, a)))
    if name == "degrees":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.degrees(_as_double(xp, x, a)))
    if name == "radians":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.radians(_as_double(xp, x, a)))
    if name == "cbrt":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.cbrt(_as_double(xp, x, a)))
    if name == "log10":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.log10(_as_double(xp, x, a)))
    if name == "log2":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.log2(_as_double(xp, x, a)))
    if name == "log" and len(args) == 2:
        b = args[1]
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x, y: xp.log(_as_double(xp, y, b))
                      / xp.log(_as_double(xp, x, a)))
    if name == "truncate":
        if isinstance(a, T.DecimalType):
            f = _pow10(a.scale)
            return Scalar(name, args, a, "array",
                          lambda xp, x: _trunc_div(xp, x, f) * f)
        if T.is_integral(a):
            return Scalar(name, args, a, "array", lambda xp, x: x)
        return Scalar(name, args, a, "array", lambda xp, x: xp.trunc(x))
    if name == "is_nan" and _is_float(a):
        return Scalar(name, args, T.BOOLEAN, "array",
                      lambda xp, x: xp.isnan(x))
    if name == "is_infinite" and _is_float(a):
        return Scalar(name, args, T.BOOLEAN, "array",
                      lambda xp, x: xp.isinf(x))
    if name == "is_finite" and _is_float(a):
        return Scalar(name, args, T.BOOLEAN, "array",
                      lambda xp, x: xp.isfinite(x))
    if name in ("greatest", "least") and len(args) >= 1:
        pick = "maximum" if name == "greatest" else "minimum"
        out = args[0]
        for x in args[1:]:
            if x.name in _NUMERIC_ORDER and out.name in _NUMERIC_ORDER:
                out = x if (_NUMERIC_ORDER.index(x.name)
                            > _NUMERIC_ORDER.index(out.name)) else out
            elif x != out:
                raise FunctionError(f"{name} over mixed types")
        factors = [_coerce_factor(t, out) for t in args]

        def impl(xp, *vals):
            acc = _apply_factor(xp, vals[0], factors[0], out)
            for v, f in zip(vals[1:], factors[1:]):
                acc = getattr(xp, pick)(acc, _apply_factor(xp, v, f, out))
            return acc

        return Scalar(name, args, out, "array", impl)
    if name in ("bitwise_and", "bitwise_or", "bitwise_xor") \
            and len(args) == 2:
        op = {"bitwise_and": "bitwise_and", "bitwise_or": "bitwise_or",
              "bitwise_xor": "bitwise_xor"}[name]
        return Scalar(name, args, T.BIGINT, "array",
                      lambda xp, x, y: getattr(xp, op)(
                          xp.astype(x, "int64"), xp.astype(y, "int64")))
    if name == "bitwise_not":
        return Scalar(name, args, T.BIGINT, "array",
                      lambda xp, x: ~xp.astype(x, "int64"))
    return None


_TRIG = {"sin", "cos", "tan", "sinh", "cosh", "tanh"}
_NUMERIC_ORDER = ["tinyint", "smallint", "integer", "bigint", "real",
                  "double"]


def _coerce_factor(src: T.Type, dst: T.Type):
    """How to bring src-typed storage into dst's domain (None = astype)."""
    if _is_float(dst) and not _is_float(src):
        return _to_float_factor(src)
    return None


def _apply_factor(xp, x, factor, out: T.Type):
    if _is_float(out):
        if factor is not None:
            return xp.astype(x, out.np_dtype) / factor
        return xp.astype(x, out.np_dtype)
    return xp.astype(x, out.np_dtype)


class _XpOps:
    @staticmethod
    def ceil(xp, x):
        return xp.ceil(x)

    @staticmethod
    def floor(xp, x):
        return xp.floor(x)


def _as_double(xp, x, t: T.Type):
    f = _to_float_factor(t)
    if f is not None:
        return xp.astype(x, "float64") / f
    return xp.astype(x, "float64")


def resolve_round(a: T.Type, digits: int = 0) -> Scalar:
    s = _resolve_round(a, digits)
    s.re_key = ("round", a, digits)
    return s


def _resolve_round(a: T.Type, digits: int = 0) -> Scalar:
    """round(x [, d]) with half-away-from-zero semantics (Presto MathFunctions)."""
    if T.is_integral(a) and digits >= 0:
        return Scalar("round", (a,), a, "array", lambda xp, x: x)
    if isinstance(a, T.DecimalType):
        if digits >= a.scale:
            return Scalar("round", (a,), a, "array", lambda xp, x: x)
        f = _pow10(a.scale - digits)
        out = T.DecimalType("decimal", a.precision, a.scale)

        def impl(xp, x):
            return _round_half_up_div(xp, x, f) * f

        return Scalar("round", (a,), out, "array", impl)
    f = float(_pow10(abs(digits)))
    scale = f if digits >= 0 else 1.0 / f

    def impl(xp, x):
        return xp.sign(x) * xp.floor(xp.abs(x) * scale + 0.5) / scale

    return Scalar("round", (a,), a, "array", impl)


def _resolve_datetime(name: str, args: Tuple[T.Type, ...]) -> Optional[Scalar]:
    a = args[0]
    fields = ("year", "month", "day", "quarter", "week", "day_of_week",
              "day_of_year")
    if name in fields or (name.startswith("extract_") and name[8:] in fields):
        field = name[8:] if name.startswith("extract_") else name
        if a.name == "timestamp":
            return Scalar(name, args, T.BIGINT, "array",
                          lambda xp, x: xp.asarray(datemath.extract_field(
                              xp, xp.floor_divide(x, 86_400_000_000), field),
                              dtype="int64"))
        return Scalar(name, args, T.BIGINT, "array",
                      lambda xp, x: xp.asarray(
                          datemath.extract_field(xp, xp.astype(x, "int64"), field),
                          dtype="int64"))
    if name == "add_days":
        return Scalar(name, args, a, "array",
                      lambda xp, x, n: xp.astype((x + n), a.np_dtype))
    if name == "add_months":
        return Scalar(name, args, a, "array",
                      lambda xp, x, n: xp.astype(datemath.add_months(
                          xp, xp.astype(x, "int64"), n), a.np_dtype))
    US_DAY = 86_400_000_000
    time_fields = {"hour": (3_600_000_000, 24),
                   "minute": (60_000_000, 60),
                   "second": (1_000_000, 60)}
    if name in time_fields or (name.startswith("extract_")
                               and name[8:] in time_fields):
        field = name[8:] if name.startswith("extract_") else name
        unit_us, modulo = time_fields[field]
        if a.name != "timestamp":
            return Scalar(name, args, T.BIGINT, "array",
                          lambda xp, x: xp.zeros_like(x, dtype="int64"))
        return Scalar(name, args, T.BIGINT, "array",
                      lambda xp, x: xp.astype(xp.mod(
                          xp.floor_divide(x, unit_us), modulo), "int64"))
    if name.startswith("date_trunc_"):
        unit = name[len("date_trunc_"):]
        is_ts = a.name == "timestamp"

        def trunc_days(xp, days):
            if unit == "day":
                return days
            if unit == "week":  # ISO week starts Monday
                dow = datemath.extract_field(xp, days, "day_of_week")
                return days - (dow - 1)
            y, m, _ = datemath.civil_from_days(xp, days)
            if unit == "month":
                return datemath.days_from_civil(xp, y, m, xp.asarray(1))
            if unit == "quarter":
                qm = ((m - 1) // 3) * 3 + 1
                return datemath.days_from_civil(xp, y, qm, xp.asarray(1))
            if unit == "year":
                return datemath.days_from_civil(
                    xp, y, xp.asarray(1), xp.asarray(1))
            raise FunctionError(f"date_trunc unit {unit!r}")

        if not is_ts:
            return Scalar(name, args, a, "array",
                          lambda xp, x: xp.astype(trunc_days(xp, xp.astype(x, "int64")), a.np_dtype))
        sub_day = {"second": 1_000_000, "minute": 60_000_000,
                   "hour": 3_600_000_000, "day": US_DAY}
        if unit in sub_day:
            u = sub_day[unit]
            return Scalar(name, args, a, "array",
                          lambda xp, x: xp.floor_divide(x, u) * u)
        return Scalar(name, args, a, "array",
                      lambda xp, x: trunc_days(
                          xp, xp.floor_divide(x, US_DAY)) * US_DAY)
    if name.startswith("date_diff_"):
        unit = name[len("date_diff_"):]
        b = args[1]

        def to_us(xp, x, t):
            return (xp.astype(x, "int64") * US_DAY if t.name == "date"
                    else xp.astype(x, "int64"))

        unit_us = {"second": 1_000_000, "minute": 60_000_000,
                   "hour": 3_600_000_000, "day": US_DAY,
                   "week": US_DAY * 7}
        if unit in unit_us:
            u = unit_us[unit]
            return Scalar(name, args, T.BIGINT, "array",
                          lambda xp, x, y: _trunc_div(
                              xp, to_us(xp, y, b) - to_us(xp, x, a), u))
        if unit in ("month", "quarter", "year"):
            div = {"month": 1, "quarter": 3, "year": 12}[unit]

            def impl(xp, x, y):
                d1 = xp.floor_divide(to_us(xp, x, a), US_DAY)
                d2 = xp.floor_divide(to_us(xp, y, b), US_DAY)
                y1, m1, _ = datemath.civil_from_days(xp, d1)
                y2, m2, _ = datemath.civil_from_days(xp, d2)
                months = (y2 * 12 + (m2 - 1)) - (y1 * 12 + (m1 - 1))
                return _trunc_div(xp, xp.astype(months, "int64"), div)

            return Scalar(name, args, T.BIGINT, "array", impl)
        raise FunctionError(f"date_diff unit {unit!r}")
    if name == "from_unixtime":
        return Scalar(name, args, T.TIMESTAMP, "array",
                      lambda xp, x: xp.astype((_as_double(xp, x, a) * 1e6), "int64"))
    if name == "to_unixtime":
        return Scalar(name, args, T.DOUBLE, "array",
                      lambda xp, x: xp.astype(x, "float64") / 1e6)
    if name == "last_day_of_month":
        is_ts = a.name == "timestamp"

        def impl(xp, x):
            days = (xp.floor_divide(x, US_DAY) if is_ts
                    else xp.astype(x, "int64"))
            nxt = datemath.add_months(xp, days, 1)
            y, m, _ = datemath.civil_from_days(xp, nxt)
            first = datemath.days_from_civil(xp, y, m, xp.asarray(1))
            return xp.astype((first - 1), "int32")

        return Scalar(name, args, T.DATE, "array", impl)
    return None


# ---------------------------------------------------------------------------
# Casts
# ---------------------------------------------------------------------------

def resolve_cast(src: T.Type, dst: T.Type) -> Scalar:
    s = _resolve_cast(src, dst)
    s.re_key = ("cast", src, dst)
    return s


def resolve_try_cast(src: T.Type, dst: T.Type) -> Scalar:
    """TRY_CAST: NULL instead of an error on conversion failure (the
    reference's TryCastFunction).  Only string-parsing casts can fail;
    device-side numeric casts are total."""
    s = _resolve_cast(src, dst)
    if s.kind == "string":
        inner = s.impl

        def safe(*args):
            try:
                return inner(*args)
            except Exception:  # noqa: BLE001 - conversion failure -> NULL
                return None

        s = Scalar(s.name, s.arg_types, s.result_type, "string", safe,
                   null_mode=s.null_mode)
    s.re_key = ("try_cast", src, dst)
    return s


def _resolve_cast(src: T.Type, dst: T.Type) -> Scalar:
    if isinstance(src, T.UnknownType) and T.is_nested(dst):
        # NULL literal as a nested type: an all-null nested column
        def null_impl(args, valids, n, xp):
            import numpy as np

            from presto_tpu_torch.batch import empty_column

            return empty_column(dst).pad(n), np.zeros(n, bool)

        return Scalar("cast", (src,), dst, "nested", null_impl,
                      null_mode="custom")
    if src == dst or isinstance(src, T.UnknownType):
        return Scalar("cast", (src,), dst, "array", lambda xp, x: x)
    if T.is_string(src):
        if T.is_string(dst):
            if isinstance(dst, T.CharType) or isinstance(dst, T.VarcharType) \
                    and dst.length is not None:
                ln = dst.length
                return Scalar("cast", (src,), dst, "string",
                              lambda s: s[:ln])
            return Scalar("cast", (src,), dst, "string", lambda s: s)
        if dst.name == "date":
            return Scalar("cast", (src,), dst, "string",
                          lambda s: T.DATE.from_python(s.strip()))
        if dst.name == "timestamp":
            return Scalar("cast", (src,), dst, "string",
                          lambda s: T.TIMESTAMP.from_python(s.strip()))
        if T.is_numeric(dst):
            conv = dst.from_python if isinstance(dst, T.DecimalType) else (
                float if _is_float(dst) else int)
            return Scalar("cast", (src,), dst, "string", lambda s: conv(s.strip()))
        if dst.name == "boolean":
            return Scalar("cast", (src,), dst, "string",
                          lambda s: s.strip().lower() in ("true", "t", "1"))
    if T.is_numeric(src) and T.is_numeric(dst):
        return _numeric_cast(src, dst)
    if src.name == "date" and dst.name == "timestamp":
        return Scalar("cast", (src,), dst, "array",
                      lambda xp, x: xp.astype(x, "int64") * 86_400_000_000)
    if src.name == "timestamp" and dst.name == "date":
        return Scalar("cast", (src,), dst, "array",
                      lambda xp, x: xp.astype(xp.floor_divide(x, 86_400_000_000), "int32"))
    if src.name == "boolean" and T.is_numeric(dst):
        inner = _numeric_cast(T.TINYINT, dst)
        return Scalar("cast", (src,), dst, "array",
                      lambda xp, x: inner.impl(xp, xp.astype(x, "int8")))
    if T.is_string(dst) and (T.is_numeric(src) or src.name in
                             ("date", "timestamp", "boolean")):
        # value -> string is unbounded-cardinality: runs host-side, interning
        # into a per-call-site append-only dictionary (stable codes), via
        # the nested-call machinery (compile.py routes off-device)
        return _cast_to_string(src, dst)
    if isinstance(src, T.ArrayType) and isinstance(dst, T.ArrayType):
        inner = resolve_cast(src.element, dst.element)
        return _cast_array(src, dst, inner)
    raise FunctionError(f"cannot cast {src.display()} to {dst.display()}")


def _format_value(src: T.Type):
    """Storage value -> Presto cast-to-varchar text."""
    if T.is_integral(src):
        return lambda v: str(int(v))
    if src.name in ("double", "real"):
        def fmt(v):
            f = float(v)
            if f != f:
                return "NaN"
            if f in (float("inf"), float("-inf")):
                return "Infinity" if f > 0 else "-Infinity"
            if f == int(f) and abs(f) < 1e16:
                return f"{int(f)}.0"       # Java Double.toString style
            return repr(f)
        return fmt
    if isinstance(src, T.DecimalType):
        scale = src.scale

        def fmt_dec(v):
            import decimal

            return str(decimal.Decimal(int(v)).scaleb(-scale))
        return fmt_dec
    if src.name == "date":
        return lambda v: T.DATE.to_python(v).isoformat()
    if src.name == "timestamp":
        def fmt_ts(v):
            dt = T.TIMESTAMP.to_python(v)
            return dt.strftime("%Y-%m-%d %H:%M:%S.") \
                + f"{dt.microsecond // 1000:03d}"
        return fmt_ts
    if src.name == "boolean":
        return lambda v: "true" if v else "false"
    raise FunctionError(f"cannot format {src.display()}")


def _cast_to_string(src: T.Type, dst: T.Type) -> Scalar:
    import numpy as np

    from presto_tpu_torch.batch import Column, Dictionary

    fmt = _format_value(src)
    out_dict = Dictionary()
    ln = getattr(dst, "length", None)

    def impl(args, valids, n, xp):
        vals = np.broadcast_to(np.asarray(args[0]), (n,))
        valid = valids[0]
        live = np.ones(n, bool) if valid is None else np.asarray(valid)
        codes = np.fromiter(
            (out_dict.intern(fmt(v)[:ln] if ln else fmt(v)) if ok
             else 0 for v, ok in zip(vals, live)),
            dtype=np.int32, count=n)
        return Column(dst, codes, None, out_dict), valid

    return Scalar("cast", (src,), dst, "nested", impl, null_mode="custom")


def _cast_array(src: T.Type, dst: T.Type, inner: Scalar) -> Scalar:
    import numpy as np

    from presto_tpu_torch.batch import Column

    def impl(args, valids, n, xp):
        col = args[0]
        kid = col.children[0]
        total = kid.values.shape[0]
        if inner.kind == "array":
            vals = inner.impl(np, np.asarray(kid.values))
            new_kid = Column(dst.element, np.asarray(vals), kid.valid)
        elif inner.kind == "nested":
            kvalid = None if kid.valid is None else np.asarray(kid.valid)
            v, kv = inner.impl([kid.values], [kvalid], total, np)
            new_kid = v if isinstance(v, Column) else Column(
                dst.element, np.asarray(v), kv)
            if isinstance(v, Column) and kv is not None:
                new_kid = Column(v.type, v.values, kv, v.dictionary,
                                 v.children)
        else:
            raise FunctionError(
                f"cannot cast {src.display()} to {dst.display()}")
        return Column(dst, col.values, None, None, (new_kid,)), valids[0]

    return Scalar("cast", (src,), dst, "nested", impl, null_mode="custom")


def _numeric_cast(src: T.Type, dst: T.Type) -> Scalar:
    sf = _to_float_factor(src)
    if _is_float(dst):
        return Scalar("cast", (src,), dst, "array",
                      lambda xp, x: _f(xp, x, sf, dst))
    if isinstance(dst, T.DecimalType):
        if isinstance(src, T.DecimalType):
            if dst.scale >= src.scale:
                f = _pow10(dst.scale - src.scale)
                return Scalar("cast", (src,), dst, "array", lambda xp, x: x * f)
            f = _pow10(src.scale - dst.scale)
            return Scalar("cast", (src,), dst, "array",
                          lambda xp, x: _round_half_up_div(xp, x, f))
        if T.is_integral(src):
            f = _pow10(dst.scale)
            return Scalar("cast", (src,), dst, "array",
                          lambda xp, x: xp.astype(x, "int64") * f)
        f = float(_pow10(dst.scale))
        return Scalar("cast", (src,), dst, "array",
                      lambda xp, x: xp.astype((xp.sign(x) * xp.floor(xp.abs(x) * f + 0.5)), "int64"))
    if T.is_integral(dst):
        dt = dst.np_dtype
        if T.is_integral(src):
            return Scalar("cast", (src,), dst, "array",
                          lambda xp, x: xp.astype(x, dt))
        if isinstance(src, T.DecimalType):
            f = _pow10(src.scale)
            return Scalar("cast", (src,), dst, "array",
                          lambda xp, x: xp.astype(_round_half_up_div(xp, x, f), dt))
        return Scalar("cast", (src,), dst, "array",
                      lambda xp, x: xp.astype((xp.sign(x) * xp.floor(xp.abs(x) + 0.5)), dt))
    raise FunctionError(f"cannot cast {src.display()} to {dst.display()}")


# ---------------------------------------------------------------------------
# Array / map / row functions (implementations in expr/arrayfns.py)
# ---------------------------------------------------------------------------

def _nested(name, args, rt, impl, **extra) -> Scalar:
    s = Scalar(name, tuple(args), rt, "nested", impl, null_mode="custom")
    for k, v in extra.items():
        setattr(s, k, v)
    return s


def _device_nested(name, args, rt, impl) -> Scalar:
    """An array/map/row function of ``expr/arrayfns.py``: it runs on the
    batch's device (compile.py ``_nested_call``)."""
    return _nested(name, args, rt, impl, on_device=True)


def _not_ported_nested(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"array/map function {name}: ROADMAP A6b ports the rest of the "
        "array and map functions and the lambdas")


def _resolve_nested(name: str, args: Tuple[T.Type, ...]) -> Optional[Scalar]:
    """Array/map/row function resolution (ArrayFunctions / MapFunctions,
    presto-main/.../operator/scalar/).  The functions of this slice
    resolve to ``expr/arrayfns.py``; the rest of the reference's library
    and the lambda functions raise ``NotImplementedError`` naming A6b
    where the reference would resolve them.  Lambda argument positions
    carry the lambda BODY's result type in ``args``."""
    from presto_tpu_torch.expr import arrayfns as A

    a0 = args[0] if args else None
    arr0 = a0 if isinstance(a0, T.ArrayType) else None
    map0 = a0 if isinstance(a0, T.MapType) else None

    if name == "hash64":
        for t_ in args:
            check_flat_key(t_)
    if name == "cardinality" and (arr0 or map0):
        return _device_nested(name, args, T.BIGINT, A.cardinality)
    if name in ("element_at", "subscript"):
        if arr0:
            return _device_nested(name, args, arr0.element,
                                  A.array_subscript)
        if map0:
            return _device_nested(name, args, map0.value, A.map_subscript)
    if name == "contains" and arr0:
        return _device_nested(name, args, T.BOOLEAN, A.contains)
    if name == "array_position" and arr0:
        return _device_nested(name, args, T.BIGINT, A.array_position)
    if name == "array_min" and arr0:
        return _device_nested(name, args, arr0.element, A.array_min)
    if name == "array_max" and arr0:
        return _device_nested(name, args, arr0.element, A.array_max)
    if name == "split" and args and T.is_string(args[0]):
        rt = T.ArrayType("array", element=T.VARCHAR)
        return _device_nested(name, args, rt, A.split_fn(rt))
    if name == "map" and len(args) == 2 and arr0 \
            and isinstance(args[1], T.ArrayType):
        rt = T.MapType("map", key=arr0.element, value=args[1].element)
        return _device_nested(name, args, rt, A.map_from_arrays(rt))
    if name == "$rows_map_agg" and arr0:
        k, v = arr0.element.field_types
        rt = T.MapType("map", key=k, value=v)
        return _device_nested(name, args, rt, A.rows_map(rt))
    if name in ("$rows_min_by", "$rows_max_by") and arr0:
        x, _y = arr0.element.field_types
        mode = name[len("$rows_"):]     # min_by | max_by
        return _device_nested(name, args, x, A.rows_extreme_by(mode))
    if name in ("$rows_corr", "$rows_covar_samp", "$rows_covar_pop",
                "$rows_regr_slope", "$rows_regr_intercept") and arr0:
        stat = name[len("$rows_"):]
        return _device_nested(name, args, T.DOUBLE, A.rows_statistic(stat))
    if name in ("$rows_learn_classifier", "$rows_learn_regressor") \
            and arr0:
        raise NotImplementedError(
            f"{name[len('$rows_'):]}: ROADMAP A10 ports the ml functions")
    # the reference's other array/map functions and the lambda functions
    # (its _resolve_nested conditions): ROADMAP A6b
    if (name in ("array_distinct", "reverse", "array_join", "slice",
                 "array_remove", "array_intersect", "array_union",
                 "array_except", "arrays_overlap", "zip_with",
                 "array_average", "transform", "filter", "any_match",
                 "all_match", "none_match") and arr0) \
            or (name == "array_sort" and arr0 and len(args) == 1) \
            or (name in ("concat", "array_concat") and arr0) \
            or (name == "flatten" and arr0
                and isinstance(arr0.element, T.ArrayType)) \
            or (name == "repeat" and len(args) == 2) \
            or (name == "sequence" and args and T.is_integral(args[0])) \
            or (name == "zip" and arr0 and all(
                isinstance(t_, T.ArrayType) for t_ in args)) \
            or (name == "map_from_entries" and arr0
                and isinstance(arr0.element, T.RowType)
                and len(arr0.element.field_types) == 2) \
            or (name == "reduce" and arr0 and len(args) == 4) \
            or (name in ("map_keys", "map_values", "map_entries",
                         "map_concat", "map_filter", "transform_values",
                         "transform_keys") and map0):
        raise _not_ported_nested(name)
    return None


_MYSQL_TO_STRFTIME = {
    "Y": "%Y", "y": "%y", "m": "%m", "c": "%-m", "d": "%d", "e": "%-d",
    "H": "%H", "h": "%I", "I": "%I", "i": "%M", "s": "%S", "S": "%S",
    "f": "%f", "p": "%p", "W": "%A", "a": "%a", "b": "%b", "M": "%B",
    "j": "%j", "T": "%H:%M:%S", "%": "%%",
}


def _mysql_format_to_strftime(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            out.append(_MYSQL_TO_STRFTIME.get(spec, spec))
            i += 2
        else:
            out.append(ch.replace("%", "%%"))
            i += 1
    return "".join(out)


def resolve_date_format(src: T.Type, fmt: str) -> Scalar:
    """date_format(ts, '%Y-%m') — MySQL specifiers
    (MySqlDateTimeFunctions in the reference's DateTimeFunctions.java)."""
    import numpy as np

    from presto_tpu_torch.batch import Column, Dictionary

    strf = _mysql_format_to_strftime(fmt)
    out_dict = Dictionary()
    to_py = T.TIMESTAMP.to_python if src.name == "timestamp" \
        else T.DATE.to_python

    def impl(args, valids, n, xp):
        vals = np.broadcast_to(np.asarray(args[0]), (n,))
        valid = valids[0]
        live = np.ones(n, bool) if valid is None else np.asarray(valid)
        cache = {}
        codes = np.zeros(n, np.int32)
        for i in range(n):
            if not live[i]:
                continue
            v = int(vals[i])
            code = cache.get(v)
            if code is None:
                code = cache[v] = out_dict.intern(to_py(v).strftime(strf))
            codes[i] = code
        return Column(T.VARCHAR, codes, None, out_dict), valid

    s = Scalar("date_format", (src, T.VARCHAR), T.VARCHAR, "nested", impl,
               null_mode="custom")
    s.re_key = ("date_format", src, fmt)
    return s


_JODA_TOKENS = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"), ("MMM", "%b"),
    ("MM", "%m"), ("M", "%-m"), ("dd", "%d"), ("d", "%-d"), ("EEEE", "%A"),
    ("EEE", "%a"), ("HH", "%H"), ("H", "%-H"), ("hh", "%I"), ("h", "%-I"),
    ("mm", "%M"), ("m", "%-M"), ("ss", "%S"), ("s", "%-S"), ("a", "%p"),
]


def _joda_to_strftime(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "'":                  # quoted literal
            j = fmt.index("'", i + 1) if "'" in fmt[i + 1:] else len(fmt)
            out.append(fmt[i + 1:j].replace("%", "%%"))
            i = j + 1
            continue
        for tok, rep in _JODA_TOKENS:
            if fmt.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            out.append(fmt[i].replace("%", "%%"))
            i += 1
    return "".join(out)


def resolve_format_datetime(src: T.Type, fmt: str) -> Scalar:
    """format_datetime(ts, 'yyyy-MM-dd') — Joda patterns
    (DateTimeFunctions.formatDatetime in the reference)."""
    import numpy as np

    from presto_tpu_torch.batch import Column, Dictionary

    strf = _joda_to_strftime(fmt)
    out_dict = Dictionary()
    to_py = T.TIMESTAMP.to_python if src.name == "timestamp" \
        else T.DATE.to_python

    def impl(args, valids, n, xp):
        vals = np.broadcast_to(np.asarray(args[0]), (n,))
        valid = valids[0]
        live = np.ones(n, bool) if valid is None else np.asarray(valid)
        cache = {}
        codes = np.zeros(n, np.int32)
        for i in range(n):
            if not live[i]:
                continue
            v = int(vals[i])
            code = cache.get(v)
            if code is None:
                code = cache[v] = out_dict.intern(to_py(v).strftime(strf))
            codes[i] = code
        return Column(T.VARCHAR, codes, None, out_dict), valid

    s = Scalar("format_datetime", (src, T.VARCHAR), T.VARCHAR, "nested",
               impl, null_mode="custom")
    s.re_key = ("format_datetime", src, fmt)
    return s


def resolve_array_percentile(arr: T.ArrayType, p: float) -> Scalar:
    raise _not_ported_nested("array_percentile")


def resolve_kll_percentile(result_type: T.Type, p: float) -> Scalar:
    """approx_percentile finalize: serialized KLL sketch -> quantile in
    the aggregate's result type."""
    def impl(payload: str):
        from presto_tpu_torch.sketch import KllSketch

        v = KllSketch.deserialize(payload).quantile(p)
        if v is None:
            return None
        if T.is_integral(result_type):
            return int(round(v))
        if isinstance(result_type, T.DecimalType):
            import decimal

            return decimal.Decimal(repr(float(v)))
        return float(v)

    s = Scalar("$kll_percentile", (T.VARBINARY,), result_type, "string",
               impl)
    s.re_key = ("kll_percentile", result_type, p)
    return s


def resolve_array_constructor(rt: T.ArrayType, k: int) -> Scalar:
    from presto_tpu_torch.expr import arrayfns as A

    s = _device_nested("$array", (rt.element,) * k, rt,
                       A.array_constructor(rt, k))
    s.re_key = ("array_ctor", rt, k)
    return s


def resolve_row_field(row: T.RowType, field: str) -> Tuple[Scalar, int]:
    """ROW field dereference (``r.name``): returns (scalar, field index)."""
    names = [n.lower() for n in row.field_names]
    if field.lower() not in names:
        raise FunctionError(f"row has no field {field!r}: {row.display()}")
    i = names.index(field.lower())
    return resolve_row_field_index(row, i), i


def resolve_row_field_index(row: T.RowType, i: int) -> Scalar:
    from presto_tpu_torch.expr import arrayfns as A

    s = _device_nested("row_field", (row,), row.field_types[i],
                       A.row_field(i))
    s.re_key = ("row_field", row, i)
    return s


def resolve_row_constructor(field_types: Sequence[T.Type]) -> Scalar:
    from presto_tpu_torch.expr import arrayfns as A

    rt = T.RowType("row",
                   field_names=tuple(f"field{i}"
                                     for i in range(len(field_types))),
                   field_types=tuple(field_types))
    s = _device_nested("row", tuple(field_types), rt,
                       A.row_constructor(rt))
    s.re_key = ("row", tuple(field_types))
    return s


# ---------------------------------------------------------------------------
# Top-level scalar resolution
# ---------------------------------------------------------------------------

_ARITH = {"add", "subtract", "multiply", "divide", "modulus"}


def resolve_scalar(name: str, arg_types: Sequence[T.Type]) -> Scalar:
    name = name.lower()
    args = tuple(arg_types)
    if name == "row":
        return resolve_row_constructor(list(args))
    if any(T.is_nested(t) for t in args) or name in (
            "repeat", "sequence") or (
            name == "split" and args and T.is_string(args[0])):
        nested = _resolve_nested(name, args)
        if nested is not None:
            return nested
        if any(T.is_nested(t) for t in args) and name not in (
                "is_null", "is_not_null"):  # type-agnostic tests fall through
            raise FunctionError(
                f"unknown function {name}("
                f"{', '.join(t.display() for t in args)})")
    if name in _ARITH and len(args) == 2:
        return _resolve_arith(name, args[0], args[1])
    if name == "negate":
        a = args[0]
        return Scalar(name, args, a, "array", lambda xp, x: -x)
    if name in _CMP and len(args) == 2:
        return _resolve_cmp(name, args[0], args[1])
    if name == "not":
        return Scalar(name, args, T.BOOLEAN, "array", lambda xp, x: ~x)
    if name == "is_null":
        return Scalar(name, args, T.BOOLEAN, "array", None, null_mode="is_null")
    if name == "is_not_null":
        return Scalar(name, args, T.BOOLEAN, "array", None,
                      null_mode="is_not_null")
    if name in _STRING_FNS:
        impl, out = _STRING_FNS[name]
        if not args[0].is_dictionary and name not in ("concat", "chr"):
            raise FunctionError(f"{name} expects a string argument")
        return Scalar(name, args, out, "string", impl)
    m = _resolve_math(name, args)
    if m is not None:
        return m
    d = _resolve_datetime(name, args)
    if d is not None:
        return d
    if name == "width_bucket" and len(args) == 4:
        def _wb(xp, x, lo, hi, n):
            xf = xp.astype(x, "float64")
            lof = xp.astype(lo, "float64")
            hif = xp.astype(hi, "float64")
            nf = xp.astype(n, "int64")
            frac = (xf - lof) / xp.where(hif != lof, hif - lof, 1.0)
            b = xp.astype(xp.floor(frac * xp.astype(nf, "float64")), "int64") + 1
            return xp.minimum(xp.maximum(b, 0), nf + 1)

        return Scalar(name, args, T.BIGINT, "array", _wb)
    if name == "bit_count" and len(args) == 2:
        def _bc(xp, x, bits):
            # int64 with logical shifts (no uint64 tensors): the low
            # ``bits`` bits of x's two's-complement word, counted
            v = xp.astype(x, "int64")
            nb = xp.astype(bits, "int64")
            keep = xp.where(nb >= 64, -1, (1 << xp.minimum(nb, 63)) - 1)
            v = v & keep
            count = xp.zeros_like(v)
            for shift in range(64):
                count = count + ((v >> shift) & 1)
            return count

        return Scalar(name, args, T.BIGINT, "array", _bc)
    if name == "normalize" and args and T.is_string(args[0]):
        import unicodedata

        return Scalar(name, args, T.VARCHAR, "string",
                      lambda s, form="NFC": unicodedata.normalize(
                          form.upper() if isinstance(form, str) else "NFC",
                          s))
    if name == "hash64":  # internal: partitioning/join hashing
        return Scalar(name, args, T.BIGINT, "array", None, null_mode="hash64")
    if name.startswith("st_") or name.startswith("bing_tile"):
        g = _resolve_geo(name, args)
        if g is not None:
            return g
    ml = _resolve_ml_scalar(name, args)
    if ml is not None:
        return ml
    td = _resolve_teradata(name, args)
    if td is not None:
        return td
    raise FunctionError(
        f"unknown function {name}({', '.join(t.display() for t in args)})")


def _resolve_ml_scalar(name: str, args) -> Optional[Scalar]:
    """classify/regress/features scalars (presto-ml): not in this
    package yet."""
    if name in ("features", "classify", "regress"):
        raise NotImplementedError(
            f"{name}: ROADMAP A10 ports the ml functions")
    return None


def _resolve_teradata(name: str, args) -> Optional[Scalar]:
    """Teradata-compatibility functions (presto-teradata-functions role:
    index/char2hexint/to_char/to_date/to_timestamp)."""
    if name == "index" and len(args) == 2:
        # index(string, substring) == strpos
        impl, out = _STRING_FNS["strpos"]
        return Scalar(name, tuple(args), out, "string", impl)
    if name == "char2hexint" and len(args) == 1:
        def c2h(s: str) -> str:
            return "".join(f"{b:02X}"
                           for b in s.encode("utf-16-be"))

        return Scalar(name, tuple(args), T.VARCHAR, "string", c2h)
    if name == "to_char" and len(args) >= 1:
        ty = args[0]

        def to_char(v, fmt=None) -> str:
            # the constant-fold path hands storage-domain values
            # (epoch days / scaled ints); lift them to python domain
            if isinstance(ty, (T.DateType, T.TimestampType,
                               T.DecimalType)) and isinstance(v, int):
                v = ty.to_python(v)
            if fmt is not None:
                return _td_format(v, fmt)
            return str(v)

        return Scalar(name, tuple(args), T.VARCHAR, "string", to_char)
    if name in ("to_date", "to_timestamp") and len(args) == 2:
        import datetime as _dt

        want_ts = name == "to_timestamp"
        out = T.TIMESTAMP if want_ts else T.DATE

        def to_date(s: str, fmt: str):
            pyfmt = _td_strftime(fmt)
            dt = _dt.datetime.strptime(s, pyfmt)
            # non-string results travel in storage domain (epoch
            # days / micros) through the string-call machinery
            return out.from_python(dt if want_ts else dt.date())

        return Scalar(name, tuple(args), out, "string", to_date)
    return None


def _td_strftime(fmt: str) -> str:
    """Teradata datetime format -> strftime (yyyy-mm-dd hh24:mi:ss)."""
    out = fmt
    for src, dst in (("yyyy", "%Y"), ("yy", "%y"), ("mm", "%m"),
                     ("dd", "%d"), ("hh24", "%H"), ("hh", "%I"),
                     ("mi", "%M"), ("ss", "%S")):
        out = out.replace(src, dst).replace(src.upper(), dst)
    return out


def _td_format(v, fmt: str) -> str:
    import datetime as _dt

    if isinstance(v, (_dt.date, _dt.datetime)):
        return v.strftime(_td_strftime(fmt))
    return str(v)


def _resolve_geo(name: str, args) -> Optional[Scalar]:
    """Geospatial scalars (presto-geospatial): not in this package yet."""
    raise NotImplementedError(
        f"{name}: ROADMAP A10 ports the geospatial functions")


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AggSpec:
    """An aggregate decomposed into primitive device reductions.

    ``components`` lists (prim, component_result_type) pairs where prim in
    {'sum','count','min','max'} — the only reductions kernels implement
    (segment-reduce friendly).  avg/stddev/variance are decomposed by the
    planner using ``finalize`` metadata, mirroring the reference's
    partial/final Step split (HashAggregationOperator.Step:61) where the
    partial side emits component states.
    """

    name: str
    arg_type: Optional[T.Type]
    result_type: T.Type
    components: List[Tuple[str, T.Type]]
    # 'identity' | 'avg' | 'stddev_samp' | 'stddev_pop' | 'var_samp' | 'var_pop'
    finalize: str = "identity"


def resolve_aggregate(name: str, arg_type: Optional[T.Type]) -> AggSpec:
    name = name.lower()
    if name in ("count", "count_star"):
        if arg_type is None or name == "count_star":
            return AggSpec("count_star", None, T.BIGINT,
                           [("count", T.BIGINT)])
        return AggSpec("count", arg_type, T.BIGINT, [("count", T.BIGINT)])
    if arg_type is None:
        raise FunctionError(f"{name} requires an argument")
    if name == "sum":
        if T.is_integral(arg_type):
            return AggSpec("sum", arg_type, T.BIGINT, [("sum", T.BIGINT)])
        if isinstance(arg_type, T.DecimalType):
            out = T.DecimalType("decimal", 38, arg_type.scale)
            return AggSpec("sum", arg_type, out, [("sum", out)])
        if _is_float(arg_type):
            return AggSpec("sum", arg_type, T.DOUBLE, [("sum", T.DOUBLE)])
        raise FunctionError(f"sum({arg_type.display()})")
    if name in ("min", "max", "any_value", "arbitrary", "approx_percentile"):
        check_flat_key(arg_type)
    if name in ("min", "max"):
        return AggSpec(name, arg_type, arg_type, [(name, arg_type)])
    if name == "avg":
        if isinstance(arg_type, T.DecimalType):
            out = T.DecimalType("decimal", 38, arg_type.scale)
            return AggSpec("avg", arg_type, out,
                           [("sum", out), ("count", T.BIGINT)], finalize="avg")
        return AggSpec("avg", arg_type, T.DOUBLE,
                       [("sum", T.DOUBLE), ("count", T.BIGINT)], finalize="avg")
    if name in ("stddev", "stddev_samp", "stddev_pop", "variance", "var_samp",
                "var_pop"):
        canon = {"stddev": "stddev_samp", "variance": "var_samp"}.get(name, name)
        return AggSpec(canon, arg_type, T.DOUBLE,
                       [("sum", T.DOUBLE), ("sumsq", T.DOUBLE),
                        ("count", T.BIGINT)], finalize=canon)
    if name == "approx_distinct":
        return AggSpec("approx_distinct", arg_type, T.BIGINT,
                       [("hll", T.VARBINARY)], finalize="approx_distinct")
    if name == "approx_percentile":
        # percentile is patched onto finalize by the planner (constant
        # arg).  State is a mergeable KLL sketch (bounded memory,
        # exchange-friendly — QuantileDigestAggregationFunction role),
        # not a collect-everything array.
        return AggSpec("approx_percentile", arg_type, arg_type,
                       [("kll", T.VARBINARY)],
                       finalize="approx_percentile:0.5")
    if name in ("corr", "covar_samp", "covar_pop", "regr_slope",
                "regr_intercept"):
        if not isinstance(arg_type, T.RowType) \
                or len(arg_type.field_types) != 2:
            raise FunctionError(f"{name}(y, x)")
        comp = T.ArrayType("array", element=arg_type)
        return AggSpec(name, arg_type, T.DOUBLE, [("collect", comp)],
                       finalize=name)
    if name == "geometric_mean":
        return AggSpec("geometric_mean", arg_type, T.DOUBLE,
                       [("sumln", T.DOUBLE), ("count", T.BIGINT)],
                       finalize="geometric_mean")
    if name == "checksum":
        # order-independent: wrapping sum of per-value 64-bit hashes
        # (the reference's CHECKSUM_AGGREGATION xor/sum style)
        return AggSpec("checksum", arg_type, T.BIGINT,
                       [("sumhash", T.BIGINT)])
    if name == "array_agg":
        out = T.ArrayType("array", element=arg_type)
        return AggSpec("array_agg", arg_type, out, [("collect", out)])
    if name == "map_agg":
        # planner packs (k, v) into row(k, v); finalize builds the map
        if not isinstance(arg_type, T.RowType) \
                or len(arg_type.field_types) != 2:
            raise FunctionError("map_agg(key, value)")
        k, v = arg_type.field_types
        out = T.MapType("map", key=k, value=v)
        comp = T.ArrayType("array", element=arg_type)
        return AggSpec("map_agg", arg_type, out, [("collect", comp)],
                       finalize="map_agg")
    if name in ("min_by", "max_by"):
        # planner packs (x, y) into row(x, y); finalize picks x at extreme y
        if not isinstance(arg_type, T.RowType) \
                or len(arg_type.field_types) != 2:
            raise FunctionError(f"{name}(x, y)")
        x, _y = arg_type.field_types
        comp = T.ArrayType("array", element=arg_type)
        return AggSpec(name, arg_type, x, [("collect", comp)],
                       finalize=name)
    if name in ("any_value", "arbitrary"):
        return AggSpec("any_value", arg_type, arg_type, [("max", arg_type)])
    if name in ("bool_and", "every"):
        return AggSpec("bool_and", arg_type, T.BOOLEAN, [("min", T.BOOLEAN)])
    if name == "bool_or":
        return AggSpec("bool_or", arg_type, T.BOOLEAN, [("max", T.BOOLEAN)])
    if name == "count_if":
        return AggSpec("count_if", arg_type, T.BIGINT, [("sum", T.BIGINT)])
    if name in ("learn_classifier", "learn_regressor"):
        # planner packs (label, features_json) into row(...); finalize
        # trains and emits the model JSON (presto-ml aggregations role)
        if not isinstance(arg_type, T.RowType) \
                or len(arg_type.field_types) != 2:
            raise FunctionError(f"{name}(label, features)")
        comp = T.ArrayType("array", element=arg_type)
        return AggSpec(name, arg_type, T.VARCHAR, [("collect", comp)],
                       finalize=name)
    raise FunctionError(f"unknown aggregate {name}")


# ---------------------------------------------------------------------------
# Function inventory (SHOW FUNCTIONS / FunctionRegistry listing role)
# ---------------------------------------------------------------------------

# Names not discoverable from the dispatch tables above (math/datetime/
# array/map/lambda functions resolve in code).  Curated to match what
# resolve_scalar/arrayfns actually accept.
_EXTRA_SCALARS = (
    "abs", "ceil", "ceiling", "floor", "round", "sqrt", "exp", "ln",
    "log", "log2", "log10", "pow", "power", "mod", "sign", "cbrt",
    "degrees", "radians", "pi", "e", "random", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
    "greatest", "least", "width_bucket", "bit_count", "normalize",
    "year", "quarter", "month", "week", "day", "day_of_week",
    "day_of_year", "hour", "minute", "second", "date_trunc", "date_add",
    "date_diff", "date_format", "date_parse", "format_datetime",
    "from_unixtime", "to_unixtime", "now", "current_date",
    "current_timestamp", "localtimestamp",
    "cardinality", "element_at", "array_distinct", "array_position",
    "array_sort", "array_max", "array_min", "array_sum", "array_join",
    "array_remove", "array_intersect", "array_union", "array_except",
    "arrays_overlap", "contains", "filter", "transform", "reduce",
    "slice", "flatten", "repeat", "sequence", "zip", "zip_with",
    "map_keys", "map_values", "map_entries", "map_filter",
    "map_concat", "map_from_entries", "transform_keys",
    "transform_values", "split", "try_cast", "typeof", "position",
    "coalesce", "nullif", "if", "try", "concat_ws", "to_hex",
    "from_hex", "to_base64", "from_base64", "md5", "sha1", "sha256",
    "xxhash64", "crc32", "url_extract_host", "url_extract_path",
    "url_extract_query", "url_extract_protocol", "url_extract_port",
    "url_encode", "url_decode", "uuid", "format",
    # geospatial (expr/geo.py)
    "st_point", "st_geometryfromtext", "st_astext", "st_x", "st_y",
    "st_area", "st_length", "st_perimeter", "st_centroid",
    "st_envelope", "st_buffer", "st_contains", "st_within",
    "st_intersects", "st_distance", "st_isvalid", "st_geometrytype",
    "st_numpoints", "bing_tile_at", "bing_tile_quadkey",
    "bing_tile_zoom_level", "bing_tile_polygon",
    "bing_tile_coordinates_x", "bing_tile_coordinates_y",
    # ml scalars (expr/ml.py) and teradata compatibility
    "features", "classify", "regress",
    "index", "char2hexint", "to_char", "to_date", "to_timestamp",
)

_AGGREGATE_NAMES = (
    "count", "sum", "min", "max", "avg", "stddev", "stddev_pop",
    "stddev_samp", "variance", "var_pop", "var_samp", "corr",
    "covar_pop", "covar_samp", "regr_slope", "regr_intercept",
    "approx_distinct", "approx_percentile", "bool_and", "bool_or",
    "count_if", "every", "array_agg", "map_agg", "min_by", "max_by",
    "checksum", "geometric_mean", "arbitrary",
    "learn_classifier", "learn_regressor",
)

_WINDOW_NAMES = (
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "lag", "lead", "first_value", "last_value", "nth_value",
)


def function_names():
    """(name, kind) inventory for SHOW FUNCTIONS; kind in
    scalar|aggregate|window."""
    # _ARITH/_CMP hold internal operator dispatch names (add/eq/...) that
    # SQL spells as operators, not callable functions — excluded here
    scalars = {n for n in (set(_STRING_FNS) | set(_EXTRA_SCALARS))
               if not n.startswith("$")}
    out = [(n, "scalar") for n in scalars]
    out += [(n, "aggregate") for n in _AGGREGATE_NAMES]
    out += [(n, "window") for n in _WINDOW_NAMES]
    return sorted(out)
