"""SQL type system.

The reference binds each logical SQL type to a physical JVM representation
and Block read/write methods (presto-spi/.../type/Type.java:28, 62 type
files).  Here each logical type binds to a *device* representation instead:

logical type      device representation
-------------     -----------------------------------------------------------
BOOLEAN           bool_
TINYINT..BIGINT   int8/int16/int32/int64
REAL / DOUBLE     float32 / float64
DECIMAL(p, s)     int64 scaled by 10**s (the reference's "short decimal",
                  presto-spi/.../type/DecimalType.java; long decimals are
                  carried in int64 too — see class docstring)
DATE              int32 days since 1970-01-01
TIMESTAMP         int64 microseconds since epoch
VARCHAR / CHAR    int32 codes into a host-side dictionary (strings never
                  live on device; low-cardinality string ops are computed
                  host-side over the dictionary and gathered on device)
VARBINARY         like VARCHAR
UNKNOWN           the type of a bare NULL literal

Null handling is *external* to the value arrays: every column carries an
optional validity mask (batch.py), mirroring Block.isNull
(presto-spi/.../block/Block.java:25).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

__all__ = [
    "Type", "BOOLEAN", "TINYINT", "SMALLINT", "INTEGER", "BIGINT", "REAL",
    "DOUBLE", "DATE", "TIMESTAMP", "UNKNOWN", "DecimalType", "VarcharType",
    "CharType", "VarbinaryType", "VARCHAR", "VARBINARY", "parse_type",
    "common_super_type", "is_numeric", "is_integral", "is_string",
    "ArrayType", "MapType", "RowType", "NestedType", "is_nested",
]


@dataclasses.dataclass(frozen=True)
class Type:
    """A logical SQL type bound to a device dtype.

    ``np_dtype`` is the dtype of the device value array.  ``is_dictionary``
    marks types whose device values are dictionary codes rather than the
    value itself.
    """

    name: str

    @property
    def np_dtype(self) -> np.dtype:
        raise NotImplementedError

    @property
    def is_dictionary(self) -> bool:
        return False

    @property
    def is_orderable(self) -> bool:
        return True

    @property
    def is_comparable(self) -> bool:
        return True

    @property
    def is_nested(self) -> bool:
        return False

    def display(self) -> str:
        return self.name

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.display()

    # -- host <-> storage conversion ------------------------------------
    def to_python(self, storage_value: Any) -> Any:
        """Convert one storage-domain value into its Python/SQL value."""
        return storage_value

    def from_python(self, value: Any) -> Any:
        """Convert one Python/SQL value into its storage-domain value."""
        return value


@dataclasses.dataclass(frozen=True)
class _Fixed(Type):
    dtype_name: str = ""

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype_name)


@dataclasses.dataclass(frozen=True)
class _Integer(_Fixed):
    def to_python(self, storage_value):
        return int(storage_value)


@dataclasses.dataclass(frozen=True)
class _Float(_Fixed):
    def to_python(self, storage_value):
        return float(storage_value)


@dataclasses.dataclass(frozen=True)
class BooleanType(_Fixed):
    def to_python(self, storage_value):
        return bool(storage_value)


@dataclasses.dataclass(frozen=True)
class DateType(_Fixed):
    """Days since epoch, int32 (reference: DateType over int days)."""

    def to_python(self, storage_value):
        import datetime

        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(storage_value))

    def from_python(self, value) -> int:
        import datetime

        if isinstance(value, str):
            try:
                value = datetime.date.fromisoformat(value)
            except ValueError:
                # lenient y-m-d (DATE '2002-2-01' appears in standard
                # TPC-DS query text)
                y, m, d = (int(p) for p in value.strip().split("-"))
                value = datetime.date(y, m, d)
        if isinstance(value, datetime.date):
            return (value - datetime.date(1970, 1, 1)).days
        return int(value)


@dataclasses.dataclass(frozen=True)
class TimestampType(_Fixed):
    """Microseconds since epoch, int64."""

    def to_python(self, storage_value):
        import datetime

        return datetime.datetime(1970, 1, 1) + datetime.timedelta(
            microseconds=int(storage_value)
        )

    def from_python(self, value) -> int:
        import datetime

        if isinstance(value, str):
            value = datetime.datetime.fromisoformat(value)
        if isinstance(value, datetime.datetime):
            return int((value - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
        return int(value)


@dataclasses.dataclass(frozen=True)
class DecimalType(Type):
    """DECIMAL(precision, scale) over scaled int64.

    The reference stores precision<=18 in a long and wider decimals in a
    two-slice Int128 (presto-spi/.../type/DecimalType.java,
    Int128ArrayBlock).  On TPU, int64 covers every value TPC-H/TPC-DS style
    workloads produce even when the *declared* precision exceeds 18 (the
    declared precision tracks worst-case digits, not actual magnitude), so
    the engine carries all decimals in int64 and relies on the planner's
    precision bookkeeping only for result typing.  int128 emulation can be
    layered under the same logical type later without changing callers.
    """

    precision: int = 38
    scale: int = 0

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int64")

    def display(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def to_python(self, storage_value):
        import decimal

        return decimal.Decimal(int(storage_value)).scaleb(-self.scale)

    def from_python(self, value) -> int:
        import decimal

        d = decimal.Decimal(str(value)).scaleb(self.scale)
        return int(d.to_integral_value(rounding=decimal.ROUND_HALF_UP))


@dataclasses.dataclass(frozen=True)
class _DictionaryType(Type):
    """Base for host-dictionary-encoded types (VARCHAR/CHAR/VARBINARY)."""

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int32")

    @property
    def is_dictionary(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class VarcharType(_DictionaryType):
    length: Optional[int] = None  # None == unbounded

    def display(self) -> str:
        return "varchar" if self.length is None else f"varchar({self.length})"


@dataclasses.dataclass(frozen=True)
class CharType(_DictionaryType):
    length: int = 1

    def display(self) -> str:
        return f"char({self.length})"


@dataclasses.dataclass(frozen=True)
class VarbinaryType(_DictionaryType):
    @property
    def is_orderable(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class UnknownType(Type):
    """Type of a bare NULL literal; coerces to anything."""

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int8")


@dataclasses.dataclass(frozen=True)
class NestedType(Type):
    """Base for container types (ARRAY/MAP/ROW).

    The reference's nested blocks (ArrayBlock/MapBlock/RowBlock,
    presto-spi/.../block/) store flattened child blocks plus per-row
    offsets.  Here the column's ``values`` array holds int32 offsets
    (length n+1) into flattened child columns (batch.py Column.children);
    the flattened children are ordinary columns, so device compute (lambda
    transforms, UNNEST projections) runs on the flat child arrays while
    offsets stay host-side.
    """

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int32")  # offsets

    @property
    def is_nested(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class ArrayType(NestedType):
    element: "Type" = None  # type: ignore[assignment]

    def display(self) -> str:
        return f"array({self.element.display()})"

    @property
    def is_orderable(self) -> bool:
        return self.element.is_orderable

    @property
    def is_comparable(self) -> bool:
        return self.element.is_comparable


@dataclasses.dataclass(frozen=True)
class MapType(NestedType):
    key: "Type" = None    # type: ignore[assignment]
    value: "Type" = None  # type: ignore[assignment]

    def display(self) -> str:
        return f"map({self.key.display()},{self.value.display()})"

    @property
    def is_orderable(self) -> bool:
        return False

    @property
    def is_comparable(self) -> bool:
        return self.key.is_comparable and self.value.is_comparable


@dataclasses.dataclass(frozen=True)
class RowType(NestedType):
    """ROW(name type, ...); anonymous fields get field0, field1, ...

    Unlike ARRAY/MAP there are no offsets: children are row-aligned, and
    ``values`` is a placeholder.
    """

    field_names: Tuple[str, ...] = ()
    field_types: Tuple["Type", ...] = ()

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype("int8")  # placeholder values

    def display(self) -> str:
        inner = ", ".join(f"{n} {t.display()}"
                          for n, t in zip(self.field_names, self.field_types))
        return f"row({inner})"

    @property
    def is_orderable(self) -> bool:
        return all(t.is_orderable for t in self.field_types)

    @property
    def is_comparable(self) -> bool:
        return all(t.is_comparable for t in self.field_types)


BOOLEAN = BooleanType("boolean", "bool_")
TINYINT = _Integer("tinyint", "int8")
SMALLINT = _Integer("smallint", "int16")
INTEGER = _Integer("integer", "int32")
BIGINT = _Integer("bigint", "int64")
REAL = _Float("real", "float32")
DOUBLE = _Float("double", "float64")
DATE = DateType("date", "int32")
TIMESTAMP = TimestampType("timestamp", "int64")
VARCHAR = VarcharType("varchar")
VARBINARY = VarbinaryType("varbinary")
UNKNOWN = UnknownType("unknown")

_INTEGRAL = {"tinyint": 3, "smallint": 5, "integer": 10, "bigint": 19}


def is_integral(t: Type) -> bool:
    return t.name in _INTEGRAL


def is_numeric(t: Type) -> bool:
    return is_integral(t) or t.name in ("real", "double") or isinstance(t, DecimalType)


def is_string(t: Type) -> bool:
    return isinstance(t, (VarcharType, CharType))


def is_nested(t: Type) -> bool:
    return isinstance(t, NestedType)


def _integral_as_decimal(t: Type) -> DecimalType:
    return DecimalType("decimal", precision=_INTEGRAL[t.name], scale=0)


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Least common type for implicit coercion (the reference's
    TypeCoercion.getCommonSuperType role, presto-main/.../type/TypeCoercion.java)."""
    if a == b:
        return a
    if isinstance(a, UnknownType):
        return b
    if isinstance(b, UnknownType):
        return a
    order = ["tinyint", "smallint", "integer", "bigint"]
    if is_integral(a) and is_integral(b):
        return [t for t in (BIGINT, INTEGER, SMALLINT, TINYINT)
                if order.index(t.name) == max(order.index(a.name), order.index(b.name))][0]
    if a.name == "double" and is_numeric(b) or b.name == "double" and is_numeric(a):
        return DOUBLE
    if a.name == "real" and is_numeric(b) or b.name == "real" and is_numeric(a):
        if isinstance(a, DecimalType) or isinstance(b, DecimalType):
            return DOUBLE
        return REAL
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        da = a if isinstance(a, DecimalType) else _integral_as_decimal(a)
        db = b if isinstance(b, DecimalType) else _integral_as_decimal(b)
        scale = max(da.scale, db.scale)
        precision = max(da.precision - da.scale, db.precision - db.scale) + scale
        return DecimalType("decimal", precision=min(precision, 38), scale=scale)
    if is_string(a) and is_string(b):
        la = getattr(a, "length", None)
        lb = getattr(b, "length", None)
        if la is None or lb is None:
            return VARCHAR
        return VarcharType("varchar", length=max(la, lb))
    if {a.name, b.name} == {"date", "timestamp"}:
        return TIMESTAMP
    if isinstance(a, ArrayType) and isinstance(b, ArrayType):
        e = common_super_type(a.element, b.element)
        return None if e is None else ArrayType("array", element=e)
    if isinstance(a, MapType) and isinstance(b, MapType):
        k = common_super_type(a.key, b.key)
        v = common_super_type(a.value, b.value)
        if k is None or v is None:
            return None
        return MapType("map", key=k, value=v)
    if isinstance(a, RowType) and isinstance(b, RowType):
        if len(a.field_types) != len(b.field_types):
            return None
        fts = [common_super_type(x, y)
               for x, y in zip(a.field_types, b.field_types)]
        if any(t is None for t in fts):
            return None
        return RowType("row", field_names=a.field_names,
                       field_types=tuple(fts))
    return None


def _split_top_level(s: str) -> list:
    """Split on commas not inside parens."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(s[start:i])
            start = i + 1
    parts.append(s[start:])
    return [p.strip() for p in parts if p.strip()]


def parse_type(text: str) -> Type:
    """Parse a type name as it appears in SQL (``decimal(15,2)``,
    ``array(bigint)``, ``map(varchar, bigint)``, ``row(a bigint)``...)."""
    s = text.strip().lower()
    simple = {
        "boolean": BOOLEAN, "tinyint": TINYINT, "smallint": SMALLINT,
        "integer": INTEGER, "int": INTEGER, "bigint": BIGINT, "real": REAL,
        "double": DOUBLE, "double precision": DOUBLE, "date": DATE,
        "timestamp": TIMESTAMP, "varchar": VARCHAR, "varbinary": VARBINARY,
        "unknown": UNKNOWN, "string": VARCHAR,
    }
    if s in simple:
        return simple[s]
    if s.startswith("decimal"):
        inner = s[s.index("(") + 1 : s.rindex(")")] if "(" in s else "38,0"
        p, _, sc = inner.partition(",")
        return DecimalType("decimal", precision=int(p), scale=int(sc or 0))
    if s.startswith("varchar"):
        inner = s[s.index("(") + 1 : s.rindex(")")]
        return VarcharType("varchar", length=int(inner))
    if s.startswith("char"):
        inner = s[s.index("(") + 1 : s.rindex(")")] if "(" in s else "1"
        return CharType("char", length=int(inner))
    if s.startswith("array<"):
        return ArrayType("array", element=parse_type(s[6:s.rindex(">")]))
    if s.startswith("array") and "(" in s:
        inner = s[s.index("(") + 1 : s.rindex(")")]
        return ArrayType("array", element=parse_type(inner))
    if s.startswith("map") and "(" in s:
        inner = s[s.index("(") + 1 : s.rindex(")")]
        k, v = _split_top_level(inner)
        return MapType("map", key=parse_type(k), value=parse_type(v))
    if s.startswith("row") and "(" in s:
        inner = s[s.index("(") + 1 : s.rindex(")")]
        names, fts = [], []
        for i, part in enumerate(_split_top_level(inner)):
            # "name type" or bare "type"
            first, _, rest = part.partition(" ")
            try:
                t = parse_type(part)
                names.append(f"field{i}")
            except ValueError:
                t = parse_type(rest)
                names.append(first)
            fts.append(t)
        return RowType("row", field_names=tuple(names),
                       field_types=tuple(fts))
    raise ValueError(f"unknown type: {text!r}")
