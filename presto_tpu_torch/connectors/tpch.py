"""TPC-H data-generator connector.

Role model: presto-tpch (presto-tpch/.../TpchMetadata.java:91,
TpchPageSourceProvider.java:26) — the reference's keystone test/benchmark
fixture: deterministic generated data, zero IO, any scale (SURVEY §4.7).

Design differences from the reference (which wraps io.airlift.tpch, a java
dbgen port):

- **Counter-based generation.**  dbgen advances sequential per-column RNG
  streams, which forces split generation to "skip ahead".  Here every cell
  is a pure function ``value = f(splitmix64(table, column, key))`` of its
  row key, so any key range of any column generates independently, in
  vectorized numpy, with no stream state.  This matches how splits must
  behave on a multi-host TPU system: any host can generate any shard.
- **Column-lazy.**  Only requested columns are generated (the reference
  achieves the same via lazy blocks).
- **Strings are dictionary-encoded at birth** (types.VarcharType): enum-ish
  columns (shipmode, priority, ...) carry spec vocabularies; free-text
  comments draw from a capped pseudo-text space; per-row-distinct columns
  (c_name, phones) format their range on demand.

The data follows the TPC-H 4.3 value distributions (value ranges, date
windows, price formula, supplier-spread formula, 2/3-customer rule,
returnflag/linestatus/orderstatus derivation) so that the standard 22
queries produce representative selectivities.  It is not a byte-exact dbgen
clone; correctness testing diffs results against a SQL oracle over the SAME
generated data (SURVEY §4.2's H2-oracle pattern), so absolute dbgen parity
is not load-bearing.

Like the reference's connector, money columns are DOUBLE by default
(TpchMetadata's default column naming/typing) with an opt-in exact
``decimal`` mode, which maps to int64 on device — the TPU-native fast path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.connectors.api import (
    ColumnMetadata, Connector, PageSource, Split, TableHandle, TableSchema,
    TableStatistics,
)

# ---------------------------------------------------------------------------
# Deterministic counter-based randomness
# ---------------------------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (public-domain algorithm), vectorized."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def h64(stream: int, keys: np.ndarray) -> np.ndarray:
    """64 pseudo-random bits per key, independent per stream id."""
    k = np.asarray(keys, dtype=np.uint64)
    offset = np.uint64((stream * 0xD1B54A32D192ED03) & 0xFFFFFFFFFFFFFFFF)
    return _mix((k + np.uint64(1)) * _GOLDEN + offset)


def u_int(stream: int, keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform integer in [lo, hi] per key (int64)."""
    span = np.uint64(hi - lo + 1)
    return (h64(stream, keys) % span).astype(np.int64) + lo


# ---------------------------------------------------------------------------
# Spec vocabularies (TPC-H 4.3 §4.2.2-4.2.3)
# ---------------------------------------------------------------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# (name, regionkey) in nationkey order, per the spec's nation table.
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()

# Comment vocabulary: includes the marker words the standard queries grep
# for (Q13 '%special%requests%', Q16 '%Customer%Complaints%', Q20 like).
_COMMENT_WORDS = (
    "carefully bold final ironic regular express silent pending furious "
    "quickly blithely slyly fluffily even special unusual packages requests "
    "deposits accounts instructions theodolites dependencies foxes pinto "
    "beans asymptotes dolphins platelets sleep wake haggle nag use cajole "
    "engage detect integrate maintain print Customer Complaints Recommends "
    "among about above across after against along"
).split()

_TEXT_SPACE = 8192  # distinct comments per column (capped pseudo-text space)

DATE_LO = 8035     # 1992-01-01 as days since epoch
DATE_HI = 10591    # 1998-12-31
CURRENT_DATE = 9298  # 1995-06-17, the spec's "currentdate"


def _comment_dictionary(stream: int, min_words: int, max_words: int) -> Dictionary:
    """The capped pseudo-text space for one comment column."""
    n = _TEXT_SPACE
    counts = u_int(stream + 1, np.arange(n), min_words, max_words)
    total = int(counts.sum())
    word_ids = u_int(stream + 2, np.arange(total), 0, len(_COMMENT_WORDS) - 1)
    out: List[str] = []
    pos = 0
    for c in counts:
        out.append(" ".join(_COMMENT_WORDS[w] for w in word_ids[pos:pos + c]))
        pos += int(c)
    return Dictionary(out)


_COMMENT_CACHE: Dict[int, Dictionary] = {}


def _comments(stream: int, keys: np.ndarray) -> Column:
    d = _COMMENT_CACHE.get(stream)
    if d is None:
        d = _comment_dictionary(stream, 5, 11)
        _COMMENT_CACHE[stream] = d
    codes = (h64(stream, keys) % np.uint64(_TEXT_SPACE)).astype(np.int32)
    return Column(T.VARCHAR, codes, None, d)


_ENUM_CACHE: Dict[tuple, Dictionary] = {}


def _enum_column(stream: int, keys: np.ndarray, values: List[str]) -> Column:
    codes = (h64(stream, keys) % np.uint64(len(values))).astype(np.int32)
    # one Dictionary instance per enum domain: downstream kernel caches
    # key on dictionary identity, so a fresh object per scan would force
    # a re-trace of every string expression on every query
    d = _ENUM_CACHE.get(tuple(values))
    if d is None:
        d = _ENUM_CACHE.setdefault(tuple(values), Dictionary(values))
    return Column(T.VARCHAR, codes, None, d)


def _interned_dict(values: tuple) -> Dictionary:
    """One Dictionary instance per enum domain, process-wide.  Kernel
    caches (filter/project AND fused segments) key on the dictionary
    binding (token, length): a fresh Dictionary per generated batch gave
    every execution fresh tokens, forcing one full segment recompile per
    query — measured ~0.4 s of the 0.54 s warm SF0.05 Q1 engine wall."""
    d = _ENUM_CACHE.get(values)
    if d is None:
        d = _ENUM_CACHE.setdefault(values, Dictionary(list(values)))
    return d


def _fmt_column(prefix: str, keys: np.ndarray) -> Column:
    """Per-row-distinct formatted identifier column, e.g. Customer#000000001."""
    d = Dictionary([f"{prefix}#{int(k):09d}" for k in keys])
    return Column(T.VARCHAR, np.arange(len(keys), dtype=np.int32), None, d)


def _phone_column(stream: int, keys: np.ndarray, nationkey: np.ndarray) -> Column:
    a = u_int(stream + 1, keys, 100, 999)
    b = u_int(stream + 2, keys, 100, 999)
    c = u_int(stream + 3, keys, 1000, 9999)
    cc = nationkey + 10
    d = Dictionary([f"{int(cc[i]):02d}-{int(a[i])}-{int(b[i])}-{int(c[i])}"
                    for i in range(len(keys))])
    return Column(T.VARCHAR, np.arange(len(keys), dtype=np.int32), None, d)


def _address_column(stream: int, keys: np.ndarray) -> Column:
    return _comments(stream ^ 0x5555, keys)


def _money(values_cents: np.ndarray, money_type: T.Type) -> Column:
    if isinstance(money_type, T.DecimalType):
        return Column(money_type, values_cents.astype(np.int64))
    return Column(T.DOUBLE, values_cents.astype(np.float64) / 100.0)


def retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    """p_retailprice per the spec formula (TPC-H 4.3 §4.2.3), in cents."""
    p = partkey.astype(np.int64)
    return 90000 + (p // 10) % 20001 + 100 * (p % 1000)


# ---------------------------------------------------------------------------
# Table generators
# ---------------------------------------------------------------------------

# stream-id bases per table; column streams are base+i
_S_NATION, _S_REGION, _S_SUPP, _S_CUST, _S_PART, _S_PSUPP, _S_ORD, _S_LINE = (
    1000, 2000, 3000, 4000, 5000, 6000, 7000, 8000)


# Largest full-domain interning table the generator pre-builds for a
# per-row-distinct column (names, phones): above this, the host-string
# cost of the whole domain outweighs the per-split retrace it prevents
# and generation falls back to per-split dictionaries.
_SHARED_DICT_MAX = 1 << 20


class TpchGenerator:
    """Vectorized per-range column generation for all eight tables."""

    def __init__(self, scale: float = 1.0, money: str = "double"):
        import threading

        self.scale = scale
        self.money_type: T.Type = (
            T.DecimalType("decimal", 15, 2) if money == "decimal" else T.DOUBLE)
        self.n_supplier = max(int(10_000 * scale), 1)
        self.n_customer = max(int(150_000 * scale), 1)
        self.n_part = max(int(200_000 * scale), 1)
        self.n_orders = max(int(1_500_000 * scale), 1)
        self.n_clerks = max(int(1_000 * scale), 1)
        # per-(table, column) full-domain interning tables shared by
        # every split (stable (token, length) -> the unfused tier
        # compiles each expression once per table, not once per split)
        self._dict_cache: Dict[str, Dictionary] = {}
        self._dict_lock = threading.Lock()

    def _shared_dict(self, name: str, domain: int,
                     build) -> Optional[Dictionary]:
        """The full-domain dictionary for ``name``, built once under a
        lock (concurrent feed drivers race on first use); None when the
        domain is too large to pre-build."""
        if domain > _SHARED_DICT_MAX:
            return None
        d = self._dict_cache.get(name)
        if d is not None:
            return d
        with self._dict_lock:
            d = self._dict_cache.get(name)
            if d is None:
                d = Dictionary(build())
                self._dict_cache[name] = d
        return d

    def _fmt_shared(self, name: str, prefix: str, keys: np.ndarray,
                    lo: int, hi: int) -> Column:
        """Per-row-distinct formatted identifier over the table's full
        key domain: codes are ``key - lo`` so every split indexes one
        shared dictionary."""
        d = self._shared_dict(
            name, hi - lo,
            lambda: [f"{prefix}#{k:09d}" for k in range(lo, hi)])
        if d is None:
            return _fmt_column(prefix, keys)
        return Column(T.VARCHAR, (keys - lo).astype(np.int32), None, d)

    def _phone_shared(self, name: str, stream: int, nk_stream: int,
                      keys: np.ndarray, nationkey: np.ndarray,
                      lo: int, hi: int) -> Column:
        def build():
            ks = np.arange(lo, hi, dtype=np.int64)
            nk = u_int(nk_stream, ks, 0, 24)
            a = u_int(stream + 1, ks, 100, 999)
            b = u_int(stream + 2, ks, 100, 999)
            c = u_int(stream + 3, ks, 1000, 9999)
            cc = nk + 10
            return [f"{int(cc[i]):02d}-{int(a[i])}-{int(b[i])}-{int(c[i])}"
                    for i in range(len(ks))]

        d = self._shared_dict(name, hi - lo, build)
        if d is None:
            return _phone_column(stream, keys, nationkey)
        return Column(T.VARCHAR, (keys - lo).astype(np.int32), None, d)

    def _pname_column(self, keys: np.ndarray) -> Column:
        """P_NAME: five color words per part key (spec's P_NAME), over
        the table's full key domain so every split shares one
        dictionary."""
        def words(ks: np.ndarray) -> list:
            ids = [u_int(_S_PART + 10 + i, ks, 0, len(COLORS) - 1)
                   for i in range(5)]
            return [" ".join(COLORS[int(ids[i][j])] for i in range(5))
                    for j in range(len(ks))]

        d = self._shared_dict(
            "part:p_name", self.n_part,
            lambda: words(np.arange(1, self.n_part + 1, dtype=np.int64)))
        if d is None:
            return Column(T.VARCHAR,
                          np.arange(len(keys), dtype=np.int32), None,
                          Dictionary(words(keys)))
        return Column(T.VARCHAR, (keys - 1).astype(np.int32), None, d)

    # -- tiny fixed tables ----------------------------------------------
    def gen_region(self, columns: Sequence[str]) -> Batch:
        keys = np.arange(5, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "r_regionkey":
                cols.append(Column(T.BIGINT, keys))
            elif c == "r_name":
                cols.append(Column(T.VARCHAR, np.arange(5, dtype=np.int32),
                                   None, _interned_dict(tuple(REGIONS))))
            elif c == "r_comment":
                cols.append(_comments(_S_REGION + 2, keys))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), 5)

    def gen_nation(self, columns: Sequence[str]) -> Batch:
        keys = np.arange(25, dtype=np.int64)
        cols = []
        for c in columns:
            if c == "n_nationkey":
                cols.append(Column(T.BIGINT, keys))
            elif c == "n_name":
                cols.append(Column(T.VARCHAR, np.arange(25, dtype=np.int32),
                                   None, _interned_dict(
                                       tuple(n for n, _ in NATIONS))))
            elif c == "n_regionkey":
                cols.append(Column(
                    T.BIGINT, np.array([r for _, r in NATIONS], dtype=np.int64)))
            elif c == "n_comment":
                cols.append(_comments(_S_NATION + 3, keys))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), 25)

    # -- entity tables ---------------------------------------------------
    def gen_supplier(self, columns: Sequence[str], lo: int, hi: int) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)  # s_suppkey, 1-based
        nationkey = u_int(_S_SUPP + 3, keys, 0, 24)
        cols = []
        for c in columns:
            if c == "s_suppkey":
                cols.append(Column(T.BIGINT, keys))
            elif c == "s_name":
                cols.append(self._fmt_shared("supplier:s_name", "Supplier",
                                             keys, 1, self.n_supplier + 1))
            elif c == "s_address":
                cols.append(_address_column(_S_SUPP + 2, keys))
            elif c == "s_nationkey":
                cols.append(Column(T.BIGINT, nationkey))
            elif c == "s_phone":
                cols.append(self._phone_shared(
                    "supplier:s_phone", _S_SUPP + 4, _S_SUPP + 3, keys,
                    nationkey, 1, self.n_supplier + 1))
            elif c == "s_acctbal":
                cols.append(_money(u_int(_S_SUPP + 5, keys, -99_999, 999_999),
                                   self.money_type))
            elif c == "s_comment":
                cols.append(_comments(_S_SUPP + 6, keys))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), hi - lo)

    def gen_customer(self, columns: Sequence[str], lo: int, hi: int) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)  # c_custkey
        nationkey = u_int(_S_CUST + 3, keys, 0, 24)
        cols = []
        for c in columns:
            if c == "c_custkey":
                cols.append(Column(T.BIGINT, keys))
            elif c == "c_name":
                cols.append(self._fmt_shared("customer:c_name", "Customer",
                                             keys, 1, self.n_customer + 1))
            elif c == "c_address":
                cols.append(_address_column(_S_CUST + 2, keys))
            elif c == "c_nationkey":
                cols.append(Column(T.BIGINT, nationkey))
            elif c == "c_phone":
                cols.append(self._phone_shared(
                    "customer:c_phone", _S_CUST + 4, _S_CUST + 3, keys,
                    nationkey, 1, self.n_customer + 1))
            elif c == "c_acctbal":
                cols.append(_money(u_int(_S_CUST + 5, keys, -99_999, 999_999),
                                   self.money_type))
            elif c == "c_mktsegment":
                cols.append(_enum_column(_S_CUST + 6, keys, SEGMENTS))
            elif c == "c_comment":
                cols.append(_comments(_S_CUST + 7, keys))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), hi - lo)

    def gen_part(self, columns: Sequence[str], lo: int, hi: int) -> Batch:
        keys = np.arange(lo, hi, dtype=np.int64)  # p_partkey
        cols = []
        for c in columns:
            if c == "p_partkey":
                cols.append(Column(T.BIGINT, keys))
            elif c == "p_name":
                cols.append(self._pname_column(keys))
            elif c == "p_mfgr":
                m = u_int(_S_PART + 2, keys, 1, 5)
                d = _interned_dict(tuple(
                    f"Manufacturer#{i}" for i in range(1, 6)))
                cols.append(Column(T.VARCHAR, (m - 1).astype(np.int32), None, d))
            elif c == "p_brand":
                # brand = mfgr*10 + 1..5 (spec ties brand to mfgr)
                m = u_int(_S_PART + 2, keys, 1, 5)
                n = u_int(_S_PART + 3, keys, 1, 5)
                code = ((m - 1) * 5 + (n - 1)).astype(np.int32)
                d = _interned_dict(tuple(
                    f"Brand#{i}{j}" for i in range(1, 6)
                    for j in range(1, 6)))
                cols.append(Column(T.VARCHAR, code, None, d))
            elif c == "p_type":
                t = u_int(_S_PART + 4, keys, 0,
                          len(TYPE_S1) * len(TYPE_S2) * len(TYPE_S3) - 1)
                d = _interned_dict(tuple(
                    f"{a} {b} {c2}" for a in TYPE_S1
                    for b in TYPE_S2 for c2 in TYPE_S3))
                cols.append(Column(T.VARCHAR, t.astype(np.int32), None, d))
            elif c == "p_size":
                cols.append(Column(T.BIGINT, u_int(_S_PART + 5, keys, 1, 50)))
            elif c == "p_container":
                t = u_int(_S_PART + 6, keys, 0,
                          len(CONTAINER_S1) * len(CONTAINER_S2) - 1)
                d = _interned_dict(tuple(
                    f"{a} {b}" for a in CONTAINER_S1
                    for b in CONTAINER_S2))
                cols.append(Column(T.VARCHAR, t.astype(np.int32), None, d))
            elif c == "p_retailprice":
                cols.append(_money(retail_price_cents(keys), self.money_type))
            elif c == "p_comment":
                cols.append(_comments(_S_PART + 8, keys))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), hi - lo)

    def _psupp_suppkey(self, partkey: np.ndarray, i: np.ndarray) -> np.ndarray:
        """Supplier-spread formula (TPC-H 4.3 §4.2.3 shape): the i-th of 4
        suppliers for a part, scattered across the supplier space.  Unlike
        dbgen's exact formula this guarantees 4 *distinct* suppliers at any
        scale (i*(S//4) < S for i<4), which the spec requires and tiny test
        scales would otherwise violate."""
        s = self.n_supplier
        return (partkey + i * max(s // 4, 1)) % s + 1

    def gen_partsupp(self, columns: Sequence[str], lo: int, hi: int) -> Batch:
        """Range is over partkeys; each part contributes 4 rows."""
        pk = np.repeat(np.arange(lo, hi, dtype=np.int64), 4)
        i = np.tile(np.arange(4, dtype=np.int64), hi - lo)
        rowkey = pk * 4 + i
        cols = []
        for c in columns:
            if c == "ps_partkey":
                cols.append(Column(T.BIGINT, pk))
            elif c == "ps_suppkey":
                cols.append(Column(T.BIGINT, self._psupp_suppkey(pk, i)))
            elif c == "ps_availqty":
                cols.append(Column(T.BIGINT, u_int(_S_PSUPP + 3, rowkey, 1, 9999)))
            elif c == "ps_supplycost":
                cols.append(_money(u_int(_S_PSUPP + 4, rowkey, 100, 100_000),
                                   self.money_type))
            elif c == "ps_comment":
                cols.append(_comments(_S_PSUPP + 5, rowkey))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(pk))

    # -- orders & lineitem ----------------------------------------------
    def _order_custkey(self, okey: np.ndarray) -> np.ndarray:
        """2/3-customer rule: orders reference only custkeys % 3 != 0."""
        m = (self.n_customer // 3) * 2
        u = h64(_S_ORD + 2, okey) % np.uint64(max(m, 1))
        u = u.astype(np.int64)
        return u // 2 * 3 + u % 2 + 1

    def _order_date(self, okey: np.ndarray) -> np.ndarray:
        return u_int(_S_ORD + 5, okey, DATE_LO, DATE_HI - 151).astype(np.int32)

    def _line_counts(self, okey: np.ndarray) -> np.ndarray:
        return u_int(_S_LINE + 1, okey, 1, 7)

    def _line_parts(self, okey: np.ndarray, ln: np.ndarray):
        """Per-(order, linenumber) part/supplier/qty/discount/tax/dates."""
        rk = okey * 8 + ln  # row key for per-line streams
        partkey = u_int(_S_LINE + 2, rk, 1, self.n_part)
        supp_i = u_int(_S_LINE + 3, rk, 0, 3)
        suppkey = self._psupp_suppkey(partkey, supp_i)
        quantity = u_int(_S_LINE + 4, rk, 1, 50)
        discount = u_int(_S_LINE + 5, rk, 0, 10)   # cents-of-dollar (0.00-0.10)
        tax = u_int(_S_LINE + 6, rk, 0, 8)
        odate = self._order_date(okey)
        shipdate = odate + u_int(_S_LINE + 7, rk, 1, 121).astype(np.int32)
        commitdate = odate + u_int(_S_LINE + 8, rk, 30, 90).astype(np.int32)
        receiptdate = shipdate + u_int(_S_LINE + 9, rk, 1, 30).astype(np.int32)
        ext_cents = quantity * retail_price_cents(partkey)
        return (partkey, suppkey, quantity, discount, tax, shipdate,
                commitdate, receiptdate, ext_cents)

    def _order_totals(self, okey: np.ndarray):
        """o_totalprice (cents) and o_orderstatus derived from the order's
        lineitems, computed vectorized over the max-7 line slots."""
        counts = self._line_counts(okey)
        total = np.zeros(len(okey), dtype=np.int64)
        n_open = np.zeros(len(okey), dtype=np.int64)
        for line in range(1, 8):
            mask = counts >= line
            ln = np.full(len(okey), line, dtype=np.int64)
            (_, _, _, disc, tax, shipdate, _, _, ext) = self._line_parts(okey, ln)
            # extendedprice * (1 - discount) * (1 + tax), in cents
            line_total = ext * (100 - disc) * (100 + tax) // 10_000
            total += np.where(mask, line_total, 0)
            n_open += np.where(mask & (shipdate > CURRENT_DATE), 1, 0)
        status = np.where(n_open == 0, 0, np.where(n_open == counts, 1, 2))
        return total, status  # status codes into ["F", "O", "P"]

    def gen_orders(self, columns: Sequence[str], lo: int, hi: int) -> Batch:
        okey = np.arange(lo, hi, dtype=np.int64)
        cols = []
        totals = statuses = None
        for c in columns:
            if c == "o_orderkey":
                cols.append(Column(T.BIGINT, okey))
            elif c == "o_custkey":
                cols.append(Column(T.BIGINT, self._order_custkey(okey)))
            elif c == "o_orderstatus":
                if statuses is None:
                    totals, statuses = self._order_totals(okey)
                cols.append(Column(T.VARCHAR, statuses.astype(np.int32), None,
                                   _interned_dict(("F", "O", "P"))))
            elif c == "o_totalprice":
                if totals is None:
                    totals, statuses = self._order_totals(okey)
                cols.append(_money(totals, self.money_type))
            elif c == "o_orderdate":
                cols.append(Column(T.DATE, self._order_date(okey)))
            elif c == "o_orderpriority":
                cols.append(_enum_column(_S_ORD + 6, okey, PRIORITIES))
            elif c == "o_clerk":
                clerk = u_int(_S_ORD + 7, okey, 1, self.n_clerks)
                d = self._shared_dict(
                    "orders:o_clerk", self.n_clerks,
                    lambda: [f"Clerk#{i:09d}"
                             for i in range(1, self.n_clerks + 1)])
                if d is None:
                    d = Dictionary([f"Clerk#{i:09d}"
                                    for i in range(1, self.n_clerks + 1)])
                cols.append(Column(T.VARCHAR, (clerk - 1).astype(np.int32),
                                   None, d))
            elif c == "o_shippriority":
                cols.append(Column(T.BIGINT, np.zeros(hi - lo, dtype=np.int64)))
            elif c == "o_comment":
                cols.append(_comments(_S_ORD + 9, okey))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), hi - lo)

    def gen_lineitem(self, columns: Sequence[str], lo: int, hi: int) -> Batch:
        """Range is over ORDER keys; emits all lineitems of those orders."""
        okeys = np.arange(lo, hi, dtype=np.int64)
        counts = self._line_counts(okeys)
        okey = np.repeat(okeys, counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        ln = (np.arange(len(okey), dtype=np.int64)
              - np.repeat(offsets, counts) + 1)
        (partkey, suppkey, quantity, discount, tax, shipdate, commitdate,
         receiptdate, ext_cents) = self._line_parts(okey, ln)
        rk = okey * 8 + ln
        cols = []
        for c in columns:
            if c == "l_orderkey":
                cols.append(Column(T.BIGINT, okey))
            elif c == "l_partkey":
                cols.append(Column(T.BIGINT, partkey))
            elif c == "l_suppkey":
                cols.append(Column(T.BIGINT, suppkey))
            elif c == "l_linenumber":
                cols.append(Column(T.BIGINT, ln))
            elif c == "l_quantity":
                cols.append(Column(T.DOUBLE, quantity.astype(np.float64))
                            if not isinstance(self.money_type, T.DecimalType)
                            else Column(T.DecimalType("decimal", 12, 2),
                                        quantity * 100))
            elif c == "l_extendedprice":
                cols.append(_money(ext_cents, self.money_type))
            elif c == "l_discount":
                cols.append(Column(T.DOUBLE, discount.astype(np.float64) / 100.0)
                            if not isinstance(self.money_type, T.DecimalType)
                            else Column(T.DecimalType("decimal", 12, 2), discount))
            elif c == "l_tax":
                cols.append(Column(T.DOUBLE, tax.astype(np.float64) / 100.0)
                            if not isinstance(self.money_type, T.DecimalType)
                            else Column(T.DecimalType("decimal", 12, 2), tax))
            elif c == "l_returnflag":
                returned = receiptdate <= CURRENT_DATE
                coin = (h64(_S_LINE + 10, rk) & np.uint64(1)).astype(bool)
                code = np.where(returned, np.where(coin, 0, 1), 2).astype(np.int32)
                cols.append(Column(T.VARCHAR, code, None,
                                   _interned_dict(("R", "A", "N"))))
            elif c == "l_linestatus":
                code = (shipdate > CURRENT_DATE).astype(np.int32)
                cols.append(Column(T.VARCHAR, code, None,
                                   _interned_dict(("F", "O"))))
            elif c == "l_shipdate":
                cols.append(Column(T.DATE, shipdate.astype(np.int32)))
            elif c == "l_commitdate":
                cols.append(Column(T.DATE, commitdate.astype(np.int32)))
            elif c == "l_receiptdate":
                cols.append(Column(T.DATE, receiptdate.astype(np.int32)))
            elif c == "l_shipinstruct":
                cols.append(_enum_column(_S_LINE + 11, rk, INSTRUCTIONS))
            elif c == "l_shipmode":
                cols.append(_enum_column(_S_LINE + 12, rk, SHIP_MODES))
            elif c == "l_comment":
                cols.append(_comments(_S_LINE + 13, rk))
            else:
                raise KeyError(c)
        return Batch(tuple(cols), len(okey))


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def _schemas(money: T.Type, qty: T.Type) -> Dict[str, List[Tuple[str, T.Type]]]:
    V = T.VARCHAR
    return {
        "region": [("r_regionkey", T.BIGINT), ("r_name", V), ("r_comment", V)],
        "nation": [("n_nationkey", T.BIGINT), ("n_name", V),
                   ("n_regionkey", T.BIGINT), ("n_comment", V)],
        "supplier": [("s_suppkey", T.BIGINT), ("s_name", V), ("s_address", V),
                     ("s_nationkey", T.BIGINT), ("s_phone", V),
                     ("s_acctbal", money), ("s_comment", V)],
        "customer": [("c_custkey", T.BIGINT), ("c_name", V), ("c_address", V),
                     ("c_nationkey", T.BIGINT), ("c_phone", V),
                     ("c_acctbal", money), ("c_mktsegment", V),
                     ("c_comment", V)],
        "part": [("p_partkey", T.BIGINT), ("p_name", V), ("p_mfgr", V),
                 ("p_brand", V), ("p_type", V), ("p_size", T.BIGINT),
                 ("p_container", V), ("p_retailprice", money),
                 ("p_comment", V)],
        "partsupp": [("ps_partkey", T.BIGINT), ("ps_suppkey", T.BIGINT),
                     ("ps_availqty", T.BIGINT), ("ps_supplycost", money),
                     ("ps_comment", V)],
        "orders": [("o_orderkey", T.BIGINT), ("o_custkey", T.BIGINT),
                   ("o_orderstatus", V), ("o_totalprice", money),
                   ("o_orderdate", T.DATE), ("o_orderpriority", V),
                   ("o_clerk", V), ("o_shippriority", T.BIGINT),
                   ("o_comment", V)],
        "lineitem": [("l_orderkey", T.BIGINT), ("l_partkey", T.BIGINT),
                     ("l_suppkey", T.BIGINT), ("l_linenumber", T.BIGINT),
                     ("l_quantity", qty), ("l_extendedprice", money),
                     ("l_discount", qty), ("l_tax", qty),
                     ("l_returnflag", V), ("l_linestatus", V),
                     ("l_shipdate", T.DATE), ("l_commitdate", T.DATE),
                     ("l_receiptdate", T.DATE), ("l_shipinstruct", V),
                     ("l_shipmode", V), ("l_comment", V)],
    }


class _TpchPageSource(PageSource):
    def __init__(self, gen: TpchGenerator, table: str, columns: Sequence[str],
                 lo: int, hi: int, batch_rows: int):
        self.gen, self.table, self.columns = gen, table, list(columns)
        self.lo, self.hi, self.batch_rows = lo, hi, batch_rows

    def __iter__(self):
        if self.table in ("region", "nation"):
            gen = (self.gen.gen_region if self.table == "region"
                   else self.gen.gen_nation)
            full = gen(self.columns)
            # honor the split's key range (keys == row indices here)
            import numpy as np

            yield full.take(np.arange(self.lo, min(self.hi, full.num_rows)))
            return
        fn = {
            "supplier": self.gen.gen_supplier,
            "customer": self.gen.gen_customer,
            "part": self.gen.gen_part,
            "partsupp": self.gen.gen_partsupp,
            "orders": self.gen.gen_orders,
            "lineitem": self.gen.gen_lineitem,
        }[self.table]
        # partsupp expands x4 and lineitem ~x4 per key; shrink key step so
        # emitted batches stay near batch_rows
        step = self.batch_rows // 4 if self.table in ("partsupp", "lineitem") \
            else self.batch_rows
        step = max(step, 1)
        for lo in range(self.lo, self.hi, step):
            yield fn(self.columns, lo, min(lo + step, self.hi))


class TpchConnector(Connector):
    """The tpch catalog: tables generated on the fly at a given scale."""

    # generated data never changes: whole-query programs
    # may cache device-resident scans
    immutable_data = True

    name = "tpch"

    def __init__(self, scale: float = 1.0, money: str = "double"):
        self.generator = TpchGenerator(scale, money)
        money_t = self.generator.money_type
        qty_t = (T.DecimalType("decimal", 12, 2)
                 if isinstance(money_t, T.DecimalType) else T.DOUBLE)
        self._schemas = {
            name: TableSchema(name, tuple(ColumnMetadata(n, t) for n, t in cols))
            for name, cols in _schemas(money_t, qty_t).items()
        }
        self._stats_cache: Dict[str, TableStatistics] = {}

    # -- key ranges per table (split domain) -----------------------------
    def _key_range(self, table: str) -> Tuple[int, int]:
        g = self.generator
        return {
            "region": (0, 5), "nation": (0, 25),
            "supplier": (1, g.n_supplier + 1),
            "customer": (1, g.n_customer + 1),
            "part": (1, g.n_part + 1),
            "partsupp": (1, g.n_part + 1),     # keyed by part
            "orders": (1, g.n_orders + 1),
            "lineitem": (1, g.n_orders + 1),   # keyed by order
        }[table]

    def row_count(self, table: str) -> int:
        g = self.generator
        return {
            "region": 5, "nation": 25, "supplier": g.n_supplier,
            "customer": g.n_customer, "part": g.n_part,
            "partsupp": 4 * g.n_part, "orders": g.n_orders,
            "lineitem": 4 * g.n_orders,  # expected 4/order
        }[table]

    _SORT_ORDER = {
        "supplier": ["s_suppkey"], "customer": ["c_custkey"],
        "part": ["p_partkey"], "partsupp": ["ps_partkey", "ps_suppkey"],
        "orders": ["o_orderkey"],
        "lineitem": ["l_orderkey", "l_linenumber"],
        "nation": ["n_nationkey"], "region": ["r_regionkey"],
    }

    def sort_order(self, handle: TableHandle) -> List[str]:
        """Generation order: every table is emitted ascending by its
        surrogate key (lineitem clustered by orderkey, then line
        number) — the property StreamingAggregation exploits."""
        return list(self._SORT_ORDER.get(handle.table, []))

    # which column IS the split-range key of each table (the implicit
    # bucketing column, TpchNodePartitioningProvider role)
    _BUCKET_COLUMN = {
        "supplier": "s_suppkey", "customer": "c_custkey",
        "part": "p_partkey", "partsupp": "ps_partkey",
        "orders": "o_orderkey", "lineitem": "l_orderkey",
    }

    def bucket_splits(self, handle: TableHandle, column: str,
                      n_buckets: int):
        """Range buckets over the key domain: orders and lineitem share
        the orderkey domain, so joins on it co-partition exactly (the
        grouped-execution qualifier, Lifespan.java:26)."""
        if self._BUCKET_COLUMN.get(handle.table) != column:
            return None
        lo, hi = self._key_range(handle.table)
        n = hi - lo
        if n < n_buckets:
            return None
        per = -(-n // n_buckets)
        mult = 4 if handle.table in ("partsupp", "lineitem") else 1
        buckets: List[List[Split]] = []
        for b in range(n_buckets):
            blo = lo + b * per
            bhi = min(blo + per, hi)
            if blo >= bhi:
                buckets.append([])
                continue
            buckets.append([Split(handle, (blo, bhi),
                                  estimated_rows=(bhi - blo) * mult)])
        return (lo, hi), buckets

    def list_tables(self) -> List[str]:
        return sorted(self._schemas)

    def get_table(self, table: str) -> Optional[TableHandle]:
        if table not in self._schemas:
            return None
        return TableHandle(self.name, table, extra=self.generator.scale)

    def table_schema(self, handle: TableHandle) -> TableSchema:
        return self._schemas[handle.table]

    def table_statistics(self, handle: TableHandle) -> TableStatistics:
        """Analytic column statistics from the generator's parameters
        (the reference's presto-tpch ships exact ColumnStatistics the same
        way — TpchMetadata.getTableStatistics — because counter-based
        generation makes NDVs and ranges closed-form, no ANALYZE pass)."""
        stats = self._stats_cache.get(handle.table)
        if stats is None:
            stats = self._compute_statistics(handle.table)
            self._stats_cache[handle.table] = stats
        return stats

    def _compute_statistics(self, table: str) -> TableStatistics:
        import datetime as _dt

        def day(days: int) -> _dt.date:
            return _dt.date(1970, 1, 1) + _dt.timedelta(days=int(days))

        g = self.generator
        rows = float(self.row_count(table))
        ts = TableStatistics(row_count=rows)
        nc, ns, np_, no = (g.n_customer, g.n_supplier, g.n_part, g.n_orders)

        def put(col, ndv, lo=None, hi=None):
            ts.ndv[col] = float(min(ndv, rows))
            if lo is not None:
                ts.low[col] = lo
                ts.high[col] = hi

        if table == "region":
            put("r_regionkey", 5, 0, 4)
            put("r_name", 5)
        elif table == "nation":
            put("n_nationkey", 25, 0, 24)
            put("n_name", 25)
            put("n_regionkey", 5, 0, 4)
        elif table == "supplier":
            put("s_suppkey", ns, 1, ns)
            put("s_name", ns)
            put("s_nationkey", 25, 0, 24)
            put("s_acctbal", min(rows, 1_099_999), -999.99, 9999.99)
        elif table == "customer":
            put("c_custkey", nc, 1, nc)
            put("c_name", nc)
            put("c_nationkey", 25, 0, 24)
            put("c_acctbal", min(rows, 1_099_999), -999.99, 9999.99)
            put("c_mktsegment", len(SEGMENTS))
        elif table == "part":
            put("p_partkey", np_, 1, np_)
            put("p_name", np_)
            put("p_mfgr", 5)
            put("p_brand", 25)
            put("p_type", len(TYPE_S1) * len(TYPE_S2) * len(TYPE_S3))
            put("p_size", 50, 1, 50)
            put("p_container", len(CONTAINER_S1) * len(CONTAINER_S2))
            put("p_retailprice", 20001, 900.00, 2099.00)
        elif table == "partsupp":
            put("ps_partkey", np_, 1, np_)
            put("ps_suppkey", ns, 1, ns)
            put("ps_availqty", 9999, 1, 9999)
            put("ps_supplycost", 99_901, 1.00, 1000.00)
        elif table == "orders":
            put("o_orderkey", no, 1, no)
            put("o_custkey", max((nc // 3) * 2, 1), 1, nc)
            put("o_orderstatus", 3)
            put("o_totalprice", rows, 810.00, 600_000.00)
            put("o_orderdate", DATE_HI - 151 - DATE_LO + 1,
                day(DATE_LO), day(DATE_HI - 151))
            put("o_orderpriority", len(PRIORITIES))
            put("o_clerk", g.n_clerks)
            put("o_shippriority", 1, 0, 0)
        elif table == "lineitem":
            put("l_orderkey", no, 1, no)
            put("l_partkey", np_, 1, np_)
            put("l_suppkey", ns, 1, ns)
            put("l_linenumber", 7, 1, 7)
            put("l_quantity", 50, 1.0, 50.0)
            put("l_extendedprice", rows / 10, 900.00, 104_950.00)
            put("l_discount", 11, 0.00, 0.10)
            put("l_tax", 9, 0.00, 0.08)
            put("l_returnflag", 3)
            put("l_linestatus", 2)
            put("l_shipdate", DATE_HI - 151 + 121 - DATE_LO,
                day(DATE_LO + 1), day(DATE_HI - 151 + 121))
            put("l_commitdate", DATE_HI - 151 + 90 - DATE_LO - 30,
                day(DATE_LO + 30), day(DATE_HI - 151 + 90))
            put("l_receiptdate", DATE_HI - 151 + 151 - DATE_LO,
                day(DATE_LO + 2), day(DATE_HI - 151 + 151))
            put("l_shipinstruct", len(INSTRUCTIONS))
            put("l_shipmode", len(SHIP_MODES))
        return ts

    def get_splits(self, handle: TableHandle, desired_splits: int) -> List[Split]:
        lo, hi = self._key_range(handle.table)
        n = hi - lo
        desired = max(1, min(desired_splits, n))
        per = -(-n // desired)
        out = []
        mult = 4 if handle.table in ("partsupp", "lineitem") else 1
        for start in range(lo, hi, per):
            end = min(start + per, hi)
            out.append(Split(handle, (start, end),
                             estimated_rows=(end - start) * mult))
        return out

    def page_source(self, split: Split, columns: Sequence[str],
                    batch_rows: int = 65536) -> PageSource:
        lo, hi = split.info
        return _TpchPageSource(self.generator, split.handle.table, columns,
                               lo, hi, batch_rows)
