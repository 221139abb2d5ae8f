"""Mergeable sketches: HyperLogLog for approx_distinct, KLL for
approx_percentile.

The reference's approx_distinct rides airlift-stats HyperLogLog
(presto-main/.../operator/aggregation/ApproximateCountDistinctAggregation
.java, presto-spi HLL state).  This is a dense HLL with 2^11 registers
(standard error ~2.3%, matching the reference's default 2.3% at its
default bucket count); sketches serialize to latin-1 strings so they ride
the varbinary dictionary representation through partial/final exchanges.

Both are host code, as in the JAX package: the aggregation operator copies
its batches to the host and folds values in here one by one
(``exec/aggregation.py`` ``host_aggregate``).  Values arrive as the
Python values ``Batch.to_pylist`` gives (``int``, ``float``, ``str``,
``bool``, ``date``, ``Decimal``), which ``_hash64`` hashes by type; so do
the JAX package's, and the payloads are bit-equal to its.  KLL's
compaction draws from numpy's ``default_rng`` for the same reason: the
same seed gives the same kept items, so the same payload.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

P_BITS = 11
M = 1 << P_BITS                     # registers
_ALPHA = 0.7213 / (1 + 1.079 / M)   # standard HLL bias constant


def _hash64(value) -> int:
    from presto_tpu_torch import native

    if value is None:
        return 0
    if isinstance(value, bool):
        data = b"\x01" if value else b"\x00"
    elif isinstance(value, int):
        data = value.to_bytes(8, "little", signed=True)
    elif isinstance(value, float):
        data = np.float64(value).tobytes()
    elif isinstance(value, str):
        data = value.encode("utf-8")
    else:
        data = repr(value).encode("utf-8")
    return native.xxh64(data)


class HyperLogLog:
    __slots__ = ("registers",)

    def __init__(self, registers: Optional[np.ndarray] = None):
        self.registers = (np.zeros(M, np.uint8) if registers is None
                          else registers)

    def add_value(self, value) -> None:
        h = _hash64(value)
        idx = h & (M - 1)
        rest = h >> P_BITS
        # rank = leading-zero count + 1 over the remaining 53 bits
        rank = 1
        while rest & 1 == 0 and rank <= 64 - P_BITS:
            rank += 1
            rest >>= 1
        if rank > self.registers[idx]:
            self.registers[idx] = rank

    def add_many(self, values: Iterable) -> None:
        for v in values:
            if v is not None:
                self.add_value(v)

    def merge(self, other: "HyperLogLog") -> None:
        np.maximum(self.registers, other.registers, out=self.registers)

    def cardinality(self) -> int:
        regs = self.registers.astype(np.float64)
        est = _ALPHA * M * M / np.sum(np.exp2(-regs))
        zeros = int((self.registers == 0).sum())
        if est <= 2.5 * M and zeros:
            est = M * np.log(M / zeros)      # linear counting range
        return int(round(est))

    # -- serde (latin-1 string payload; rides the varbinary dictionary) ---
    def serialize(self) -> str:
        return self.registers.tobytes().decode("latin-1")

    @classmethod
    def deserialize(cls, payload: str) -> "HyperLogLog":
        raw = payload.encode("latin-1")
        if len(raw) != M:
            return cls()                      # unknown/corrupt -> empty
        return cls(np.frombuffer(raw, np.uint8).copy())


def hll_cardinality(payload: str) -> int:
    return HyperLogLog.deserialize(payload).cardinality()


# ---------------------------------------------------------------------------
# KLL quantile sketch (approx_percentile)
# ---------------------------------------------------------------------------

class KllSketch:
    """Mergeable streaming quantile sketch (KLL16-style).

    Replaces the reference's qdigest state
    (presto-main/.../aggregation/QuantileDigestAggregationFunction.java)
    with the simpler KLL compactor scheme: level h holds items each
    representing 2^h input values; a full level sorts itself and keeps
    alternate items (random offset), promoting them one level up.  State
    is O(k * log(n/k)) regardless of input size — the bounded-memory,
    exchange-friendly property the old collect-everything implementation
    lacked.  Error is rank-based (~1.5/k one-sided at default k).

    Values are stored as floats (SQL numeric inputs convert losslessly for
    realistic magnitudes); quantile() returns a float the caller casts to
    the column type.
    """

    K = 200

    def __init__(self, levels=None, count: int = 0, seed: int = 0x9E3779B9):
        self.levels = [list(lv) for lv in levels] if levels else [[]]
        self.count = count
        self._rng = np.random.default_rng(seed)

    # -- building -------------------------------------------------------
    def add_value(self, value) -> None:
        if value is None:
            return
        self.levels[0].append(float(value))
        self.count += 1
        if len(self.levels[0]) >= self._cap(0):
            self._compact()

    def add_many(self, values: Iterable) -> None:
        for v in values:
            self.add_value(v)

    def _cap(self, level: int) -> int:
        # higher levels shrink geometrically (KLL's (2/3)^depth rule,
        # floored) — most memory lives at the base
        depth = max(len(self.levels) - 1 - level, 0)
        return max(int(self.K * (2.0 / 3.0) ** depth), 8)

    def _compact(self) -> None:
        for h in range(len(self.levels)):
            if len(self.levels[h]) < self._cap(h):
                continue
            buf = sorted(self.levels[h])
            keep = buf[int(self._rng.integers(0, 2))::2]
            self.levels[h] = []
            if h + 1 == len(self.levels):
                self.levels.append([])
            self.levels[h + 1].extend(keep)

    # -- merge / query --------------------------------------------------
    def merge(self, other: "KllSketch") -> None:
        while len(self.levels) < len(other.levels):
            self.levels.append([])
        for h, lv in enumerate(other.levels):
            self.levels[h].extend(lv)
        self.count += other.count
        for h in range(len(self.levels)):
            while len(self.levels[h]) >= 2 * self._cap(h):
                self._compact_level(h)

    def _compact_level(self, h: int) -> None:
        buf = sorted(self.levels[h])
        keep = buf[int(self._rng.integers(0, 2))::2]
        self.levels[h] = []
        if h + 1 == len(self.levels):
            self.levels.append([])
        self.levels[h + 1].extend(keep)

    def quantile(self, q: float) -> Optional[float]:
        items: list = []
        for h, lv in enumerate(self.levels):
            w = 1 << h
            items.extend((v, w) for v in lv)
        if not items:
            return None
        items.sort()
        total = sum(w for _, w in items)
        target = q * total
        acc = 0
        for v, w in items:
            acc += w
            if acc >= target:
                return v
        return items[-1][0]

    # -- serde ----------------------------------------------------------
    def serialize(self) -> str:
        import json

        return json.dumps({"c": self.count, "l": self.levels})

    @classmethod
    def deserialize(cls, payload: str) -> "KllSketch":
        import json

        doc = json.loads(payload)
        return cls(levels=doc["l"], count=int(doc["c"]))
