"""Row hashing: ``checksum`` and the partition of a row.

The reference hashes rows for repartitioning via InterpretedHashGenerator /
precomputed $hashValue columns (presto-main/.../operator/InterpretedHash
Generator.java:31).  Grouping and joining here never use this hash; it
serves ``checksum`` (a wrapping sum of row hashes) and choosing a partition
(spill, exchange).  splitmix64 over the normalized key words, combined
multiplicatively across channels.

The hash is computed in int64 on the column's device: torch has no ``>>``
or ``%`` for uint64, so logical right shifts are masked arithmetic shifts,
the multiplies wrap in two's complement, and the modulo of a partition is
taken on the unsigned value.  The bits equal the JAX package's uint64
hash.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops.keys import normalize_keys


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)
_SEED = 0x243F6A8885A308D3


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (uint64 ``x >> s``)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def row_hash(columns: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor],
                                     T.Type]]) -> torch.Tensor:
    """The 64-bit hash per row over the key channels (nulls hash as a
    class), as the int64 with the bits of the JAX package's uint64."""
    words, _ = normalize_keys(columns, nulls_equal=True)
    acc = torch.full((words[0].shape[0],), _SEED, dtype=torch.int64,
                     device=words[0].device)
    for w in words:
        acc = _mix64(acc * _GOLDEN + w)
    return acc


def partition_of(hashes: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """int32 partition per row: the unsigned hash modulo
    ``num_partitions`` (u = 2 * (u >> 1) + (u & 1))."""
    p = int(num_partitions)
    half = torch.remainder(_shr(hashes, 1), p)
    return torch.remainder(half * 2 + (hashes & 1), p).to(torch.int32)


def value_hash_triple(col) -> tuple:
    """(values, valid, type) for partitioning hashes, with dictionary
    columns replaced by per-ENTRY value hashes gathered on codes.

    Codes are interning order: two batches holding the same strings in
    different dictionaries disagree on codes, so hashing codes would route
    equal keys to different partitions.  Each dictionary entry's UTF-8
    bytes are hashed once on the host with XXH64 (entries << rows) and the
    table is gathered on the codes on the column's device, so the
    partition is a function of the string value.

    ``col`` needs only ``values/valid/type/dictionary`` attributes."""
    from presto_tpu_torch import native

    if col.dictionary is None:
        return (col.values, col.valid, col.type)
    entries = col.dictionary.values
    table = np.fromiter(
        (native.xxh64(e.encode("utf-8", "surrogatepass")) for e in entries),
        dtype=np.uint64, count=len(entries)).view(np.int64)
    if len(table) == 0:
        table = np.zeros(1, np.int64)
    codes = col.values.long().clamp(0, len(table) - 1)
    return (torch.from_numpy(table).to(codes.device)[codes], col.valid,
            T.BIGINT)
