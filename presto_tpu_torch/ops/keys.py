"""Key normalization for grouping and ordering.

The reference specializes hash strategies per key-channel types via runtime
bytecode (JoinCompiler.compilePagesHashStrategy,
presto-main/.../sql/gen/JoinCompiler.java:93).  Here every key column is
normalized into an order-preserving int64 tensor, so grouping and ordering
reduce to integer sort/compare problems:

- integral/date/timestamp/decimal -> the storage integer itself,
- boolean -> 0/1,
- float64/float32 -> order-preserving bit twiddle of the exact f64 bits
  (sign-magnitude to two's-complement flip).  The card has native f64, so
  this is the cpu/gpu branch of the JAX package's ``to_sortable_i64``,
  never its TPU f32 bitcast,
- dictionary codes -> the code (equality-correct within one dictionary).

Null handling is the SQL rule, split by use:
- GROUP BY: nulls form a group (the null flag becomes an extra key word),
- JOIN keys: null never equals anything (the row is masked out of
  matching).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T

_NOT_SIGN = 0x7FFFFFFFFFFFFFFF


def to_sortable_i64(values: torch.Tensor, typ: T.Type) -> torch.Tensor:
    """Map a value tensor to int64 preserving the type's sort order."""
    if typ.name in ("double", "real"):
        bits = values.to(torch.float64).contiguous().view(torch.int64)
        # signed-comparison order fix: negative floats have reversed bit
        # order, so flip their non-sign bits; positives compare correctly.
        return torch.where(bits < 0, bits ^ _NOT_SIGN, bits)
    return values.to(torch.int64)


def normalize_keys(columns: Sequence[Tuple[torch.Tensor,
                                           Optional[torch.Tensor], T.Type]],
                   nulls_equal: bool
                   ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Returns ``(key_words, null_row)``.

    ``nulls_equal=True`` (GROUP BY / IS NOT DISTINCT FROM): a nullable
    column contributes its zeroed value word and its null flag;
    ``null_row`` is None.
    ``nulls_equal=False`` (JOIN): any-null rows are reported in
    ``null_row`` so the caller can exclude them from matching.
    """
    words: List[torch.Tensor] = []
    null_row = None
    for values, valid, typ in columns:
        w = to_sortable_i64(values, typ)
        if valid is not None:
            if nulls_equal:
                # zero the value so all-null rows collide, key the flag
                words.append(torch.where(valid, w, torch.zeros_like(w)))
                words.append((~valid).to(torch.int64))
            else:
                words.append(w)
                null_row = ~valid if null_row is None else (null_row
                                                             | ~valid)
        else:
            words.append(w)
    return words, null_row
