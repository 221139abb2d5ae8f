"""ORDER BY / TopN permutation.

The reference sorts via PagesIndex + codegen'd comparators
(OrderByOperator.java:45, OrderingCompiler.java:62) and keeps a bounded
heap for TopN (TopNOperator.java:35).  Here both are one primitive: a
multi-word lexicographic sort over order-preserving int64 key words,
with TopN truncating the permutation.  torch has no ``lexsort``, so the
permutation is built from stable argsorts, from the minor key word to
the major one (each stable pass keeps the order the earlier, more minor
passes set among equal keys).  The TPU-only radix route of the JAX
package (ops/radix.py) has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops.keys import to_sortable_i64

# (values, valid|None, type, descending, nulls_first)
SortKey = Tuple[torch.Tensor, Optional[torch.Tensor], T.Type, bool, bool]


def sort_permutation(keys: Sequence[SortKey], num_rows: int) -> torch.Tensor:
    """Stable int64 permutation ordering live rows by the sort spec;
    padding rows sort to the end."""
    cap = keys[0][0].shape[0]
    device = keys[0][0].device
    pad = (torch.arange(cap, device=device) >= num_rows).to(torch.int8)
    major = []  # built major-to-minor
    for values, valid, typ, desc, nulls_first in keys:
        w = to_sortable_i64(values, typ)
        if desc:
            w = ~w  # exact order reversal for two's-complement words
        if valid is not None:
            null_word = torch.where(
                valid, 1 if nulls_first else 0, 0 if nulls_first else 1
            ).to(torch.int8)
            w = torch.where(valid, w, torch.zeros_like(w))
            major.append(null_word)
        major.append(w)
    major = [pad] + major    # padding is the primary word
    perm = torch.arange(cap, device=device)
    for w in reversed(major):
        order = torch.argsort(w[perm], stable=True)
        perm = perm[order]
    return perm
