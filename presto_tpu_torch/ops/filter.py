"""Filter compaction.

The reference's compiled PageFilter produces SelectedPositions consumed by
projections (presto-main/.../operator/project/PageProcessor.java:100).
Here a boolean mask becomes the index vector of the selected live rows;
every downstream op is then a plain gather.  Eager torch has no static
shapes to keep, so the selection is exactly as long as the live count.
"""

from __future__ import annotations

from typing import Optional

import torch


def selected_positions(mask: Optional[torch.Tensor],
                       valid: Optional[torch.Tensor],
                       num_rows: int) -> torch.Tensor:
    """int64 indices of the rows in ``[0, num_rows)`` whose predicate is
    true.  NULL predicate results are "not selected" (SQL WHERE
    semantics)."""
    live = mask[:num_rows]
    if valid is not None:
        live = live & valid[:num_rows]
    return torch.nonzero(live).squeeze(1)
