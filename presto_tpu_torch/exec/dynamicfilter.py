"""Dynamic filtering: build-side key domains prune the probe early.

Reference model: DynamicFilterSourceOperator collects build-side join-key
values into runtime filters that LocalDynamicFilter applies on the probe
scan (presto-main/.../operator/DynamicFilterSourceOperator.java:46,
sql/planner/LocalDynamicFilter.java:45, sql/DynamicFilters.java).

The build side always completes before the probe pipeline starts (the
single-process rendezvous), so the filter is ready synchronously:
``HashBuildOperator`` fills a ``DynamicFilter`` with per-key min/max and,
for small builds, the exact distinct key set (computed on the host from
the build's key columns, as the JAX package computes them), and a
``DynamicFilterOperator`` placed on the probe side drops rows that cannot
match with one mask and one gather on the batch's device.

Dictionary-coded keys are skipped: probe and build dictionaries intern
independently, so code-domain comparisons would be meaningless.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.exec.context import OperatorContext
from presto_tpu_torch.exec.operator import Operator, OperatorFactory

# exact-set filtering only below this many distinct build keys
MAX_DISTINCT_SET = 4096


class DynamicFilter:
    """Per-join runtime filter, one entry per equi-key channel."""

    def __init__(self, n_keys: int):
        self.ready = False
        self.mins: List[Optional[np.generic]] = [None] * n_keys
        self.maxs: List[Optional[np.generic]] = [None] * n_keys
        self.sets: List[Optional[np.ndarray]] = [None] * n_keys
        self.build_empty = False

    def fill_from_build(self, data: Optional[Batch],
                        key_channels: Sequence[int]) -> None:
        """Min/max and (up to MAX_DISTINCT_SET keys) the exact key set of
        each key channel over the build's live, non-null rows; only the
        key columns leave the device."""
        if data is None or data.num_rows == 0:
            self.build_empty = True
            self.ready = True
            return
        n = data.num_rows
        for i, ch in enumerate(key_channels):
            col = data.columns[ch]
            if col.type.is_dictionary or col.type.name == "boolean":
                continue  # incomparable domains / trivial
            vals = _host(col.values)[:n]
            if col.valid is not None:
                vals = vals[_host(col.valid)[:n]]
            if vals.size == 0:
                self.build_empty = True
                continue
            self.mins[i] = vals.min()
            self.maxs[i] = vals.max()
            uniq = np.unique(vals)
            if uniq.size <= MAX_DISTINCT_SET:
                self.sets[i] = uniq
        self.ready = True


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class DynamicFilterOperator(Operator):
    def __init__(self, ctx: OperatorContext, dyn: DynamicFilter,
                 key_channels: Sequence[int]):
        super().__init__(ctx)
        self.dyn = dyn
        self.key_channels = list(key_channels)
        self._pending: Optional[Batch] = None
        # adaptive shutoff (the reference disables ineffective dynamic
        # filters): stop filtering once observed selectivity is poor
        self._rows_seen = 0
        self._rows_kept = 0
        self._adaptive_off = False
        self._sets = {}            # channel -> key set on the batch device

    def needs_input(self) -> bool:
        return not self._finishing and self._pending is None

    def _filters(self):
        return [(ch, self.dyn.mins[i], self.dyn.maxs[i], self.dyn.sets[i])
                for i, ch in enumerate(self.key_channels)
                if self.dyn.mins[i] is not None]

    def _mask(self, batch: Batch, filters) -> torch.Tensor:
        device = batch.device
        mask = torch.ones(batch.num_rows, dtype=torch.bool, device=device)
        for ch, mn, mx, st in filters:
            col = batch.columns[ch]
            v = col.values[:batch.num_rows]
            m = (v >= mn.item()) & (v <= mx.item())
            if st is not None:
                table = self._sets.get(ch)
                if table is None:
                    table = self._sets[ch] = torch.from_numpy(st).to(
                        device=device, dtype=v.dtype)
                m = m & torch.isin(v, table)
            if col.valid is not None:
                m = m & col.valid[:batch.num_rows]
            mask = mask & m
        return mask

    def add_input(self, batch: Batch) -> None:
        self.ctx.stats.input_rows += batch.num_rows
        if not self.dyn.ready or self._adaptive_off:
            self._pending = batch  # no filter info: pass through
            return
        if self.dyn.build_empty:
            return  # inner join against an empty build: nothing survives
        filters = self._filters()
        if not filters:
            self._pending = batch
            return
        idx = torch.nonzero(self._mask(batch, filters)).squeeze(1)
        n_keep = int(idx.shape[0])
        self._rows_seen += batch.num_rows
        self._rows_kept += n_keep
        if self._rows_seen >= 4096 and \
                self._rows_kept > 0.95 * self._rows_seen:
            self._adaptive_off = True
        if n_keep == batch.num_rows:
            self._pending = batch
        elif n_keep > 0:
            self._pending = batch.take(idx)
        # else: fully pruned, emit nothing
        self.ctx.stats.output_rows += n_keep

    def get_output(self) -> Optional[Batch]:
        out, self._pending = self._pending, None
        return out

    def is_finished(self) -> bool:
        return self._finishing and self._pending is None


class DynamicFilterOperatorFactory(OperatorFactory):
    parallel_safe = True

    def __init__(self, dyn: DynamicFilter, key_channels: Sequence[int]):
        self.dyn = dyn
        self.key_channels = list(key_channels)

    def create(self, ctx: OperatorContext) -> DynamicFilterOperator:
        return DynamicFilterOperator(ctx, self.dyn, self.key_channels)
