"""Operator protocol + shared device-batch plumbing.

The contract is the reference's Operator SPI verbatim
(presto-main/.../operator/Operator.java:20-102):

    needs_input() / add_input(batch) / get_output() / finish() /
    is_finished()

kept because the *control plane* of a pull/push pipeline is
hardware-agnostic; each operator's data plane is torch ops on the device.
``accumulate``-style operators (aggregation, sort) materialize their input
exactly like the reference's PagesIndex-backed operators do, then reduce
once at finish.

``device_concat`` / ``pad_batch`` keep the JAX package's padding-bucket
policy at the materializing operators (power-of-two row capacities), so
the reductions see the same shapes in both packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from presto_tpu_torch.batch import Batch, Column, concat_batches, next_bucket
from presto_tpu_torch.exec.context import OperatorContext


class Operator:
    """One physical operator instance (single driver)."""

    def __init__(self, ctx: OperatorContext):
        self.ctx = ctx
        self._finishing = False

    # -- control protocol (reference-identical) -------------------------
    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: Batch) -> None:
        raise NotImplementedError

    def get_output(self) -> Optional[Batch]:
        return None

    def finish(self) -> None:
        """No more input will arrive (Operator.finish)."""
        self._finishing = True

    def is_finished(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        self.ctx.memory.free()


class OperatorFactory:
    """Creates per-driver Operator instances
    (reference OperatorFactory; duplicated per driver for parallelism).

    ``parallel_safe`` marks row-local factories (scan, filter/project,
    unnest, dynamic filter) whose operators may replicate into N
    concurrent feed drivers without changing results — the
    AddLocalExchanges eligibility bit."""

    parallel_safe = False

    def create(self, ctx: OperatorContext) -> Operator:
        raise NotImplementedError

    def reset_for_execution(self) -> None:
        """Clear cross-execution factory state so a cached PhysicalPlan
        can be re-executed (the plan-cache physical-factory sharing
        path).  Most factories keep all runtime state in the Operators
        they create and need nothing; factories that rendezvous ACROSS
        pipelines (output collector, union buffer, build sides) override
        to re-arm their shared state."""

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Factory", "")


class SourceOperator(Operator):
    """An operator at pipeline position 0 fed by splits, not batches
    (reference SourceOperator; split delivery is the scheduler's job)."""

    def add_split(self, split) -> None:
        raise NotImplementedError

    def no_more_splits(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Device-batch helpers
# ---------------------------------------------------------------------------

def pad_batch(batch: Batch, min_capacity: int = 1024,
              device=None) -> Batch:
    """Pad to the power-of-two bucket, on ``device`` (default: the
    batch's own)."""
    cap = next_bucket(batch.num_rows, min_capacity)
    device = device if device is not None else batch.device
    if device is not None and batch.device != torch.device(device):
        batch = batch.to_device(device)
    return batch.pad_rows(cap)


def device_concat(batches: Sequence[Batch], min_capacity: int = 1024,
                  device=None) -> Optional[Batch]:
    """Concatenate batches into one padded Batch on the batches' device.

    When every dictionary column shares one dictionary object across the
    batches (connector-interned dictionaries), the concat is one
    ``torch.cat`` per column on the device.  Otherwise ``concat_batches``
    concatenates them on their device: dictionary columns re-coded into a
    shared dictionary (the map built on the host, dictionary sizes << row
    counts, and gathered on the device), nested columns with their
    children."""
    live = [b for b in batches if b.num_rows > 0]
    if not live:
        return None
    device = device if device is not None else live[0].device
    if len(live) == 1:
        return pad_batch(live[0].compact(), min_capacity, device)
    shared = all(
        c.dictionary is live[0].columns[ci].dictionary
        and c.device is not None and not c.children
        for b in live for ci, c in enumerate(b.columns))
    if not shared or device is None:
        merged = concat_batches(live)
        return pad_batch(merged, min_capacity, device)
    total = sum(b.num_rows for b in live)
    cols = []
    for ci, first in enumerate(live[0].columns):
        values = torch.cat([b.columns[ci].values[:b.num_rows] for b in live])
        valid = None
        if any(b.columns[ci].valid is not None for b in live):
            valid = torch.cat([
                b.columns[ci].valid[:b.num_rows]
                if b.columns[ci].valid is not None
                else torch.ones(b.num_rows, dtype=torch.bool, device=device)
                for b in live])
        cols.append(Column(first.type, values, valid, first.dictionary))
    return Batch(tuple(cols), total).pad_rows(
        next_bucket(total, min_capacity))
