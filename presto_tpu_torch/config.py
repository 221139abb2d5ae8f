"""Static engine configuration and the device choice.

``EngineConfig`` is the static host config (the FeaturesConfig role);
``Session`` (session.py) carries per-query overrides.  It holds the
fields this package reads, with the defaults ``presto_tpu`` uses, so
the two packages plan the same SQL into the same plans.

There is no global 64-bit switch: every tensor carries an explicit dtype
(DOUBLE is float64, BIGINT int64, DATE and dictionary codes int32).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch


@dataclasses.dataclass
class EngineConfig:
    # Capacity buckets: device tensors are padded to the next power of
    # two at least this size (the shape policy the JAX package keeps;
    # eager torch does not need it, but batch sizes stay comparable).
    min_batch_capacity: int = 1024
    # Rows per Batch produced by scans (the Page-size analogue).
    scan_batch_rows: int = 65536
    # Largest packed key domain for the direct GROUP BY tier (mixed-radix
    # ids + segment reduce).  Above it the sort/hash tiers apply.
    direct_groupby_max_domain: int = 1 << 12
    # Concurrent feed drivers per pipeline (LocalExchange tier).
    task_concurrency: int = 4
    # Per-query memory cap (0 = unlimited) and run-time cap (0 = none).
    query_max_memory_bytes: int = 0
    query_max_run_time_s: float = 0.0
    # --- optimizer (read by sql/optimizer.py and sql/memo.py) ----------
    join_distribution_type: str = "automatic"
    broadcast_join_row_limit: int = 100_000
    join_reordering_strategy: str = "automatic"
    optimizer_use_memo: bool = True
    memo_max_reorder_relations: int = 9
    hash_partition_count: int = 0
    # --- hash tiers (exec/aggregation.py, exec/joinop.py) --------------
    # Build-side key domains prune probe rows before the join
    # (DynamicFilterSourceOperator role).
    dynamic_filtering_enabled: bool = True
    # Resident GroupByHash tier: group state stays on the device across
    # batches in an open-addressing table (ops/hashtable.py, kernel B2
    # on a CUDA tensor).
    hash_groupby_enabled: bool = True
    # first table capacity (slots, a power of two); the rehash ladder
    # doubles it while fill exceeds 1/2
    hash_groupby_init_slots: int = 1 << 13
    # input rows below which an aggregation stays on the sort tier
    hash_groupby_min_rows: int = 1 << 17
    # rehash ceiling: above it the accumulated state is carried over and
    # the rest of the input takes the sort tier
    hash_groupby_max_slots: int = 1 << 22
    # PagesHash join tier: the build side's keys go into the same
    # open-addressing table and probes resolve their match ranges through
    # it.  Keys that cannot take the single/packed id tiers always use it.
    device_join_probe: bool = True
    # builds larger than this keep the sorted index for packable keys
    device_join_probe_max_build_rows: int = 1 << 17
    # Take the accelerator branch's PagesHash choice for packable keys on
    # every device, not only on cuda: the CPU tests set it to reach that
    # tier (the counterpart of the JAX package's PRESTO_TPU_RADIX=1
    # switch).  It changes no result.
    force_pages_hash: bool = False
    # --- streaming aggregation (exec/streamagg.py) ----------------------
    # A GROUP BY whose keys are a prefix of the scan's declared sort order
    # runs as StreamingAggregationOperator (no sort, no hash table).
    streaming_aggregation_enabled: bool = True


DEFAULT = EngineConfig()


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device a runner executes on: ``cuda`` unless the caller names
    another.  With no device given and no CUDA device present this
    raises: the engine never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

