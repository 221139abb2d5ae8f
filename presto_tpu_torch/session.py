"""Sessions, session properties, access control, transactions.

The reference hangs per-query state off ``Session`` (identity, catalog,
schema, property overrides) and splits the rest across three subsystems:

- **Session properties** (presto-main/.../SystemSessionProperties.java:51):
  per-query overrides of engine behavior, set via ``SET SESSION k = v``,
  typed and validated against a registry.
- **Access control** (presto-main/.../security/, the SystemAccessControl
  SPI): table-level permission checks made at analysis time with the
  session identity.
- **Transactions** (presto-main/.../transaction/TransactionManager
  .java:28): one transaction per query (auto-commit), or an explicit one
  opened by START TRANSACTION, carrying commit/abort callbacks.

``SESSION_PROPERTIES`` holds the properties whose ``EngineConfig`` field
this package reads; ``UNPORTED_PROPERTIES`` maps every other property of
the JAX package's registry to the ROADMAP item that ports its feature,
and setting one raises ``NotImplementedError`` naming that item.  The
rule-based and grant-aware access control, GRANT/REVOKE, resource groups
and the session property manager are ROADMAP A4b.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from presto_tpu_torch.config import DEFAULT, EngineConfig

# ---------------------------------------------------------------------------
# session properties
# ---------------------------------------------------------------------------


def _bool(v: str) -> bool:
    return v.lower() in ("true", "1", "on")


def _enum_parser(name: str, allowed: Tuple[str, ...]):
    def parse(v: str) -> str:
        lv = v.lower()
        if lv not in allowed:
            raise ValueError(
                f"{name} must be one of {', '.join(allowed)}")
        return lv

    return parse


# property name -> (config field, parser); the SystemSessionProperties
# registry: every entry is typed and validated on SET
SESSION_PROPERTIES: Dict[str, Tuple[str, Callable[[str], Any]]] = {
    "scan_batch_rows": ("scan_batch_rows", int),
    "min_batch_capacity": ("min_batch_capacity", int),
    "task_concurrency": ("task_concurrency", int),
    "direct_groupby_max_domain": ("direct_groupby_max_domain", int),
    "dynamic_filtering_enabled": ("dynamic_filtering_enabled", _bool),
    "streaming_aggregation_enabled": ("streaming_aggregation_enabled",
                                      _bool),
    "join_distribution_type": ("join_distribution_type", _enum_parser(
        "join_distribution_type",
        ("automatic", "broadcast", "partitioned"))),
    "broadcast_join_row_limit": ("broadcast_join_row_limit", int),
    "join_reordering_strategy": ("join_reordering_strategy", _enum_parser(
        "join_reordering_strategy", ("automatic", "none"))),
    "optimizer_use_memo": ("optimizer_use_memo", _bool),
    "memo_max_reorder_relations": ("memo_max_reorder_relations", int),
    "hash_partition_count": ("hash_partition_count", int),
    "query_max_memory_bytes": ("query_max_memory_bytes", int),
    "query_max_run_time_s": ("query_max_run_time_s", float),
    "hash_groupby_enabled": ("hash_groupby_enabled", _bool),
    "hash_groupby_init_slots": ("hash_groupby_init_slots", int),
    "hash_groupby_max_slots": ("hash_groupby_max_slots", int),
    "hash_groupby_min_rows": ("hash_groupby_min_rows", int),
    "device_join_probe": ("device_join_probe", _bool),
    "device_join_probe_max_build_rows": (
        "device_join_probe_max_build_rows", int),
}

# the JAX package's session properties whose feature this package does not
# have yet -> the ROADMAP item that ports it
UNPORTED_PROPERTIES: Dict[str, str] = {
    "spill_enabled": "A8 (spill)",
    "spill_threshold_bytes": "A8 (spill)",
    "spill_partitions": "A8 (spill)",
    "grouped_execution_buckets": "A9 (grouped execution)",
    "query_queue_timeout_s": "A4b (resource groups)",
    "scaled_writer_rows_per_task": "A13 (distributed tier)",
    "partial_aggregation_enabled": "A13 (distributed tier)",
    "query_max_total_memory_bytes": "A13 (distributed tier)",
    "stage_retry_limit": "A13 (distributed tier)",
    "cancel_fanout_budget_s": "A13 (distributed tier)",
    "speculative_execution_enabled": "A13 (distributed tier)",
    "speculation_quantile": "A13 (distributed tier)",
    "speculation_lag_factor": "A13 (distributed tier)",
    "speculation_min_runtime_s": "A13 (distributed tier)",
    "exchange_spooling_enabled": "A13 (distributed tier)",
    "exchange_max_buffer_bytes": "A13 (distributed tier)",
    "exchange_spool_stall_s": "A13 (distributed tier)",
    "plan_cache_enabled": "A13 (distributed tier)",
    "plan_cache_capacity": "A13 (distributed tier)",
    "result_cache_enabled": "A13 (distributed tier)",
    "result_cache_max_entry_bytes": "A13 (distributed tier)",
    "stats_sampling_enabled": "A13 (distributed tier)",
    "stats_sample_interval_s": "A13 (distributed tier)",
    "slow_query_log_threshold_s": "A13 (distributed tier)",
    "whole_query_execution": "A14 (multi-device tier)",
    "mesh_device_exchange": "A14 (multi-device tier)",
    "partitioned_join_build": "A14 (multi-device tier)",
    "grouped_mesh_execution": "A14 (multi-device tier)",
    "mesh_progress_beacons": "A14 (multi-device tier)",
    "mesh_checkpoint_boundaries": "A14 (multi-device tier)",
    "mesh_resume_mode": "A14 (multi-device tier)",
    "join_expansion_factor": "S2 (static output shapes)",
    "pipeline_fusion": "S7 (pipeline fusion)",
    "fusion_partial_agg": "S7 (pipeline fusion)",
    "fusion_final_merge": "S7 (pipeline fusion)",
    "prereduce_cost_based": "S7 (pipeline fusion)",
    "prereduce_max_group_fraction": "S7 (pipeline fusion)",
    "kernel_cache_capacity": "S7 (pipeline fusion)",
}


class SessionError(ValueError):
    pass


@dataclasses.dataclass
class Session:
    """Per-connection context (Session.java role)."""

    user: str = "user"
    catalog: str = "tpch"
    schema: Optional[str] = None
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # explicit transaction opened by START TRANSACTION (None = autocommit)
    txn: Optional[Any] = None

    def set_property(self, name: str, value: str) -> None:
        name = name.lower()
        if name in UNPORTED_PROPERTIES:
            raise NotImplementedError(
                f"session property {name!r} is not in presto_tpu_torch "
                f"yet: ROADMAP {UNPORTED_PROPERTIES[name]}")
        if name not in SESSION_PROPERTIES:
            raise SessionError(f"unknown session property {name!r}")
        _, parse = SESSION_PROPERTIES[name]
        try:
            self.properties[name] = parse(value)
        except (ValueError, TypeError) as e:
            raise SessionError(
                f"bad value for session property {name!r}: {value!r}"
            ) from e

    def reset_property(self, name: str) -> None:
        self.properties.pop(name.lower(), None)

    def effective_config(self, base: EngineConfig = DEFAULT) -> EngineConfig:
        if not self.properties:
            return base
        fields = {SESSION_PROPERTIES[k][0]: v
                  for k, v in self.properties.items()}
        return dataclasses.replace(base, **fields)

    def show_properties(self, base: EngineConfig = DEFAULT
                        ) -> List[Tuple[str, str, str]]:
        """(name, value, default) rows for SHOW SESSION."""
        out = []
        for name, (field, _) in sorted(SESSION_PROPERTIES.items()):
            default = getattr(base, field)
            value = self.properties.get(name, default)
            out.append((name, str(value), str(default)))
        return out


# ---------------------------------------------------------------------------
# access control
# ---------------------------------------------------------------------------

class AccessDeniedError(PermissionError):
    pass


class AccessControl:
    """SystemAccessControl SPI surface used by the engine."""

    def check_can_select(self, user: str, catalog: str, table: str) -> None:
        raise NotImplementedError

    def check_can_delete(self, user: str, catalog: str, table: str) -> None:
        # default: DELETE gated like INSERT (write privilege)
        self.check_can_insert(user, catalog, table)

    def check_can_rename_table(self, user: str, catalog: str,
                               table: str) -> None:
        self.check_can_drop_table(user, catalog, table)

    def notify_table_renamed(self, catalog: str, old: str,
                             new: str) -> None:
        """Hook so implementations can migrate per-table state."""

    def check_can_insert(self, user: str, catalog: str, table: str) -> None:
        raise NotImplementedError

    def check_can_create_table(self, user: str, catalog: str,
                               table: str) -> None:
        raise NotImplementedError

    def check_can_drop_table(self, user: str, catalog: str,
                             table: str) -> None:
        raise NotImplementedError


class AllowAllAccessControl(AccessControl):
    def check_can_select(self, user, catalog, table):
        pass

    def check_can_insert(self, user, catalog, table):
        pass

    def check_can_create_table(self, user, catalog, table):
        pass

    def check_can_drop_table(self, user, catalog, table):
        pass


# ---------------------------------------------------------------------------
# transactions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransactionInfo:
    transaction_id: str
    auto_commit: bool = True
    # connector-side commit/abort callbacks registered during execution
    commit_actions: List[Callable[[], None]] = dataclasses.field(
        default_factory=list)
    abort_actions: List[Callable[[], None]] = dataclasses.field(
        default_factory=list)
    state: str = "ACTIVE"          # ACTIVE | COMMITTED | ABORTED


class TransactionManager:
    """Per-query auto-commit transactions (TransactionManager.java:28).
    The engine's writes are single-commit PageSink finishes; the manager
    sequences those commits and exposes abort for failure paths."""

    def __init__(self):
        self._lock = threading.Lock()
        self.transactions: Dict[str, TransactionInfo] = {}

    def begin(self, auto_commit: bool = True) -> TransactionInfo:
        txn = TransactionInfo(uuid.uuid4().hex[:16], auto_commit)
        with self._lock:
            self.transactions[txn.transaction_id] = txn
        return txn

    def commit(self, txn: TransactionInfo) -> None:
        if txn.state != "ACTIVE":
            raise RuntimeError(f"transaction is {txn.state}")
        for action in txn.commit_actions:
            action()
        txn.state = "COMMITTED"
        self._forget(txn)

    def abort(self, txn: TransactionInfo) -> None:
        if txn.state != "ACTIVE":
            return
        for action in txn.abort_actions:
            try:
                action()
            except Exception:  # noqa: BLE001 - abort is best-effort
                pass
        txn.state = "ABORTED"
        self._forget(txn)

    def _forget(self, txn: TransactionInfo) -> None:
        with self._lock:
            self.transactions.pop(txn.transaction_id, None)
