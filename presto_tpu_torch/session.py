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
and setting one raises ``NotImplementedError`` naming that item.
``RuleBasedAccessControl`` (file-based rules), ``GrantStore`` with
``GrantAwareAccessControl`` (GRANT/REVOKE) and ``SessionPropertyManager``
(rule-based session defaults) are the JAX package's.  Resource groups
belong to the serving tier (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import fnmatch
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
    "query_queue_timeout_s": "A13 (resource groups)",
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
    # PREPARE name FROM stmt storage (Session.preparedStatements role);
    # values are parsed statement trees
    prepared: Dict[str, Any] = dataclasses.field(default_factory=dict)
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


def _match(pattern: str, value: str) -> bool:
    """A rule's '*'-wildcard pattern against a user, source, catalog or
    table name."""
    return fnmatch.fnmatch(value, pattern)


class AccessControl:
    """SystemAccessControl SPI surface used by the engine."""

    def check_can_select(self, user: str, catalog: str, table: str) -> None:
        raise NotImplementedError

    def check_can_delete(self, user: str, catalog: str, table: str) -> None:
        # default: DELETE gated like INSERT (write privilege)
        self.check_can_insert(user, catalog, table)

    def check_can_grant(self, user: str, catalog: str, table: str) -> None:
        # default: granting gated like dropping (ownership-level right)
        self.check_can_drop_table(user, catalog, table)

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


class RuleBasedAccessControl(AccessControl):
    """The file-based access control model (presto-plugin-toolkit's
    FileBasedSystemAccessControl): ordered rules of
    {user, catalog, table, privileges}; first match wins, no match denies.
    Patterns are '*'-wildcards."""

    def __init__(self, rules: List[Dict[str, Any]]):
        self.rules = rules

    def _check(self, user: str, catalog: str, table: str,
               privilege: str) -> None:
        for rule in self.rules:
            if not _match(rule.get("user", "*"), user):
                continue
            if not _match(rule.get("catalog", "*"), catalog):
                continue
            if not _match(rule.get("table", "*"), table):
                continue
            if privilege in rule.get("privileges", ()):
                return
            break  # first matching rule decides
        raise AccessDeniedError(
            f"Access denied: {user} cannot {privilege} "
            f"{catalog}.{table}")

    def check_can_select(self, user, catalog, table):
        self._check(user, catalog, table, "select")

    def check_can_insert(self, user, catalog, table):
        self._check(user, catalog, table, "insert")

    def check_can_create_table(self, user, catalog, table):
        self._check(user, catalog, table, "create")

    def check_can_drop_table(self, user, catalog, table):
        self._check(user, catalog, table, "drop")

    def check_can_delete(self, user, catalog, table):
        self._check(user, catalog, table, "delete")

    def check_can_grant(self, user, catalog, table):
        self._check(user, catalog, table, "grant")


class GrantStore:
    """SQL-managed privileges: GRANT/REVOKE state, keyed
    (user, catalog, table) -> set of privileges ('all' covers every
    privilege).  Thread-safe; shared by every session of a runner."""

    def __init__(self):
        self._lock = threading.Lock()
        self._grants: Dict[Tuple[str, str, str], set] = {}

    def grant(self, user: str, catalog: str, table: str,
              privileges) -> None:
        with self._lock:
            self._grants.setdefault((user, catalog, table),
                                    set()).update(privileges)

    def revoke(self, user: str, catalog: str, table: str,
               privileges) -> None:
        with self._lock:
            have = self._grants.get((user, catalog, table))
            if have:
                have.difference_update(privileges)

    def has(self, user: str, catalog: str, table: str,
            privilege: str) -> bool:
        with self._lock:
            have = self._grants.get((user, catalog, table), set())
            return privilege in have or "all" in have

    def rename_table(self, catalog: str, old: str, new: str) -> None:
        """Migrate grants when a table is renamed."""
        with self._lock:
            for key in [k for k in self._grants
                        if k[1] == catalog and k[2] == old]:
                self._grants[(key[0], catalog, new)] = \
                    self._grants.pop(key)


class GrantAwareAccessControl(AccessControl):
    """Access control driven by the GrantStore: the table owner (creator)
    and any ``admin_users`` bypass checks; everyone else needs an explicit
    GRANT.  This is the SQL-standard access-control mode of the reference
    (sql-standard AccessControl in presto-hive, GRANT/REVOKE in
    StatementAnalyzer)."""

    def __init__(self, grants: Optional[GrantStore] = None,
                 admin_users=("admin",)):
        # when None, the runner binds its shared GrantStore at attach time
        self.grants = grants
        self.admins = set(admin_users)
        self._owners: Dict[Tuple[str, str], str] = {}

    def _check(self, user, catalog, table, privilege):
        if user in self.admins:
            return
        if self._owners.get((catalog, table)) == user:
            return
        if self.grants.has(user, catalog, table, privilege):
            return
        raise AccessDeniedError(
            f"Access denied: {user} cannot {privilege} {catalog}.{table}")

    def check_can_select(self, user, catalog, table):
        self._check(user, catalog, table, "select")

    def check_can_insert(self, user, catalog, table):
        self._check(user, catalog, table, "insert")

    def check_can_create_table(self, user, catalog, table):
        # first creator wins: never steal ownership when the table
        # already exists (the create itself will fail later)
        self._owners.setdefault((catalog, table), user)

    def check_can_drop_table(self, user, catalog, table):
        if user in self.admins or self._owners.get(
                (catalog, table)) == user:
            return
        self._check(user, catalog, table, "drop")

    def check_can_delete(self, user, catalog, table):
        self._check(user, catalog, table, "delete")

    def notify_table_renamed(self, catalog, old, new):
        if (catalog, old) in self._owners:
            self._owners[(catalog, new)] = self._owners.pop((catalog, old))
        if self.grants is not None:
            self.grants.rename_table(catalog, old, new)


# ---------------------------------------------------------------------------
# session property managers
# ---------------------------------------------------------------------------

class SessionPropertyManager:
    """Rule-based session property defaults
    (presto-session-property-managers role: the db/file-backed
    SessionPropertyConfigurationManager applies matching rules'
    properties to a session before execution; explicit SET SESSION
    values still win).

    Rules are ordered dicts: {"user": pattern, "source": pattern,
    "properties": {name: value}}; '*' wildcards; all matching rules
    apply, later rules overriding earlier ones."""

    def __init__(self, rules: List[Dict[str, Any]]):
        self.rules = list(rules)

    def defaults_for(self, user: str, source: str = "") -> Dict[str, str]:
        out: Dict[str, str] = {}
        for rule in self.rules:
            if not _match(rule.get("user", "*"), user):
                continue
            if not _match(rule.get("source", "*"), source):
                continue
            out.update(rule.get("properties", {}))
        return out

    def apply(self, session: Session, source: str = "") -> None:
        """Set matched defaults that the session has not set itself."""
        for name, value in self.defaults_for(session.user,
                                             source).items():
            if name.lower() not in session.properties:
                session.set_property(name, str(value))


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
