"""Session parity: presto_tpu_torch against presto_tpu.

SET/RESET/SHOW SESSION on the properties the port applies give the JAX
package's rows; a property that steers execution gives its rows, with the
operator or tier it switches seen in the port's stats; unknown properties
and bad values raise its ``SessionError`` messages.  Every other property
of the JAX package's registry raises ``NotImplementedError`` naming the
ROADMAP item that ports its feature, and the two lists together are the
JAX package's registry.  ``TransactionManager``'s commit and abort flow
is held against the JAX package's.
"""

import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_writes import SCALE, _outcome, _runners  # noqa: E402

from presto_tpu import session as jax_session  # noqa: E402
from presto_tpu.config import EngineConfig as JaxConfig  # noqa: E402
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner  # noqa: E402
from presto_tpu_torch import session as torch_session  # noqa: E402
from presto_tpu_torch.config import EngineConfig  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402

PORTED = torch_session.SESSION_PROPERTIES
UNPORTED = torch_session.UNPORTED_PROPERTIES


def _show(runner):
    return runner.execute("SHOW SESSION").rows


def _ported_rows(rows):
    return [r for r in rows if r[0] in PORTED]


def test_ported_and_unported_make_the_jax_registry():
    assert not set(PORTED) & set(UNPORTED)
    assert set(PORTED) | set(UNPORTED) == set(
        jax_session.SESSION_PROPERTIES)
    assert (len(PORTED), len(UNPORTED)) == (20, 38)
    # every ported property sets a field this package's config has, under
    # the JAX package's name
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    for name, (field, _) in PORTED.items():
        assert field in fields
        assert field == jax_session.SESSION_PROPERTIES[name][0]


def test_show_session_matches_jax():
    jax_runner, torch_runner = _runners()
    assert _show(torch_runner) == _ported_rows(_show(jax_runner))
    assert [r[0] for r in _show(torch_runner)] == sorted(PORTED)


SET_RESET = [
    "set session task_concurrency = 2",
    "set session scan_batch_rows = 128",
    "set session dynamic_filtering_enabled = false",
    "set session join_distribution_type = 'broadcast'",
    "set session query_max_run_time_s = 30",
    "set session hash_groupby_enabled = off",
    "SHOW SESSION",
    "reset session scan_batch_rows",
    "reset session no_such_prop",
    "reset session spill_enabled",
    "SHOW SESSION",
    "select count(*) from nation",
]


def test_set_reset_show_matches_jax():
    jax_runner, torch_runner = _runners()
    for sql in SET_RESET:
        got, want = _outcome(torch_runner, sql), _outcome(jax_runner, sql)
        if sql == "SHOW SESSION":
            want = want[:3] + (_ported_rows(want[3]),)
        assert got == want, sql
    assert torch_runner.session.effective_config(
        torch_runner.config).task_concurrency == 2


@pytest.mark.parametrize("sql", [
    "set session no_such_prop = 1",
    "set session task_concurrency = banana",
    "set session join_distribution_type = 'sideways'",
    "set session join_reordering_strategy = 'greedy'",
    "set session query_max_run_time_s = 'soon'",
    "set session hash_groupby_init_slots = 1.5",
])
def test_bad_property_raises_as_jax(sql):
    jax_runner, torch_runner = _runners()
    got, want = _outcome(torch_runner, sql), _outcome(jax_runner, sql)
    assert got == want
    assert got[:2] == ("error", "SessionError")


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_property_names_its_roadmap_item(name):
    s = torch_session.Session()
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP {UNPORTED[name][:3]}"):
        s.set_property(name, "1")
    assert not s.properties
    # the JAX package takes the same statement
    jax_session.Session().set_property(
        name, "automatic" if name == "mesh_resume_mode" else "1")


# a property that steers execution, set on both sides: (SET statement,
# query, ordered, check of the port's operator stats)
STEERING = {
    "direct_groupby_max_domain": (
        "set session direct_groupby_max_domain = 2",
        "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
        "from lineitem group by 1, 2 order by 1, 2", True,
        ("tier", "HashAggregationOperator", {"sort"}, {"direct"})),
    "dynamic_filtering_enabled": (
        "set session dynamic_filtering_enabled = false",
        "select n_name, count(*) from customer, nation "
        "where c_nationkey = n_nationkey and n_regionkey = 1 "
        "group by n_name order by n_name", True,
        ("operator", "DynamicFilterOperator")),
    "hash_groupby_min_rows": (
        "set session hash_groupby_min_rows = 0",
        "select l_partkey, count(*), sum(l_quantity) from lineitem "
        "group by l_partkey", False,
        ("tier", "HashAggregationOperator", {"hash"}, {"sort"})),
    "streaming_aggregation_enabled": (
        "set session streaming_aggregation_enabled = false",
        "select l_orderkey, count(*) from lineitem group by l_orderkey "
        "order by 2 desc, 1 limit 5", True,
        ("operator", "StreamingAggregationOperator")),
    "task_concurrency": (
        "set session task_concurrency = 1",
        "select o_orderpriority, sum(o_totalprice) from orders "
        "group by 1 order by 1", True,
        ("operator", "feed")),
}


def _has(stats, check) -> bool:
    if check[0] == "operator":
        return any(check[1] in s.operator for s in stats)
    return {s.kernel_tier for s in stats
            if s.operator.endswith(check[1])} == check[3]


@pytest.mark.parametrize("name", sorted(STEERING))
def test_steering_property_matches_jax(name):
    set_sql, sql, ordered, check = STEERING[name]
    jax_runner, torch_runner = _runners()
    torch_runner.execute(sql)
    assert _has(torch_runner._last_task.operator_stats, check)
    for runner in (jax_runner, torch_runner):
        runner.execute(set_sql)
    got, want = torch_runner.execute(sql), jax_runner.execute(sql)
    stats = torch_runner._last_task.operator_stats
    if check[0] == "operator":
        assert not _has(stats, check)
    else:
        assert {s.kernel_tier for s in stats
                if s.operator.endswith(check[1])} == check[2]
    key = (lambda r: r) if ordered else sorted
    assert len(got.rows) == len(want.rows)
    for g, w in zip(key(got.rows), key(want.rows)):
        assert g == pytest.approx(w, rel=1e-9, abs=0.0)
    assert torch_runner.explain(sql) == jax_runner.explain(sql)


def test_explain_follows_the_session_as_jax():
    jax_runner, torch_runner = _runners()
    sql = ("select count(*) from lineitem, orders, customer "
           "where l_orderkey = o_orderkey and o_custkey = c_custkey")
    before = torch_runner.explain(sql)
    for runner in (jax_runner, torch_runner):
        runner.execute("set session join_reordering_strategy = 'none'")
        runner.execute("set session optimizer_use_memo = false")
    assert torch_runner.explain(sql) == jax_runner.explain(sql)
    assert torch_runner.explain(sql) != before


def _flow(module, case):
    """One TransactionManager flow of tests/test_session.py:81-94; the
    events the actions recorded, the states and what stays open."""
    tm = module.TransactionManager()
    events = []
    txn = tm.begin()
    txn.commit_actions.append(lambda: events.append("commit"))
    txn.abort_actions.append(lambda: events.append("abort"))
    if case == "commit":
        tm.commit(txn)
    elif case == "abort":
        tm.abort(txn)
    elif case == "abort_after_commit":
        tm.commit(txn)
        tm.abort(txn)
    elif case == "commit_twice":
        tm.commit(txn)
        try:
            tm.commit(txn)
        except RuntimeError as e:
            events.append(str(e))
    elif case == "failing_abort_action":
        txn.abort_actions.insert(0, lambda: 1 / 0)
        tm.abort(txn)
    return events, txn.state, txn.auto_commit, len(tm.transactions)


@pytest.mark.parametrize("case", ["commit", "abort", "abort_after_commit",
                                  "commit_twice", "failing_abort_action"])
def test_transaction_manager_flow_matches_jax(case):
    assert _flow(torch_session, case) == _flow(jax_session, case)


def test_access_control_write_checks():
    """The write checks of the SPI surface: DELETE defaults to INSERT's
    check, RENAME to DROP's, and the runner calls them."""
    calls = []

    class Recording(torch_session.AllowAllAccessControl):
        def check_can_insert(self, user, catalog, table):
            calls.append(("insert", catalog, table))

        def check_can_drop_table(self, user, catalog, table):
            calls.append(("drop", catalog, table))

        def check_can_create_table(self, user, catalog, table):
            calls.append(("create", catalog, table))

        def notify_table_renamed(self, catalog, old, new):
            calls.append(("renamed", old, new))

    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu",
                                   access_control=Recording())
    for sql in ("create table memory.a (x bigint)",
                "insert into memory.a values (1)",
                "delete from memory.a",
                "alter table memory.a rename to b",
                "drop table memory.b"):
        runner.execute(sql)
    assert calls == [("create", "memory", "a"), ("insert", "memory", "a"),
                     ("insert", "memory", "a"), ("drop", "memory", "a"),
                     ("renamed", "a", "b"), ("drop", "memory", "b")]
    base = torch_session.AccessControl()
    with pytest.raises(NotImplementedError):
        base.check_can_delete("u", "memory", "a")


def test_runner_config_stays_when_session_is_reset():
    cfg = EngineConfig(task_concurrency=3)
    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu", config=cfg)
    jax_runner = JaxRunner.tpch(
        scale=SCALE, config=dataclasses.replace(JaxConfig(),
                                                task_concurrency=3))
    for r in (runner, jax_runner):
        r.execute("set session task_concurrency = 1")
        r.execute("reset session task_concurrency")
    assert runner.session.effective_config(runner.config) is cfg
    assert _show(runner) == _ported_rows(_show(jax_runner))
