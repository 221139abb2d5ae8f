"""Access-control parity: presto_tpu_torch against presto_tpu.

``GrantStore``, ``GrantAwareAccessControl`` (GRANT/REVOKE),
``RuleBasedAccessControl`` and ``SessionPropertyManager`` of the port
against the JAX package's: the same sequence of calls gives the same
answers, and the same SQL by the same users through both packages'
LocalQueryRunner (the port on the CPU, at TPC-H SF0.01) gives the same
rows, or the same exception type with the same message.  The cases are
drawn from tests/test_statements.py, tests/test_session.py and
tests/test_security.py.
"""

import pytest
from test_torch_writes import _assert_same, _outcome

from presto_tpu import session as JS
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner
from presto_tpu_torch import session as PS
from presto_tpu_torch.localrunner import LocalQueryRunner

SCALE = 0.01


def test_grant_store_matches_jax():
    """grant, revoke, has and rename_table: the same answers after every
    call of one sequence ('all' covers every privilege)."""
    calls = [
        ("grant", "bob", "memory", "t", ("select",)),
        ("grant", "bob", "memory", "t", ("insert", "delete")),
        ("revoke", "bob", "memory", "t", ("insert",)),
        ("grant", "amy", "memory", "u", ("all",)),
        ("revoke", "amy", "memory", "nope", ("select",)),
        ("rename_table", "memory", "t", "t2"),
        ("grant", "bob", "tpch", "t", ("select",)),
        ("revoke", "amy", "memory", "u", ("all",)),
    ]
    probes = [(u, c, t, p) for u in ("bob", "amy", "eve")
              for c in ("memory", "tpch") for t in ("t", "t2", "u")
              for p in ("select", "insert", "delete", "drop")]
    stores = JS.GrantStore(), PS.GrantStore()
    for call in calls:
        for s in stores:
            getattr(s, call[0])(*call[1:])
        answers = [[s.has(*p) for p in probes] for s in stores]
        assert answers[1] == answers[0], call
    assert sum(answers[1]) > 0


def _grant_runners(admin_user="admin"):
    """([admin, bob, mallory] of the JAX package, the same of the port):
    each package's three runners over one shared registry and grant
    store, as tests/test_statements.py::test_grant_revoke_access_control
    builds them."""
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            ac = JS.GrantAwareAccessControl()
            admin = JaxRunner.tpch(scale=SCALE, access_control=ac,
                                   session=JS.Session(user=admin_user))
            users = [JaxRunner(admin.registry, "tpch", admin.config,
                               session=JS.Session(user=u),
                               access_control=ac)
                     for u in ("bob", "mallory")]
        else:
            ac = PS.GrantAwareAccessControl()
            admin = LocalQueryRunner.tpch(
                scale=SCALE, access_control=ac,
                session=PS.Session(user=admin_user), device="cpu")
            users = [LocalQueryRunner(admin.registry, "tpch", admin.config,
                                      session=PS.Session(user=u),
                                      access_control=ac, device="cpu")
                     for u in ("bob", "mallory")]
        assert ac.grants is admin.grants
        for u in users:
            u.grants = admin.grants
        out.append([admin] + users)
    return out


# (who, SQL): GRANT/REVOKE and the five checks (SELECT, INSERT, CREATE,
# DROP, DELETE) under GrantAwareAccessControl; tests/test_statements.py::
# test_grant_revoke_access_control and ::test_grant_requires_authority
GRANT_SCRIPT = [
    ("admin", "CREATE TABLE memory.sec (a bigint)"),
    ("admin", "INSERT INTO memory.sec VALUES (1), (2)"),
    ("bob", "SELECT * FROM memory.sec"),
    ("admin", "GRANT SELECT ON memory.sec TO bob"),
    ("bob", "SELECT * FROM memory.sec ORDER BY a"),
    ("bob", "INSERT INTO memory.sec VALUES (3)"),
    ("bob", "DELETE FROM memory.sec"),
    ("admin", "GRANT INSERT, DELETE ON memory.sec TO bob"),
    ("bob", "INSERT INTO memory.sec VALUES (3)"),
    ("bob", "DELETE FROM memory.sec WHERE a = 1"),
    ("bob", "SELECT * FROM memory.sec ORDER BY a"),
    ("bob", "DROP TABLE memory.sec"),
    ("admin", "REVOKE SELECT ON memory.sec FROM bob"),
    ("bob", "SELECT * FROM memory.sec"),
    ("bob", "INSERT INTO memory.sec VALUES (4)"),
    # a table's creator owns it
    ("bob", "CREATE TABLE memory.bobs (x bigint)"),
    ("bob", "INSERT INTO memory.bobs VALUES (7)"),
    ("mallory", "SELECT * FROM memory.bobs"),
    ("bob", "GRANT ALL ON memory.bobs TO mallory"),
    ("mallory", "SELECT * FROM memory.bobs"),
    ("mallory", "DELETE FROM memory.bobs"),
    ("mallory", "DROP TABLE memory.bobs"),
    # self-granting is denied; creating over an existing table steals no
    # ownership
    ("mallory", "GRANT ALL ON memory.sec TO mallory"),
    ("mallory", "CREATE TABLE memory.sec (x bigint)"),
    ("mallory", "DROP TABLE memory.sec"),
    # RENAME needs ownership and carries the grants
    ("admin", "GRANT SELECT ON memory.sec TO mallory"),
    ("mallory", "ALTER TABLE memory.sec RENAME TO h"),
    ("admin", "ALTER TABLE memory.sec RENAME TO h"),
    ("mallory", "SELECT count(*) FROM memory.h"),
    ("mallory", "SELECT count(*) FROM memory.sec"),
    ("bob", "INSERT INTO memory.h VALUES (5)"),
    ("bob", "SELECT * FROM memory.h"),
    ("admin", "DROP TABLE memory.h"),
    ("mallory", "SELECT count(*) FROM memory.h"),
]


def test_grant_aware_access_control_matches_jax():
    jax, port = _grant_runners()
    users = {"admin": 0, "bob": 1, "mallory": 2}
    denied = 0
    for who, sql in GRANT_SCRIPT:
        i = users[who]
        want = _outcome(jax[i], sql)
        _assert_same(_outcome(port[i], sql), want, f"{who}: {sql}")
        denied += want[:2] == ("error", "AccessDeniedError")
    assert denied >= 10


def test_rename_carries_grants():
    """After a RENAME the grantee reads the new name, in the runner's
    GrantStore, with the table's owner unchanged."""
    _jax, (admin, bob, _mallory) = _grant_runners()
    admin.execute("CREATE TABLE memory.r1 (a bigint)")
    admin.execute("GRANT SELECT ON memory.r1 TO bob")
    admin.execute("ALTER TABLE memory.r1 RENAME TO r2")
    assert admin.grants.has("bob", "memory", "r2", "select")
    assert not admin.grants.has("bob", "memory", "r1", "select")
    assert bob.execute("SELECT count(*) FROM memory.r2").rows == [(0,)]
    with pytest.raises(PS.AccessDeniedError):
        bob.execute("DROP TABLE memory.r2")


# tests/test_session.py::TestAccessControl's rules, and patterns
RULES = [
    {"user": "admin", "privileges": ["select", "insert", "create", "drop",
                                     "delete", "grant"]},
    {"user": "reader", "catalog": "tpch", "privileges": ["select"]},
    {"user": "etl_*", "catalog": "memory", "table": "stage_*",
     "privileges": ["select", "insert", "create", "delete"]},
    {"user": "etl_*", "catalog": "memory", "privileges": ["select"]},
]

RULE_SCRIPT = [
    ("admin", "select count(*) from nation"),
    ("admin", "create table memory.t (a bigint)"),
    ("admin", "insert into memory.t values (1)"),
    ("admin", "create table memory.stage_1 (a bigint)"),
    ("reader", "select count(*) from nation"),
    ("reader", "select count(*) from memory.t"),
    ("reader", "create table memory.t2 (a bigint)"),
    ("reader", "insert into memory.t values (2)"),
    ("etl_nightly", "insert into memory.stage_1 values (5)"),
    ("etl_nightly", "select * from memory.stage_1"),
    ("etl_nightly", "select * from memory.t"),
    ("etl_nightly", "insert into memory.t values (3)"),
    ("etl_nightly", "delete from memory.stage_1"),
    ("etl_nightly", "drop table memory.stage_1"),
    ("etl_nightly", "select count(*) from nation"),
    ("etl_x", "create table memory.stage_2 (a bigint)"),
    ("stranger", "select count(*) from nation"),
    ("reader", "grant select on tpch.nation to stranger"),
    ("admin", "grant select on memory.t to stranger"),
    ("admin", "drop table memory.t"),
]


def test_rule_based_access_control_matches_jax():
    """First matching rule decides, no match denies, '*' patterns; the
    denial messages are the JAX package's."""
    jax = JaxRunner.tpch(scale=SCALE, session=JS.Session(user="admin"),
                         access_control=JS.RuleBasedAccessControl(RULES))
    port = LocalQueryRunner.tpch(
        scale=SCALE, session=PS.Session(user="admin"), device="cpu",
        access_control=PS.RuleBasedAccessControl(RULES))
    denied = 0
    for who, sql in RULE_SCRIPT:
        jax.session.user = port.session.user = who
        want = _outcome(jax, sql)
        _assert_same(_outcome(port, sql), want, f"{who}: {sql}")
        denied += want[:2] == ("error", "AccessDeniedError")
    assert denied >= 7


MANAGER_RULES = [
    {"user": "*", "properties": {"task_concurrency": 2}},
    {"user": "etl_*", "source": "cron*",
     "properties": {"scan_batch_rows": 4096, "task_concurrency": 8}},
    {"user": "etl_*", "properties": {"hash_groupby_enabled": "false"}},
]


@pytest.mark.parametrize("user,source,preset", [
    ("etl_nightly", "cron-job", None),
    ("etl_nightly", "", None),
    ("adhoc", "cron-job", None),
    # an explicit SET SESSION wins over the rules
    ("etl_x", "cron-job", ("task_concurrency", "1")),
])
def test_session_property_manager_matches_jax(user, source, preset):
    sessions = []
    for S in (JS, PS):
        s = S.Session(user=user)
        if preset:
            s.set_property(*preset)
        S.SessionPropertyManager(MANAGER_RULES).apply(s, source)
        sessions.append(s)
    assert sessions[1].properties == sessions[0].properties
    assert (JS.SessionPropertyManager(MANAGER_RULES).defaults_for(user, source)
            == PS.SessionPropertyManager(MANAGER_RULES).defaults_for(
                user, source))


def test_runner_applies_session_property_manager():
    """The runner's constructor applies the rules to its session
    (tests/test_security.py::test_runner_with_property_manager); SET
    SESSION still overrides them, and SHOW SESSION shows the same rows
    as the JAX package's for the properties the port has."""
    mgr = [{"user": "*", "properties": {"scan_batch_rows": 1234,
                                         "task_concurrency": 1}}]
    jax = JaxRunner(JaxRunner.tpch(scale=SCALE).registry, "tpch",
                    session=JS.Session(user="u"),
                    session_property_manager=JS.SessionPropertyManager(mgr))
    port = LocalQueryRunner(
        LocalQueryRunner.tpch(scale=SCALE, device="cpu").registry, "tpch",
        session=PS.Session(user="u"), device="cpu",
        session_property_manager=PS.SessionPropertyManager(mgr))
    for sql in ("select count(*) from lineitem",
                "set session scan_batch_rows = 999",
                "select count(*) from lineitem"):
        _assert_same(_outcome(port, sql), _outcome(jax, sql), sql)

    def shown(r):
        return {n: (v, d) for n, v, d in r.session.show_properties(r.config)}

    got, want = shown(port), shown(jax)
    assert got["scan_batch_rows"] == ("999", want["scan_batch_rows"][1])
    assert got["task_concurrency"][0] == "1"
    assert {n: want[n] for n in got} == got


def test_unported_property_in_a_rule_names_its_item():
    """A rule naming a property whose feature the port lacks raises as SET
    SESSION of it does."""
    s = PS.Session(user="etl_x")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        PS.SessionPropertyManager(
            [{"user": "*", "properties": {"spill_enabled": "true"}}]
        ).apply(s)


def test_explain_analyze_checks_access():
    """ROADMAP C8: the JAX package's EXPLAIN ANALYZE runs a query its user
    may not SELECT; the port checks the scans first and raises the
    SELECT's denial."""
    jax, port = _grant_runners()
    sql = "EXPLAIN ANALYZE SELECT count(*) FROM memory.sec"
    for admin in (jax[0], port[0]):
        admin.execute("CREATE TABLE memory.sec (a bigint)")
    want = _outcome(port[1], "SELECT count(*) FROM memory.sec")
    assert want[:2] == ("error", "AccessDeniedError")
    assert _outcome(port[1], sql) == want
    assert _outcome(jax[1], sql)[0] == "rows"
