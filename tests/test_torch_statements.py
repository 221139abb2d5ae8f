"""Statement parity: presto_tpu_torch against presto_tpu at TPC-H SF0.01.

The statements beyond queries and writes go through both packages'
LocalQueryRunner (the port on the CPU): views (CREATE [OR REPLACE],
DROP [IF EXISTS], SHOW CREATE VIEW, the recursion and "not a query"
errors), prepared statements (PREPARE, EXECUTE ... USING, DEALLOCATE,
DESCRIBE INPUT/OUTPUT), SHOW CATALOGS/SCHEMAS/FUNCTIONS, the
``information_schema`` and ``system`` catalogs, CALL
system.runtime.kill_query, EXPLAIN (TYPE IO | VALIDATE) and EXPLAIN
ANALYZE.  Every step must give the same column names, types and rows
(exactly: these statements return keys, counts and text), or raise the
same exception type with the same message.  The cases are drawn from
tests/test_statements.py and the kill_query case of tests/test_overload.py.

EXPLAIN ANALYZE runs both sides with ``task_concurrency = 1`` and the JAX
package's pipeline fusion off (the port has none, ROADMAP S7), so the two
operator tables name the same operators; their rows must be equal, and
their walls are not compared.
"""

import re

import pytest
from test_torch_writes import _assert_same, _outcome, _runners

from presto_tpu.config import EngineConfig as JaxConfig
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner
from presto_tpu_torch.config import EngineConfig
from presto_tpu_torch.localrunner import LocalQueryRunner
from tpch_queries import QUERIES

SCALE = 0.01


def _run(script, runners=None):
    runners = runners or _runners()
    for step in script:
        sql, ordered = (step, True) if isinstance(step, str) else step
        _assert_same(_outcome(runners[1], sql), _outcome(runners[0], sql),
                     sql, ordered)
    return runners


SCRIPTS = {
    # tests/test_statements.py::test_views
    "views": [
        "CREATE VIEW v_nation AS SELECT n_name, n_regionkey FROM "
        "tpch.nation WHERE n_regionkey = 1",
        "SELECT count(*) FROM v_nation",
        "SELECT n_name FROM v_nation ORDER BY n_name",
        "CREATE VIEW v2 AS SELECT n_name FROM v_nation",
        "SELECT * FROM v2 v WHERE v.n_name LIKE '%A%' ORDER BY 1",
        "SHOW CREATE VIEW v_nation",
        "SHOW TABLES LIKE 'v%'",
        "CREATE VIEW v_nation AS SELECT 1 AS x",
        "CREATE OR REPLACE VIEW v_nation AS SELECT 1 AS x",
        "SELECT * FROM v_nation",
        "DROP VIEW v2",
        "DROP VIEW v_nation",
        "DROP VIEW IF EXISTS v_nation",
        "DROP VIEW v_nation",
        "SHOW CREATE VIEW v_nation",
    ],
    # a view over a join, and a view in the memory catalog over a table
    # that changes under it
    "view_over_join": [
        "CREATE VIEW nr AS SELECT n_name, r_name FROM nation, region "
        "WHERE n_regionkey = r_regionkey",
        "SELECT r_name, count(*) FROM nr GROUP BY r_name ORDER BY r_name",
        "SELECT n_name FROM nr WHERE r_name = 'ASIA' ORDER BY n_name",
        "CREATE TABLE memory.base (a bigint)",
        "INSERT INTO memory.base VALUES (1), (2)",
        "CREATE VIEW memory.dbl AS SELECT a * 2 AS b FROM memory.base",
        "SELECT b FROM memory.dbl ORDER BY b",
        "INSERT INTO memory.base VALUES (3)",
        "SELECT sum(b) FROM memory.dbl",
        "SHOW TABLES FROM memory",
    ],
    # tests/test_statements.py::test_prepare_execute_deallocate and
    # ::test_parameters_in_projection: 0, 1 and 3 parameters
    "prepared": [
        "PREPARE q0 FROM SELECT count(*) FROM tpch.nation",
        "EXECUTE q0",
        "DESCRIBE INPUT q0",
        "PREPARE q1 FROM SELECT n_name FROM tpch.nation "
        "WHERE n_nationkey < ? ORDER BY n_nationkey",
        "EXECUTE q1 USING 3",
        "EXECUTE q1 USING 5",
        "DESCRIBE INPUT q1",
        "DESCRIBE OUTPUT q1",
        "PREPARE q3 FROM SELECT ? + n_nationkey, n_name FROM tpch.nation "
        "WHERE n_regionkey = ? AND n_name > ? ORDER BY 2",
        "EXECUTE q3 USING 100, 1, 'B'",
        "DESCRIBE INPUT q3",
        "DESCRIBE OUTPUT q3",
        # the wrong parameter count
        "EXECUTE q3 USING 100, 1",
        "EXECUTE q1 USING 1, 2",
        "DEALLOCATE PREPARE q1",
        "EXECUTE q1 USING 1",
        "DEALLOCATE PREPARE nope",
        "DESCRIBE OUTPUT nope",
        # re-PREPARE under the same name
        "PREPARE q0 FROM SELECT n_name FROM tpch.nation WHERE "
        "n_nationkey = 7",
        "EXECUTE q0",
    ],
    # DESCRIBE of an INSERT and a CTAS, and EXECUTE of a write
    "prepared_writes": [
        "CREATE TABLE memory.pw (a bigint, s varchar)",
        "PREPARE ins FROM INSERT INTO memory.pw VALUES (?, ?)",
        "DESCRIBE INPUT ins",
        "DESCRIBE OUTPUT ins",
        "EXECUTE ins USING 1, 'x'",
        "EXECUTE ins USING 2, 'y'",
        "SELECT * FROM memory.pw ORDER BY a",
        "PREPARE ctas FROM CREATE TABLE memory.pc AS SELECT n_name FROM "
        "tpch.nation WHERE n_regionkey = ?",
        "DESCRIBE INPUT ctas",
        "DESCRIBE OUTPUT ctas",
        "EXECUTE ctas USING 2",
        "SELECT count(*) FROM memory.pc",
        "PREPARE del FROM DELETE FROM memory.pw WHERE a = ?",
        "DESCRIBE OUTPUT del",
        "EXECUTE del USING 1",
        "SELECT * FROM memory.pw",
    ],
    # tests/test_statements.py::test_show_catalogs,
    # ::test_show_schemas_and_functions, ::test_show_functions_excludes_
    # internal_names
    "catalogs": [
        "SHOW CATALOGS",
        "SHOW CATALOGS LIKE 'tp%'",
        "SHOW CATALOGS LIKE '%schema%'",
        "SHOW SCHEMAS",
        "SHOW SCHEMAS FROM memory",
        "SHOW SCHEMAS LIKE 'def%'",
        "SHOW SCHEMAS FROM nocatalog",
        "SHOW FUNCTIONS",
        "SHOW FUNCTIONS LIKE 'json%'",
        "SHOW FUNCTIONS LIKE 'approx_%'",
        "SHOW FUNCTIONS LIKE 'st\\_%'",
    ],
    # the virtual catalogs over the live registry
    "information_schema": [
        "SELECT table_catalog, table_schema, table_name, table_type FROM "
        "information_schema.tables WHERE table_catalog IN ('tpch', "
        "'system', 'information_schema') ORDER BY 1, 3",
        "SELECT count(*) FROM information_schema.columns WHERE "
        "table_catalog = 'tpch'",
        "SELECT table_name, column_name, ordinal_position, data_type FROM "
        "information_schema.columns WHERE table_catalog = 'tpch' AND "
        "table_name IN ('nation', 'orders') ORDER BY 1, 3",
        "CREATE TABLE memory.isc AS SELECT n_nationkey, n_name, "
        "CAST(n_regionkey AS double) AS d FROM tpch.nation",
        "SELECT * FROM information_schema.tables WHERE table_catalog = "
        "'memory'",
        "SELECT column_name, ordinal_position, data_type FROM "
        "information_schema.columns WHERE table_name = 'isc' ORDER BY 2",
        "SELECT table_catalog, count(*) FROM information_schema.tables "
        "GROUP BY 1 ORDER BY 1",
        "SELECT * FROM system.nodes",
        "SELECT node_id, coordinator FROM system.nodes WHERE "
        "state = 'ACTIVE'",
        "SELECT count(*) FROM system.queries",
        "SHOW TABLES FROM system",
        "SHOW COLUMNS FROM system.nodes",
        "SELECT * FROM information_schema.nope",
    ],
    # tests/test_overload.py::test_kill_query_local_tier: every error
    "kill_query": [
        "SELECT count(*) FROM nation",
        "CALL system.runtime.kill_query('local-1', 'be gone')",
        "CALL system.runtime.kill_query('local-2')",
        "CALL kill_query('local-1', '')",
        "CALL system.runtime.kill_query('nope')",
        # this runner's 6th statement: killing its own id
        "CALL system.runtime.kill_query('local-6')",
        "CALL system.runtime.not_a_proc('x')",
        "CALL system.runtime.kill_query(1)",
        "CALL system.runtime.kill_query()",
        "CALL system.runtime.kill_query('local-1', 2)",
    ],
    # tests/test_statements.py::test_explain_types (its DISTRIBUTED
    # case is ROADMAP A13 here)
    "explain_io": [
        "EXPLAIN (TYPE IO) SELECT n_name FROM tpch.nation",
        "EXPLAIN (TYPE IO) SELECT l_orderkey, o_orderdate FROM lineitem, "
        "orders WHERE l_orderkey = o_orderkey AND o_custkey < 10",
        "EXPLAIN (TYPE IO) SELECT count(*) FROM nation n1, nation n2 "
        "WHERE n1.n_regionkey = n2.n_nationkey",
        "EXPLAIN (TYPE IO) SELECT * FROM system.nodes",
        "EXPLAIN (TYPE IO) SELECT 1",
        "EXPLAIN (TYPE IO) CREATE TABLE memory.x (a bigint)",
    ],
    # tests/test_statements.py::test_explain_validate_checks_dml, for
    # every statement kind the validation handles
    "explain_validate": [
        "EXPLAIN (TYPE VALIDATE) SELECT 1",
        "EXPLAIN (TYPE VALIDATE) SELECT no_such_col FROM tpch.nation",
        "EXPLAIN (TYPE VALIDATE) SELECT * FROM no_such_table",
        "EXPLAIN (TYPE VALIDATE) INSERT INTO memory.no_such_table "
        "VALUES (1)",
        "CREATE TABLE memory.val_t (a bigint)",
        "EXPLAIN (TYPE VALIDATE) INSERT INTO memory.val_t VALUES (1)",
        "EXPLAIN (TYPE VALIDATE) INSERT INTO memory.val_t SELECT "
        "n_nationkey FROM nation",
        "EXPLAIN (TYPE VALIDATE) INSERT INTO memory.val_t SELECT nope "
        "FROM nation",
        "SELECT count(*) FROM memory.val_t",
        "EXPLAIN (TYPE VALIDATE) CREATE TABLE memory.v2 AS SELECT * FROM "
        "nation",
        "EXPLAIN (TYPE VALIDATE) CREATE TABLE memory.v2 AS SELECT nope "
        "FROM nation",
        "EXPLAIN (TYPE VALIDATE) CREATE TABLE memory.v3 (a bigint, "
        "b varchar)",
        "EXPLAIN (TYPE VALIDATE) CREATE TABLE memory.v3 (a nosuchtype)",
        "EXPLAIN (TYPE VALIDATE) DELETE FROM memory.val_t",
        "EXPLAIN (TYPE VALIDATE) DELETE FROM memory.nope",
        "EXPLAIN (TYPE VALIDATE) SHOW STATS FOR memory.val_t",
        "EXPLAIN (TYPE VALIDATE) ANALYZE memory.nope",
        "EXPLAIN (TYPE VALIDATE) DROP TABLE memory.nope",
        "EXPLAIN (TYPE VALIDATE) DROP TABLE IF EXISTS memory.nope",
        "EXPLAIN (TYPE VALIDATE) ALTER TABLE memory.nope RENAME TO x",
        "EXPLAIN (TYPE VALIDATE) SET SESSION task_concurrency = 2",
        "SHOW TABLES FROM memory",
        "EXPLAIN (TYPE BOGUS) SELECT 1",
        "EXPLAIN ANALYZE CREATE TABLE memory.ea (a bigint)",
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_statement_scripts_match_jax(name):
    _run(SCRIPTS[name])


@pytest.mark.parametrize("views,query", [
    # tests/test_statements.py::test_recursive_view_rejected
    ({"rv": "SELECT * FROM rv"}, "SELECT * FROM rv"),
    # ::test_mutually_recursive_views_rejected
    ({"va": "SELECT * FROM vb", "vb": "SELECT * FROM va"},
     "SELECT * FROM va"),
    # a stored view whose text is not a query
    ({"vi": "INSERT INTO memory.t VALUES (1)"}, "SELECT * FROM vi"),
    ({"vo": "SELECT n_name FROM nation WHERE n_nationkey = 0"},
     "SELECT * FROM vo"),
])
def test_stored_view_errors_match_jax(views, query):
    runners = _runners()
    for r in runners:
        for name, sql in views.items():
            r.registry.views[("tpch", name)] = sql
    _assert_same(_outcome(runners[1], query), _outcome(runners[0], query),
                 query)


class _Recorder:
    def __init__(self):
        self.killed = []
        self.completed = []

    def query_created(self, event):
        pass

    def query_completed(self, event):
        self.completed.append(event)

    def query_killed(self, event):
        self.killed.append(event)


def test_kill_query_events_match_jax():
    """The QueryKilledEvent's fields (its time aside) equal the JAX
    package's, the error name ADMINISTRATIVELY_KILLED."""
    runners = _runners()
    recs = [_Recorder(), _Recorder()]
    for r, rec in zip(runners, recs):
        r.event_bus.register(rec)
    _run(SCRIPTS["kill_query"], runners)

    def fields(rec):
        return [(k.query_id, k.trace_token, k.user, k.reason, k.error_name,
                 k.message) for k in rec.killed]

    assert fields(recs[1]) == fields(recs[0])
    assert [k[4] for k in fields(recs[1])] == ["ADMINISTRATIVELY_KILLED"] * 3
    assert [k[5] for k in fields(recs[1])] == [
        "Query killed via kill_query: be gone", "Query killed via "
        "kill_query", "Query killed via kill_query"]


def _split_analyze(lines):
    """(plan lines, header lines, [(operator, in, out)], footer kinds,
    [(driver, operators, in, out)]) of an EXPLAIN ANALYZE text."""
    i = lines.index("Operator stats:")
    plan, header = lines[:i], lines[i + 1:i + 3]
    ops, drivers, footer = [], [], []
    for line in lines[i + 3:]:
        m = re.match(r"(\S+)\s+(\d+)\s+(\d+)\s+[\d.]+\s+[\d.]+\s+[\d.]+"
                     r"\s+\d+\s+\d+\s+\d+$", line)
        d = re.match(r"driver (\S+): (\d+) operators, (\d+) -> (\d+) rows, "
                     r"[\d.]+ ms$", line)
        if m:
            ops.append((m.group(1), int(m.group(2)), int(m.group(3))))
        elif d:
            drivers.append(d.groups())
        elif line.startswith("  "):
            footer.append("hot operator")   # ranked by wall: not compared
        else:
            footer.append(re.sub(r"[\d.]+", "#", line.split(":")[0]))
    return plan, header, ops, footer, drivers


@pytest.mark.parametrize("q", [1, 3, 18])
def test_explain_analyze_matches_jax(q):
    """EXPLAIN ANALYZE of TPC-H Q1, Q3 and Q18: the same plan text, the
    same table header, the same operators with the same input and output
    rows, the same footer lines and drivers; and the completion event
    carries the analyzed task's operator stats, as the JAX package's."""
    jax = JaxRunner.tpch(scale=SCALE, config=JaxConfig(
        pipeline_fusion=False, task_concurrency=1))
    port = LocalQueryRunner.tpch(scale=SCALE, device="cpu",
                                 config=EngineConfig(task_concurrency=1))
    recs = [_Recorder(), _Recorder()]
    got = []
    for r, rec in zip((jax, port), recs):
        r.event_bus.register(rec)
        res = r.execute("EXPLAIN ANALYZE " + QUERIES[q])
        assert res.column_names == ["Query Plan"]
        got.append(_split_analyze([row[0] for row in res.rows]))
    (jplan, jhead, jops, jfoot, jdrv), (plan, head, ops, foot, drv) = got
    assert plan == jplan
    assert head == jhead
    assert ops == jops and len(ops) > 5
    # JAX's own kernel-cache line has no counterpart (kernelcache.py is
    # not ported: eager torch compiles nothing)
    assert foot == [f for f in jfoot if not f.startswith("kernel caches")]
    assert drv == jdrv
    want = [(s["operator"], s["input_rows"], s["output_rows"])
            for s in recs[0].completed[-1].operator_stats]
    assert [(s["operator"], s["input_rows"], s["output_rows"])
            for s in recs[1].completed[-1].operator_stats] == want == ops
    # the analyzed query's last operator took the query's rows
    assert ops[-1][1] == len(port.execute(QUERIES[q]).rows)


def test_explain_analyze_refuses_what_is_not_a_query():
    _run(["EXPLAIN ANALYZE SHOW CATALOGS",
          "EXPLAIN ANALYZE SELECT nope FROM nation"])
