"""Write-path parity: presto_tpu_torch against presto_tpu at TPC-H SF0.01.

The same statement scripts go through both packages' LocalQueryRunner
(the port on the CPU): CREATE TABLE [AS], INSERT (VALUES, SELECT, a column
list, casts), DELETE, DROP/RENAME and their IF [NOT] EXISTS forms, ANALYZE
and SHOW STATS, SHOW TABLES/COLUMNS/CREATE TABLE, USE, transactions and
the blackhole sink.  Every step must give the same column names, types
and rows, or raise the same exception type with the same message.

A memory table's batch order follows the feed threads of the local
exchange, so stored tables compare as multisets of rows and float
aggregates over them to 1e-9 relative; with ``task_concurrency = 1`` on
both sides they are bit-equal.  The two packages are always compared on
the same catalog: a memory table's stats differ from the tpch table's,
and so may its plan.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tpch_queries import QUERIES  # noqa: E402

from presto_tpu.localrunner import LocalQueryRunner as JaxRunner  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402

SCALE = 0.01


def _runners():
    return (JaxRunner.tpch(scale=SCALE),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu"))


def _outcome(runner, sql):
    try:
        res = runner.execute(sql)
    except Exception as e:  # noqa: BLE001 - the exception is the outcome
        return ("error", type(e).__name__, str(e))
    return ("rows", res.column_names,
            [typ.display() for typ in res.column_types], res.rows)


def _key(row):
    return tuple((x is None, str(x)) for x in row)


def _assert_same(got, want, sql, ordered=True, exact=True):
    """Two outcomes equal: the same error, or the same names, types and
    rows (as multisets unless ``ordered``; doubles to 1e-9 relative
    unless ``exact``)."""
    assert got[:3] == want[:3], sql
    if got[0] == "error":
        return
    g, w = got[3], want[3]
    assert len(g) == len(w), sql
    if not ordered:
        g, w = sorted(g, key=_key), sorted(w, key=_key)
    if exact:
        assert g == w, sql
        return
    for gr, wr in zip(g, w):
        for x, y in zip(gr, wr):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0), sql
            else:
                assert x == y and type(x) is type(y), sql


def _run_script(script, runners=None):
    runners = runners or _runners()
    for step in script:
        sql, ordered = (step, True) if isinstance(step, str) else step
        _assert_same(_outcome(runners[1], sql), _outcome(runners[0], sql),
                     sql, ordered)
    return runners


# statement scripts; a step is SQL, or (SQL, ordered) where the rows come
# back in the stored order, which the SQL does not fix
SCRIPTS = {
    # tests/test_statements.py::test_delete_and_analyze_stats
    "delete_and_analyze": [
        "CREATE TABLE memory.d (a bigint, s varchar)",
        "INSERT INTO memory.d VALUES (1,'x'),(2,'y'),(3,NULL),(4,'w'),"
        "(5,'x')",
        "DELETE FROM memory.d WHERE a % 2 = 0",
        "SELECT count(*) FROM memory.d",
        # NULL predicate rows are not deleted
        "DELETE FROM memory.d WHERE s = 'nope'",
        "ANALYZE memory.d",
        "SHOW STATS FOR memory.d",
        "DELETE FROM memory.d",
        "SELECT count(*) FROM memory.d",
    ],
    # tests/test_statements.py::test_transactions
    "transactions": [
        "CREATE TABLE memory.tx (a bigint)",
        "INSERT INTO memory.tx VALUES (1)",
        "START TRANSACTION",
        "INSERT INTO memory.tx VALUES (2)",
        "SELECT count(*) FROM memory.tx",
        "ROLLBACK",
        "SELECT count(*) FROM memory.tx",
        "START TRANSACTION",
        "INSERT INTO memory.tx VALUES (3)",
        "COMMIT",
        "SELECT a FROM memory.tx ORDER BY a",
        "COMMIT",
        "ROLLBACK",
        "START TRANSACTION",
        "START TRANSACTION",
        "ROLLBACK",
    ],
    # tests/test_statements.py::test_use_and_rename
    "use_and_rename": [
        "USE memory",
        "CREATE TABLE ren (a bigint)",
        "ALTER TABLE ren RENAME TO ren2",
        "SHOW TABLES",
        "USE tpch",
        "SHOW TABLES",
        "SHOW TABLES LIKE 'n%'",
        "USE nocatalog",
    ],
    # tests/test_statements.py::test_if_exists_variants and
    # test_drop_if_exists_unknown_catalog
    "if_exists": [
        "DROP TABLE IF EXISTS memory.nope",
        "CREATE TABLE memory.ife (a bigint)",
        "CREATE TABLE IF NOT EXISTS memory.ife (a bigint)",
        "CREATE TABLE memory.ife (a bigint)",
        "CREATE TABLE IF NOT EXISTS memory.ife AS SELECT 1 AS a",
        "DROP TABLE memory.ife",
        "DROP TABLE memory.ife",
        "DROP TABLE IF EXISTS nocatalog.t",
    ],
    # tests/test_session.py::TestTransactions::test_failed_insert_aborts
    "failed_insert_aborts": [
        "create table memory.t (a bigint)",
        "insert into memory.t select no_col from nation",
        "select count(*) from memory.t",
        "start transaction",
        "insert into memory.t select n_nationkey from nation",
        "insert into memory.t select no_col from nation",
        "commit",
        "select count(*) from memory.t",
    ],
    "insert_columns_and_casts": [
        "CREATE TABLE memory.c (a bigint, b double, s varchar, d date)",
        "INSERT INTO memory.c (s, a) VALUES ('x', 1), ('y', 2)",
        "INSERT INTO memory.c SELECT n_nationkey, n_regionkey, n_name, "
        "date '1995-01-01' FROM nation WHERE n_nationkey < 5",
        "INSERT INTO memory.c (b, d) VALUES (1, date '1996-02-29')",
        "INSERT INTO memory.c (a) VALUES (1, 2)",
        "INSERT INTO memory.nope VALUES (1)",
        "SELECT a, b, s, d FROM memory.c ORDER BY a, b",
        "SELECT count(*), count(a), count(b), count(s), count(d), sum(b) "
        "FROM memory.c",
        "DESCRIBE memory.c",
        "SHOW COLUMNS FROM memory.c",
        "SHOW CREATE TABLE memory.c",
    ],
    "rename_errors": [
        "CREATE TABLE memory.r1 (a bigint)",
        "CREATE TABLE memory.r2 (a bigint)",
        "ALTER TABLE memory.nope RENAME TO r3",
        "ALTER TABLE memory.r1 RENAME TO r2",
        "ALTER TABLE memory.r1 RENAME TO blackhole.r3",
        "ALTER TABLE memory.r1 RENAME TO memory.r3",
        "SHOW TABLES FROM memory",
        "SELECT count(*) FROM memory.r1",
    ],
    "blackhole": [
        "CREATE TABLE blackhole.sink AS SELECT * FROM lineitem",
        "INSERT INTO blackhole.sink SELECT * FROM lineitem "
        "WHERE l_returnflag = 'R'",
        "SELECT count(*) FROM blackhole.sink",
        "SHOW TABLES FROM blackhole",
        "SHOW COLUMNS FROM blackhole.sink",
        "DROP TABLE blackhole.sink",
        "SHOW TABLES FROM blackhole",
    ],
    "use_memory_unqualified": [
        "USE memory",
        "CREATE TABLE u AS SELECT * FROM tpch.nation",
        "SHOW TABLES",
        "SELECT count(*), sum(n_regionkey) FROM u",
        ("SELECT n_name FROM u WHERE n_regionkey = 1", False),
        "SHOW COLUMNS FROM u",
        "SHOW CREATE TABLE u",
        "INSERT INTO u SELECT * FROM u",
        "SELECT n_name, count(*) FROM u GROUP BY n_name ORDER BY n_name",
        "DROP TABLE u",
        "SHOW TABLES",
    ],
    "delete_null_then_full": [
        "CREATE TABLE memory.dn (a bigint, s varchar, x double)",
        "INSERT INTO memory.dn VALUES (1, 'a', 1.5), (2, NULL, NULL), "
        "(NULL, 'b', 2.5), (4, 'a', NULL)",
        "DELETE FROM memory.dn WHERE a > NULL",
        "DELETE FROM memory.dn WHERE x > 2",
        "DELETE FROM memory.dn WHERE s = 'a' AND a = 4",
        ("SELECT * FROM memory.dn", False),
        "DELETE FROM memory.dn WHERE 1 = 2",
        "DELETE FROM memory.dn WHERE a",
        "DELETE FROM memory.dn",
        "SELECT count(*) FROM memory.dn",
        "DELETE FROM memory.dn",
    ],
    "stats_and_refusals": [
        "CREATE TABLE memory.st AS SELECT * FROM region",
        "SHOW STATS FOR memory.st",
        "ANALYZE memory.st",
        "SHOW STATS FOR memory.st",
        "INSERT INTO memory.st SELECT * FROM region",
        "SHOW STATS FOR memory.st",
        "SHOW STATS FOR tpch.nation",
        "ANALYZE tpch.nation",
        "DELETE FROM tpch.nation",
        "INSERT INTO tpch.nation SELECT * FROM nation",
        "CREATE TABLE tpch.x (a bigint)",
        "SHOW STATS FOR memory.nope",
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_statement_script_matches_jax(name):
    _run_script(SCRIPTS[name])


@pytest.fixture(scope="module", params=[1, 4],
                ids=["concurrency1", "concurrency4"])
def memory_runners(request):
    """Both runners with lineitem, orders and customer copied into the
    memory catalog by CTAS at ``task_concurrency`` = the param, then
    ``USE memory``."""
    runners = _runners()
    _run_script([f"SET SESSION task_concurrency = {request.param}"] + [
        f"CREATE TABLE memory.{t} AS SELECT * FROM tpch.{t}"
        for t in ("lineitem", "orders", "customer")] + ["USE memory"],
        runners)
    return request.param, runners


@pytest.mark.parametrize("q", [1, 3, 6, 18])
def test_tpch_over_memory_matches_jax(memory_runners, q):
    concurrency, (jax_runner, torch_runner) = memory_runners
    sql = QUERIES[q]
    assert torch_runner.explain(sql) == jax_runner.explain(sql)
    assert "TableScan memory." in torch_runner.explain(sql)
    # bit-equal when both stored and read their batches in one order
    _assert_same(_outcome(torch_runner, sql), _outcome(jax_runner, sql),
                 sql, exact=concurrency == 1)


@pytest.mark.parametrize("table", ["lineitem", "orders", "customer"])
def test_show_stats_after_analyze_matches_jax(memory_runners, table):
    """ANALYZE's statistics of every column, which the row order does not
    change: the row count, null fraction, ndv, low, high, data size."""
    _concurrency, runners = memory_runners
    _run_script([f"ANALYZE memory.{table}",
                 f"SHOW STATS FOR memory.{table}"], runners)


def test_varchar_of_two_dictionaries_matches_jax():
    """Two INSERTs whose varchar sources have different dictionaries land
    in the table's one dictionary: GROUP BY and a join on the column see
    each string once."""
    script = [
        "CREATE TABLE memory.v (k bigint, s varchar)",
        "INSERT INTO memory.v SELECT n_nationkey, n_name FROM nation",
        "INSERT INTO memory.v SELECT r_regionkey + 100, r_name FROM region",
        "INSERT INTO memory.v VALUES (200, 'ALGERIA'), (201, NULL)",
        "SELECT s, count(*), sum(k) FROM memory.v GROUP BY s ORDER BY s",
        "SELECT count(DISTINCT s) FROM memory.v",
        "SELECT v.k, n.n_nationkey FROM memory.v v JOIN tpch.nation n "
        "ON v.s = n.n_name ORDER BY v.k",
        "ANALYZE memory.v",
        "SHOW STATS FOR memory.v",
    ]
    runners = _run_script(script)
    table = runners[1].registry.get("memory").tables["v"]
    assert len({id(b.columns[1].dictionary) for b in table.batches}) == 1


def test_delete_leaves_the_same_multiset():
    runners = _run_script([
        "SET SESSION task_concurrency = 2",
        "CREATE TABLE memory.li AS SELECT * FROM lineitem",
        "INSERT INTO memory.li SELECT * FROM lineitem "
        "WHERE l_returnflag = 'R'",
        "DELETE FROM memory.li WHERE l_returnflag = 'R'",
        "DELETE FROM memory.li WHERE l_shipdate < date '1993-01-01' "
        "AND l_quantity > 20",
        "SELECT count(*) FROM memory.li"])
    sql = ("SELECT l_orderkey, l_linenumber, l_returnflag, l_shipdate, "
           "l_extendedprice FROM memory.li")
    _assert_same(_outcome(runners[1], sql), _outcome(runners[0], sql), sql,
                 ordered=False)


def test_stored_batches_are_compact_on_the_runner_device():
    """Every stored batch lies on the runner's device, holds no padding
    and shares its columns' one dictionary, whatever the writer got: a
    VALUES row, a global aggregate's row, padded scan batches."""
    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu")
    runner.execute("CREATE TABLE memory.s AS SELECT * FROM orders")
    runner.execute("INSERT INTO memory.s (o_orderkey, o_comment) "
                   "VALUES (-1, 'x')")
    runner.execute("INSERT INTO memory.s (o_orderkey, o_totalprice) "
                   "SELECT count(*), sum(o_totalprice) FROM orders")
    table = runner.registry.get("memory").tables["s"]
    assert len(table.batches) > 2
    for b in table.batches:
        assert b.device == torch.device("cpu")
        assert b.capacity == b.num_rows
        for c in b.columns:
            assert isinstance(c.values, torch.Tensor)
            assert c.values.untyped_storage().nbytes() == \
                c.values.numel() * c.values.element_size()
    for ci, c in enumerate(table.batches[0].columns):
        if c.dictionary is not None:
            assert all(b.columns[ci].dictionary is c.dictionary
                       for b in table.batches)
    assert runner.execute("SELECT count(*) FROM memory.s").rows == [
        (15002,)]


def test_scan_hands_on_the_stored_tensors(monkeypatch):
    """A scan of a memory table serves the stored tensors themselves:
    the scan's staging copies nothing."""
    from presto_tpu_torch import batch as batch_mod
    from presto_tpu_torch.exec import operators as ops_mod

    runner = LocalQueryRunner.tpch(scale=SCALE, device="cpu")
    runner.execute("CREATE TABLE memory.n AS SELECT * FROM lineitem")
    stored = {c.values.data_ptr()
              for b in runner.registry.get("memory").tables["n"].batches
              for c in b.columns}
    in_scan, copies, seen = [], [], []
    real_to_tensor = batch_mod._to_tensor
    real_get = ops_mod.TableScanOperator.get_output

    def to_tensor(a, device):
        out = real_to_tensor(a, device)
        if in_scan and (not isinstance(a, torch.Tensor)
                        or out.data_ptr() != a.data_ptr()):
            copies.append(a)
        return out

    def get_output(self):
        in_scan.append(True)
        try:
            out = real_get(self)
        finally:
            in_scan.pop()
        if out is not None:
            seen.extend(c.values.data_ptr() for c in out.columns)
        return out

    monkeypatch.setattr(batch_mod, "_to_tensor", to_tensor)
    monkeypatch.setattr(ops_mod.TableScanOperator, "get_output",
                        get_output)
    assert runner.execute("SELECT count(*) FROM memory.n WHERE "
                          "l_quantity > 0").rows == [(59785,)]
    assert seen and set(seen) <= stored
    assert not copies


def test_null_codes_outside_the_dictionary_are_stored():
    """A NULL row's code may lie outside its batch's dictionary (a LEFT
    join's unmatched rows); re-coding into the table's dictionary keeps
    the row NULL and indexes nothing out of range."""
    script = [
        "CREATE TABLE memory.lj AS SELECT r_regionkey, n_name FROM region "
        "LEFT JOIN nation ON r_regionkey = n_regionkey AND n_nationkey < 3",
        ("SELECT * FROM memory.lj", False),
        "SELECT count(n_name), count(*) FROM memory.lj",
    ]
    _run_script(script)
