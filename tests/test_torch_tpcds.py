"""TPC-DS parity: presto_tpu_torch against presto_tpu.

The port's tpcds connector is a copy of the JAX package's generator, so
every column of every table is bit-equal at SF0.003 and the row counts
agree at SF0.003 and SF1.  Then the suite's query files
(``tests/tpcds_suite/q*.sql``) run through both packages'
LocalQueryRunner at the suite's SF0.003 (the port on the CPU): in tier-1
the 15 files with window functions and BASELINE.md's config 5 (Q72,
Q95); all 103 files in the slow tier.  Rows compare as sorted lists
(keys and counts exactly, doubles to 1e-9 relative).  Many files return
no row at this scale; each test records its row count
(``record_property``) and ``ZERO_ROWS`` pins which files are empty, so
that an empty result on one side only fails.

The JAX package compiles every query anew; 103 queries' compiles in one
process exhaust the memory of a 62 GB host, so the JAX runner drops its
compile caches (``jax.clear_caches()``) after each query.
"""

import math
import os
import sys

import numpy as np
import pytest

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402
from presto_tpu.connectors.tpcds import TpcdsConnector as JaxTpcds  # noqa: E402
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner  # noqa: E402
from presto_tpu_torch.connectors.tpcds import TpcdsConnector  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402

SCALE = 0.003
_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "tpcds_suite")
FILES = sorted(f[1:-4] for f in os.listdir(_DIR)
               if f.startswith("q") and f.endswith(".sql"))

# the files with window functions (OVER), and BASELINE.md's config 5
WINDOW_FILES = ["12", "20", "36", "44", "47", "49", "51", "53", "57", "63",
                "67", "70", "86", "89", "98"]
TIER1 = WINDOW_FILES + ["72", "95"]

# files whose result has no row at SF0.003 (in both packages); Q44's,
# Q51's and Q67's predicates select no row of this generator at any scale
# (``chip_smoke.DS_VARIANTS``), so two of the variants run below too
ZERO_ROWS = {
    "01", "03", "04", "06", "07", "08", "10", "11", "12", "14_2", "17",
    "19", "20", "21", "23_2", "24_1", "24_2", "25", "29", "30", "31", "34",
    "35", "37", "39_1", "39_2", "41", "44", "49", "51", "53", "54", "56",
    "57", "58", "59", "62", "63", "64", "65", "68", "71", "72", "73", "74",
    "76", "78", "82", "83", "84", "85", "91", "99"}


def _sql(qn: str) -> str:
    with open(os.path.join(_DIR, f"q{qn}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def runners():
    return (JaxRunner.tpch(scale=SCALE),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu"))


def test_the_suite_has_103_files_and_windows_where_listed():
    assert len(FILES) == 103
    assert sorted(q for q in FILES if " over" in _sql(q).lower()
                  or "over(" in _sql(q).lower()) == WINDOW_FILES


@pytest.mark.parametrize("table", sorted(JaxTpcds(scale=SCALE)
                                         .list_tables()))
def test_generator_columns_bit_equal_jax(table):
    jax_conn, conn = JaxTpcds(scale=SCALE), TpcdsConnector(scale=SCALE)
    assert conn.list_tables() == jax_conn.list_tables()
    handle, jax_handle = conn.get_table(table), jax_conn.get_table(table)
    names = conn.table_schema(handle).column_names()
    assert names == jax_conn.table_schema(jax_handle).column_names()
    got = [b for s in conn.get_splits(handle, 3)
           for b in conn.page_source(s, names, 4096)]
    want = [b for s in jax_conn.get_splits(jax_handle, 3)
            for b in jax_conn.page_source(s, names, 4096)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.num_rows == w.num_rows
        for gc, wc in zip(g.columns, w.columns):
            assert gc.type.display() == wc.type.display()
            gv, wv = np.asarray(gc.values), np.asarray(wc.values)
            assert gv.dtype == wv.dtype
            assert gv.tobytes() == wv.tobytes()
            assert (gc.valid is None) == (wc.valid is None)
            if gc.valid is not None:
                assert np.array_equal(gc.valid, wc.valid)
            if gc.dictionary is not None:
                assert list(gc.dictionary.values) == \
                    list(wc.dictionary.values)


@pytest.mark.parametrize("scale", [SCALE, 1.0])
def test_row_counts_equal_jax(scale):
    """Counts only (no SF1 generation): the sizes the card's phase runs."""
    jax_conn, conn = JaxTpcds(scale=scale), TpcdsConnector(scale=scale)
    for table in conn.list_tables():
        got = conn.table_statistics(conn.get_table(table)).row_count
        want = jax_conn.table_statistics(
            jax_conn.get_table(table)).row_count
        assert got == want > 0, table
    if scale == 1.0:
        stats = {t: conn.table_statistics(conn.get_table(t)).row_count
                 for t in ("store_sales", "catalog_sales", "web_sales",
                           "inventory")}
        assert stats == {"store_sales": 2_880_000,
                         "catalog_sales": 1_440_000,
                         "web_sales": 720_000, "inventory": 15_255_000}


def _key(row):
    return tuple((v is None, "" if v is None else str(type(v)),
                  0 if v is None else v) for v in row)


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    got, want = sorted(got, key=_key), sorted(want, key=_key)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float) and not math.isnan(y):
                assert x == pytest.approx(y, rel=1e-9, abs=0.0), (g, w)
            else:
                assert x == y and type(x) is type(y), (g, w)


def _check(runners, qn, record_property, sql=None, empty=None):
    jax_runner, runner = runners
    sql = sql or _sql(qn)
    empty = qn in ZERO_ROWS if empty is None else empty
    got = runner.execute(sql)
    try:
        want = jax_runner.execute(sql)
    finally:
        jax.clear_caches()
    record_property("rows", len(want.rows))
    assert got.column_names == want.column_names
    assert [t.display() for t in got.column_types] == \
        [t.display() for t in want.column_types]
    assert (len(want.rows) == 0) == empty, len(want.rows)
    assert_rows_equal(got.rows, want.rows)


@pytest.mark.parametrize("qn", TIER1)
def test_window_and_config5_files_match_jax(runners, qn, record_property):
    _check(runners, qn, record_property)


@pytest.mark.parametrize("qn", ["44", "67"])
def test_generator_range_variants_match_jax(runners, qn, record_property):
    """The card's phase-6 text of Q44 and Q67: the suite's, with the
    predicates that select no row moved into the generator's range.
    (Q51's keeps a row where two running sums of the same prices, added
    in other orders, differ in their last bits: its rows are rounding,
    and the card's phase compares them as such, ``DS_OPTIONAL``.)"""
    _check(runners, qn, record_property, C.ds_sql(f"q{qn}"), empty=False)


@pytest.mark.slow
@pytest.mark.parametrize("qn", [q for q in FILES if q not in TIER1])
def test_every_suite_file_matches_jax(runners, qn, record_property):
    _check(runners, qn, record_property)
