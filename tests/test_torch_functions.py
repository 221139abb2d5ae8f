"""Scalar function parity: presto_tpu_torch against presto_tpu at TPC-H
SF0.01, one statement a case.

Each statement runs through both packages' LocalQueryRunner (the port on
the CPU) and must give the same column names, types and rows, doubles
within 1e-9 relative (the trigonometric and logarithmic functions are
numpy's on one side and torch's on the other), or raise the same
exception type with the same message.

The cases are the scalar statements of tests/test_functions.py and
tests/test_functions2.py that the port runs (their array and map rows
beyond this slice are ROADMAP A6b, pinned in tests/test_torch_nested.py),
and the repairs of ROADMAP C9 (a Python int divisor in ``_trunc_div`` and
``_round_half_up_div``: date_diff, round and truncate of a decimal, a
decimal cast to a smaller scale), C10 (width_bucket's clamp) and C11
(bit_count in int64), each with literal and with column arguments.
"""

import pytest
from test_torch_writes import _assert_same, _outcome

from presto_tpu.localrunner import LocalQueryRunner as JaxRunner
from presto_tpu_torch.localrunner import LocalQueryRunner

SCALE = 0.01

# tests/test_functions.py, one statement each
FUNCTIONS = [
    "select sin(1.0), cos(1.0), tan(1.0), asin(0.5), acos(0.5), "
    "atan(1.0), atan2(1.0, 2.0)",
    "select sinh(1.0), cosh(1.0), tanh(1.0), log2(8.0), log10(1000.0), "
    "ln(e()), exp(1.0)",
    "select truncate(2.9), truncate(-2.9), round(2.5), round(-2.5), "
    "round(2.345, 2), ceil(2.1), floor(-2.1), cbrt(8.0)",
    "select abs(-7), sign(-3.5), mod(7, 3), mod(-7, 3), power(2.0, 10.0), "
    "sqrt(2.0)",
    "select greatest(1, 2.5, 2), least(1, 2.5, 0), greatest(3, 1), "
    "least(-1, -5)",
    "select bitwise_and(12, 10), bitwise_or(12, 10), bitwise_xor(12, 10), "
    "bitwise_not(5)",
    "select is_nan(nan()), is_finite(1.0), is_infinite(infinity()), "
    "is_nan(1.0)",
    "select lpad('ab', 5, 'xy'), rpad('ab', 5, 'xy'), lpad('abcdef', 3, "
    "'x'), split_part('a:b:c', ':', 2)",
    "select split_part('a:b', ':', 9) is null",
    "select chr(9731), codepoint('A')",
    "select translate('abcd', 'abc', '12'), levenshtein_distance('kitten', "
    "'sitting'), hamming_distance('karolin', 'kathrin')",
    "select regexp_like('plane', 'an'), regexp_extract('1a 2b 3c', "
    "'(\\d+)([a-z])', 2), regexp_replace('1a 2b', '\\d', '#'), "
    "regexp_extract('xyz', '\\d+') is null",
    "select upper(n_name), length(n_name), reverse(n_name), strpos(n_name, "
    "'A'), ends_with(n_name, 'A') from nation where n_name = 'ALGERIA'",
    "select date_trunc('year', date '1995-07-17'), date_trunc('quarter', "
    "date '1995-07-17'), date_trunc('month', date '1995-07-17'), "
    "date_trunc('week', date '1995-07-17')",
    "select date_trunc('hour', timestamp '1995-07-17 13:45:31'), "
    "date_trunc('day', timestamp '1995-07-17 13:45:31')",
    "select date_diff('day', date '1995-01-01', date '1995-03-01'), "
    "date_diff('week', date '1995-01-01', date '1995-01-20'), "
    "date_diff('month', date '1995-01-31', date '1995-03-01'), "
    "date_add('day', 30, date '1995-01-15'), "
    "date_add('year', -1, date '1996-02-29')",
    "select extract(hour from timestamp '1995-07-17 13:45:31'), "
    "extract(minute from timestamp '1995-07-17 13:45:31'), "
    "extract(second from timestamp '1995-07-17 13:45:31'), "
    "extract(year from date '1995-07-17'), extract(quarter from date "
    "'1995-07-17'), extract(day from date '1995-07-17')",
    "select to_unixtime(timestamp '1970-01-02 00:00:00'), "
    "from_unixtime(86400.0)",
    "select last_day_of_month(date '1996-02-10'), "
    "last_day_of_month(date '1995-12-05')",
    "select if(true, 1, 2), if(false, 1, 2), if(1 > 2, 'y'), if(2 > 1, "
    "'y')",
    "select nullif(5, 5), nullif(5, 3), coalesce(null, null, 7), "
    "coalesce(1, 2)",
    "select bool_and(n_regionkey < 5), bool_or(n_regionkey > 3), "
    "every(n_regionkey >= 0) from nation",
    "select any_value(n_name) from nation where n_name = 'KENYA'",
]

# tests/test_functions2.py's CASES and MORE_CASES the port runs, and its
# statements over columns
FUNCTIONS2 = [
    "select cast(42 as varchar)",
    "select cast(-7 as varchar)",
    "select cast(1.5 as varchar)",
    "select cast(true as varchar), cast(false as varchar)",
    "select cast(date '2020-03-05' as varchar)",
    "select cast(cast(1.25 as decimal(5,2)) as varchar)",
    "select cast(cast(null as bigint) as varchar)",
    "select cast(array[1,2] as array(double))",
    "select date_format(timestamp '2020-03-05 14:30:45', "
    "'%Y/%m/%d %H:%i:%s')",
    "select format_datetime(timestamp '2020-03-05 14:30:45', "
    "'yyyy-MM-dd HH:mm')",
    'select json_extract_scalar(\'{"a": {"b": 7}}\', \'$.a.b\')',
    'select json_extract(\'{"a": [1, 2]}\', \'$.a\')',
    "select json_array_length('[1,2,3]')",
    "select json_array_get('[10,20,30]', 1)",
    "select json_array_get('[10,20,30]', -1)",
    'select json_extract_scalar(\'{"a": 1}\', \'$.missing\')',
    "select json_array_length('not json')",
    'select json_size(\'{"a": {"b": 1, "c": 2}}\', \'$.a\')',
    "select to_hex(md5(to_utf8('abc')))",
    "select to_hex(sha256(to_utf8('abc')))",
    "select crc32(to_utf8('abc'))",
    "select to_base64(to_utf8('hi')), from_utf8(from_base64('aGk='))",
    "select to_hex(from_hex('DEADBEEF'))",
    "select url_extract_host('https://x.io:8080/p?q=1')",
    "select url_extract_port('https://x.io:8080/p')",
    "select url_extract_protocol('https://x.io/p')",
    "select url_extract_path('https://x.io/a/b?q=1')",
    "select url_extract_query('https://x.io/p?q=1&r=2')",
    "select url_extract_parameter('http://a/b?k=v&x=2', 'x')",
    "select url_encode('a b'), url_decode('a%20b')",
    "select cast(o_orderkey as varchar) from orders where o_orderkey <= 3 "
    "order by o_orderkey",
    "select concat(o_orderpriority, '/', o_orderstatus) from orders "
    "where o_orderkey = 1",
    "select o_orderpriority, o_orderstatus, concat(o_orderpriority, "
    "o_orderstatus) from orders where o_orderkey < 50 order by o_orderkey",
    "select substr(o_orderpriority, 1, o_orderkey) from orders "
    "where o_orderkey <= 2 order by o_orderkey",
    "select date_format(cast(o_orderdate as timestamp), '%Y-%m') as ym, "
    "count(*) from orders group by 1 order by 1 limit 3",
    "select width_bucket(3.0, 0.0, 10.0, 5)",
    "select width_bucket(-1.0, 0.0, 10.0, 5)",
    "select width_bucket(11.0, 0.0, 10.0, 5)",
    "select try_cast('abc' as bigint)",
    "select try_cast('42' as bigint)",
    "select try_cast('nope' as date)",
    "select position('b' in 'abc'), position('zz' in 'abc')",
    "select typeof(1.5), typeof('x'), typeof(array[1])",
    "select bit_count(7, 64), bit_count(255, 8)",
    "select normalize('abc')",
]

_UNITS = ("second", "minute", "hour", "day", "week", "month", "quarter",
          "year")

# ROADMAP C9-C11, literal and column arguments
REPAIRS = [
    # C9: date_diff in every unit
    "select " + ", ".join(
        f"date_diff('{u}', date '1995-01-01', date '1997-03-01')"
        for u in _UNITS),
    "select " + ", ".join(
        f"date_diff('{u}', timestamp '1995-01-01 10:00:00', "
        f"timestamp '1994-11-30 08:59:59')" for u in _UNITS),
    "select o_orderkey, " + ", ".join(
        f"date_diff('{u}', o_orderdate, date '1998-08-02')"
        for u in _UNITS) + " from orders order by o_orderkey limit 20",
    "select l_orderkey, l_linenumber, date_diff('day', l_shipdate, "
    "l_receiptdate), date_diff('month', l_commitdate, l_shipdate) "
    "from lineitem order by l_orderkey, l_linenumber limit 20",
    # C9: round and truncate of a decimal, a decimal to a smaller scale
    "select round(cast(1.25 as decimal(4,2)), 1)",
    "select round(cast(-1.25 as decimal(4,2)), 1), "
    "round(cast(1.249 as decimal(5,3)), 2), round(cast(15.5 as "
    "decimal(3,1)), 0)",
    "select truncate(cast(-12.75 as decimal(4,2))), "
    "truncate(cast(12.75 as decimal(4,2)))",
    "select round(cast(o_totalprice as decimal(12,2)), 1), "
    "round(cast(o_totalprice as decimal(12,2)), -2), "
    "truncate(cast(o_totalprice as decimal(12,2))) from orders "
    "order by o_orderkey limit 20",
    "select cast(cast(o_totalprice as decimal(12,2)) as decimal(10,1)) "
    "from orders order by o_orderkey limit 2",
    "select cast(cast(l_extendedprice as decimal(12,2)) as decimal(12,0)), "
    "cast(-l_discount as decimal(4,1)) from lineitem "
    "order by l_orderkey, l_linenumber limit 20",
    # C10: width_bucket with a number and a column bound
    "select width_bucket(o_totalprice, 0.0, 500000.0, 10) from orders "
    "order by o_orderkey limit 20",
    "select width_bucket(o_totalprice, 1000.0, 400000.0, "
    "o_custkey % 7 + 1) from orders order by o_orderkey limit 20",
    # C11: bit_count in int64
    "select bit_count(-1, 64), bit_count(-1, 63), bit_count(0, 8), "
    "bit_count(9223372036854775807, 64)",
    "select bit_count(o_orderkey, 64), bit_count(o_custkey, 8), "
    "bit_count(-o_orderkey, 64), bit_count(o_orderkey, o_shippriority + 5)"
    " from orders order by o_orderkey limit 20",
]


@pytest.fixture(scope="module")
def runners():
    return (JaxRunner.tpch(scale=SCALE),
            LocalQueryRunner.tpch(scale=SCALE, device="cpu"))


def _check(runners, sql):
    want = _outcome(runners[0], sql)
    got = _outcome(runners[1], sql)
    assert want[0] == "rows", want
    _assert_same(got, want, sql, ordered=True, exact=False)


@pytest.mark.parametrize("sql", FUNCTIONS, ids=[s[:60] for s in FUNCTIONS])
def test_functions_match_jax(runners, sql):
    _check(runners, sql)


@pytest.mark.parametrize("sql", FUNCTIONS2,
                         ids=[s[:60] for s in FUNCTIONS2])
def test_functions2_match_jax(runners, sql):
    _check(runners, sql)


@pytest.mark.parametrize("sql", REPAIRS, ids=[s[:60] for s in REPAIRS])
def test_repaired_faults_match_jax(runners, sql):
    _check(runners, sql)


def test_motivating_values(runners):
    """The values that presto_tpu returns for the three faults' own
    statements."""
    port = runners[1]
    assert port.execute("select date_diff('day', date '1995-01-01', "
                        "date '1995-03-01')").rows == [(59,)]
    assert port.execute("select width_bucket(3.0, 0.0, 10.0, 5)"
                        ).rows == [(2,)]
    assert port.execute("select bit_count(7, 64), bit_count(255, 8)"
                        ).rows == [(3, 8)]
