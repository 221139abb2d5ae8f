"""Row hashing parity: presto_tpu_torch/ops/hashing.py against
presto_tpu/ops/hashing.py, and ``checksum`` through both packages.

The same numpy columns, made from a seed, go through both packages'
``row_hash``, ``partition_of`` and ``value_hash_triple``: the port's
int64 hashes must have the bits of the JAX package's uint64 hashes, for
every flat type with NULLs, alone and combined, and the partitions must
be equal (the unsigned modulo).  ``checksum`` (a wrapping sum of row
hashes; a varchar hashes its codes, as the reference does) must equal the
JAX package's result exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_writes import _assert_same, _outcome

from presto_tpu import types as JT
from presto_tpu.batch import Column as JaxColumn
from presto_tpu.batch import Dictionary as JaxDictionary
from presto_tpu.localrunner import LocalQueryRunner as JaxRunner
from presto_tpu.ops import hashing as JH
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Column, Dictionary
from presto_tpu_torch.localrunner import LocalQueryRunner
from presto_tpu_torch.ops import hashing as H

N = 2048
TYPES = ["bigint", "integer", "smallint", "tinyint", "double", "real",
         "boolean", "date", "timestamp", "decimal(12,2)", "decimal(38,4)",
         "varchar"]


def _column(typ: str, seed: int, nulls: bool):
    """(values, valid) of a numpy column of ``typ``: extremes included."""
    rng = np.random.default_rng(seed)
    dt = T.parse_type(typ).np_dtype
    if typ == "boolean":
        values = rng.integers(0, 2, N).astype(bool)
    elif typ in ("double", "real"):
        values = rng.normal(0, 1e6, N).astype(dt)
        values[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-300]
    elif typ == "varchar":
        values = rng.integers(0, 50, N).astype(np.int32)
    else:
        info = np.iinfo(dt)
        values = rng.integers(info.min, info.max, N, dtype=dt,
                              endpoint=True)
        values[:3] = [info.min, info.max, 0]
    valid = rng.random(N) > 0.2 if nulls else None
    return values, valid


def _jax_hash(cols):
    return np.asarray(JH.row_hash([
        (jnp.asarray(v), None if ok is None else jnp.asarray(ok),
         JT.parse_type(t)) for v, ok, t in cols])).view(np.int64)


def _port_hash(cols):
    return H.row_hash([
        (torch.from_numpy(v), None if ok is None else torch.from_numpy(ok),
         T.parse_type(t)) for v, ok, t in cols]).numpy()


@pytest.mark.parametrize("nulls", [False, True], ids=["no_nulls", "nulls"])
@pytest.mark.parametrize("typ", TYPES)
def test_row_hash_bit_equal_jax(typ, nulls):
    values, valid = _column(typ, TYPES.index(typ), nulls)
    cols = [(values, valid, typ)]
    np.testing.assert_array_equal(_port_hash(cols), _jax_hash(cols))


def test_row_hash_of_every_type_together_bit_equal_jax():
    cols = [(*_column(t, 100 + i, i % 2 == 0), t)
            for i, t in enumerate(TYPES)]
    np.testing.assert_array_equal(_port_hash(cols), _jax_hash(cols))


@pytest.mark.parametrize("parts", [1, 2, 7, 64, 1000003, (1 << 31) - 1])
def test_partition_of_equals_jax(parts):
    cols = [(*_column("bigint", 7, True), "bigint"),
            (*_column("double", 8, False), "double")]
    got = H.partition_of(torch.from_numpy(_port_hash(cols)), parts)
    want = JH.partition_of(JH.row_hash([
        (jnp.asarray(v), None if ok is None else jnp.asarray(ok),
         JT.parse_type(t)) for v, ok, t in cols]), parts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) < parts


@pytest.mark.parametrize("typ", ["varchar", "bigint", "double"])
def test_value_hash_triple_equals_jax(typ):
    values, valid = _column(typ, 31, True)
    entries = [f"v{i}é" for i in range(50)]
    t, jt = T.parse_type(typ), JT.parse_type(typ)
    port = Column(t, torch.from_numpy(values),
                  torch.from_numpy(valid),
                  Dictionary(entries) if t.is_dictionary else None)
    jax = JaxColumn(jt, jnp.asarray(values), jnp.asarray(valid),
                    JaxDictionary(entries) if jt.is_dictionary else None)
    pv, pok, ptype = H.value_hash_triple(port)
    jv, jok, jtype = JH.value_hash_triple(jax)
    np.testing.assert_array_equal(np.asarray(pv), np.asarray(jv))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    assert ptype.display() == jtype.display()
    # the partition of a string is that of its value, whatever its code
    got = _port_hash([(np.asarray(pv), valid, ptype.display())])
    want = _jax_hash([(np.asarray(jv), valid, jtype.display())])
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def runners():
    return (JaxRunner.tpch(scale=0.01),
            LocalQueryRunner.tpch(scale=0.01, device="cpu"))


CHECKSUMS = [
    # tests/test_aggregates2.py::TestStatistics::
    # test_checksum_order_independent
    "select checksum(x) from (values (1),(2),(3)) t(x)",
    "select checksum(x) from (values (3),(1),(2)) t(x)",
    "select checksum(x) from (values (3),(1),(5)) t(x)",
    "select checksum(n_name) from nation",
    "select checksum(l_orderkey), checksum(l_shipdate), "
    "checksum(l_returnflag), checksum(l_extendedprice), "
    "checksum(l_quantity), checksum(l_discount) from lineitem",
    "select o_orderpriority, checksum(o_totalprice), checksum(o_comment) "
    "from orders group by o_orderpriority order by 1",
    "select checksum(x) from (values (1), (null), (3)) t(x)",
    "select checksum(x) from (values (cast(null as bigint))) t(x)",
    "select checksum(cast(o_orderkey as tinyint)), "
    "checksum(cast(o_custkey as smallint)), checksum(o_shippriority), "
    "checksum(o_orderkey > 100), checksum(cast(o_totalprice as real)), "
    "checksum(cast(o_orderdate as timestamp)) from orders",
]


@pytest.mark.parametrize("sql", CHECKSUMS, ids=[s[:60] for s in CHECKSUMS])
def test_checksum_equals_jax(runners, sql):
    _assert_same(_outcome(runners[1], sql), _outcome(runners[0], sql), sql)


def test_checksum_order_independent(runners):
    port = runners[1]

    def one(sql):
        return port.execute(sql).rows[0]

    a = one("select checksum(x) from (values (1),(2),(3)) t(x)")
    b = one("select checksum(x) from (values (3),(1),(2)) t(x)")
    c = one("select checksum(x) from (values (3),(1),(5)) t(x)")
    assert a == b and a != c and a[0] != 0
    assert port.execute("select checksum(n_name) from nation").rows == [
        (768459628856342642,)]
