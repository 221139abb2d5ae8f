"""The port's cross join, EnforceSingleRow, UNION ALL plumbing and VALUES
builder, operator by operator on the CPU: the nested-loop product in
probe-row-major order across build chunks, the scalar-subquery guard's
NULL row and its error, the union's input order and its re-coding of a
channel whose inputs carry different dictionaries, and
``batch_from_pylist`` against the JAX package's on the same rows."""

import datetime

import numpy as np
import pytest
import torch

from presto_tpu import types as JT
from presto_tpu.batch import batch_from_pylist as jax_batch_from_pylist
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import (
    Batch, Column, Dictionary, batch_from_pylist,
)
from presto_tpu_torch.config import EngineConfig
from presto_tpu_torch.exec.context import (
    OperatorContext, QueryContext, TaskContext,
)
from presto_tpu_torch.exec import nestedloop
from presto_tpu_torch.exec.nestedloop import (
    EnforceSingleRowOperatorFactory, NestedLoopBuildOperatorFactory,
    NestedLoopJoinOperatorFactory,
)
from presto_tpu_torch.exec.unionop import (
    UnionBuffer, UnionSinkOperatorFactory, UnionSourceOperatorFactory,
)


def _ctx(name):
    return OperatorContext(TaskContext(QueryContext(EngineConfig())), name)


def _ints(values):
    return Batch((Column(T.BIGINT, torch.tensor(values, dtype=torch.int64)),),
                 len(values))


def _names(values, dictionary):
    codes = torch.tensor([dictionary.intern(v) for v in values],
                         dtype=torch.int32)
    return Batch((Column(T.VARCHAR, codes, None, dictionary),), len(values))


def _drain(op):
    rows = []
    while (out := op.get_output()) is not None:
        rows.extend(out.to_pylist())
    return rows


@pytest.mark.parametrize("max_output_rows", [1 << 22, 7, 1])
def test_cross_join_is_probe_major_across_build_chunks(max_output_rows,
                                                       monkeypatch):
    monkeypatch.setattr(nestedloop, "MAX_OUTPUT_ROWS", max_output_rows)
    bf = NestedLoopBuildOperatorFactory([T.BIGINT])
    bop = bf.create(_ctx("build"))
    bop.add_input(_ints([10, 20]))
    bop.add_input(_ints([30]))
    bop.finish()
    jop = NestedLoopJoinOperatorFactory(bf).create(_ctx("probe"))
    rows = []
    for part in ([1, 2, 3], [4]):
        jop.add_input(_ints(part))
        rows.extend(_drain(jop))
    # each probe batch: its rows in order, each against the build chunk
    chunk = max(1, max_output_rows // 3)
    want = []
    for lo in range(0, 3, chunk):
        want += [(p, b) for p in (1, 2, 3)
                 for b in (10, 20, 30)[lo:lo + chunk]]
    chunk = max(1, max_output_rows // 1)
    for lo in range(0, 3, chunk):
        want += [(4, b) for b in (10, 20, 30)[lo:lo + chunk]]
    assert rows == want


def test_cross_join_against_an_empty_build_is_empty():
    bf = NestedLoopBuildOperatorFactory([T.BIGINT])
    bop = bf.create(_ctx("build"))
    bop.finish()
    jop = NestedLoopJoinOperatorFactory(bf).create(_ctx("probe"))
    jop.add_input(_ints([1, 2]))
    assert _drain(jop) == []


def test_cross_join_refuses_a_probe_on_another_device():
    """Every operator's rows lie on the query's device; a probe elsewhere
    is a planning fault, not a batch to move."""
    bf = NestedLoopBuildOperatorFactory([T.BIGINT])
    bop = bf.create(_ctx("build"))
    bop.add_input(_ints([10, 20]))
    bop.finish()
    jop = NestedLoopJoinOperatorFactory(bf).create(_ctx("probe"))
    meta = Batch((Column(T.BIGINT, torch.empty(2, dtype=torch.int64,
                                               device="meta")),), 2)
    with pytest.raises(ValueError, match="meet a build"):
        jop.add_input(meta)


@pytest.mark.parametrize("rows", [[], [1.5, 2.5]], ids=["empty", "rows"])
def test_global_aggregate_row_comes_out_on_the_query_device(rows):
    from presto_tpu_torch.exec.aggregation import (
        AggChannel, GlobalAggregationOperatorFactory,
    )

    aggs = [AggChannel("sum", 0, T.DOUBLE), AggChannel("count", None,
                                                       T.BIGINT)]
    op = GlobalAggregationOperatorFactory(aggs, [T.DOUBLE], "cpu").create(
        _ctx("agg"))
    if rows:
        op.add_input(Batch((Column(T.DOUBLE, torch.tensor(rows)),),
                           len(rows)))
    op.finish()
    out = op.get_output()
    assert all(isinstance(c.values, torch.Tensor) for c in out.columns)
    assert out.device == torch.device("cpu")
    assert out.to_pylist() == [(sum(rows) if rows else None, len(rows))]


def test_enforce_single_row():
    types = [T.BIGINT, T.VARCHAR, T.DOUBLE, T.DATE]
    op = EnforceSingleRowOperatorFactory(types, "cpu").create(_ctx("one"))
    op.finish()
    out = op.get_output()
    assert out.device == torch.device("cpu")
    assert out.to_pylist() == [(None, None, None, None)]
    assert op.is_finished()
    op = EnforceSingleRowOperatorFactory([T.BIGINT], "cpu").create(
        _ctx("two"))
    op.add_input(_ints([1]))
    with pytest.raises(RuntimeError,
                       match="scalar subquery returned more than one row"):
        op.add_input(_ints([2]))


def test_union_keeps_input_order_and_recodes_dictionaries():
    nations, regions = Dictionary(), Dictionary()
    buffer = UnionBuffer(2)
    sinks = [UnionSinkOperatorFactory(buffer, i).create(_ctx(f"sink{i}"))
             for i in range(2)]
    source = UnionSourceOperatorFactory(buffer).create(_ctx("source"))
    # the second input finishes first: the source still starts with the
    # first input's rows
    sinks[1].add_input(_names(["AFRICA", "ASIA"], regions))
    sinks[1].finish()
    assert source.get_output() is None and not source.is_finished()
    sinks[0].add_input(_names(["ALGERIA", "ARGENTINA"], nations))
    sinks[0].add_input(_names(["CHINA"], nations))
    sinks[0].finish()
    batches = []
    while (out := source.get_output()) is not None:
        batches.append(out)
    assert source.is_finished()
    assert [r for b in batches for r in b.to_pylist()] == [
        ("ALGERIA",), ("ARGENTINA",), ("CHINA",), ("AFRICA",), ("ASIA",)]
    # one code space: every batch carries the same dictionary, and codes
    # name distinct strings distinctly
    assert len({id(b.columns[0].dictionary) for b in batches}) == 1
    codes = torch.cat([b.columns[0].values for b in batches]).tolist()
    assert len(set(codes)) == 5


def test_union_recodes_a_null_only_input():
    """A NULL literal column carries an empty dictionary: re-coding it
    leaves its (unused) codes alone."""
    names = Dictionary()
    buffer = UnionBuffer(2)
    sink0 = UnionSinkOperatorFactory(buffer, 0).create(_ctx("sink0"))
    sink1 = UnionSinkOperatorFactory(buffer, 1).create(_ctx("sink1"))
    sink0.add_input(_names(["A"], names))
    nulls = Column(T.VARCHAR, torch.zeros(2, dtype=torch.int32),
                   torch.zeros(2, dtype=torch.bool), Dictionary())
    sink1.add_input(Batch((nulls,), 2))
    sink0.finish()
    sink1.finish()
    source = UnionSourceOperatorFactory(buffer).create(_ctx("source"))
    assert _drain(source) == [("A",), (None,), (None,)]


def test_batch_from_pylist_equals_jax():
    rows = [(1, "x", 2.5, datetime.date(1995, 1, 1), True),
            (None, "y", None, None, False),
            (3, None, -1.0, datetime.date(1970, 1, 2), None)]
    schema = ["bigint", "varchar", "double", "date", "boolean"]
    got = batch_from_pylist([T.parse_type(s) for s in schema], rows, "cpu")
    want = jax_batch_from_pylist([JT.parse_type(s) for s in schema], rows)
    assert got.device == torch.device("cpu")
    assert got.to_pylist() == want.to_pylist() == rows
    for g, w in zip(got.columns, want.columns):
        assert g.values.numpy().tobytes() == np.asarray(w.values).tobytes()
        assert (g.valid is None) == (w.valid is None)
        if w.valid is not None:
            assert g.valid.numpy().tolist() == np.asarray(w.valid).tolist()
