"""presto_tpu_torch stands alone: no jax, no presto_tpu.

The pytest process already has jax imported (tests/conftest.py), so the
import-and-run check happens in a fresh interpreter whose import system
refuses jax and presto_tpu.  An AST walk over the package (and the chip
smoke script) pins that no module names either in an import.
"""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "presto_tpu_torch")

_BLOCKED = ("jax", "jaxlib", "presto_tpu")

_CHILD = r"""
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "presto_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import importlib  # noqa: E402
import pkgutil  # noqa: E402

import presto_tpu_torch  # noqa: E402
from presto_tpu_torch.localrunner import LocalQueryRunner  # noqa: E402

# every module of the package, the hash tiers and kernel wrappers included
names = [m.name for m in pkgutil.walk_packages(presto_tpu_torch.__path__,
                                               "presto_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("presto_tpu_torch.ops.hashtable",
             "presto_tpu_torch.ops.probe_insert", "presto_tpu_torch.ops.join",
             "presto_tpu_torch.exec.joinop",
             "presto_tpu_torch.exec.dynamicfilter",
             "presto_tpu_torch.connectors.tpcds",
             "presto_tpu_torch.ops.window", "presto_tpu_torch.exec.windowop",
             "presto_tpu_torch.exec.streamagg"):
    assert name in names, name

sql = '''
select l_returnflag, l_linestatus, sum(l_quantity), avg(l_discount),
       count(*)
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
'''
runner = LocalQueryRunner.tpch(scale=0.01, device="cpu")
rows = runner.execute(sql).rows
assert len(rows) == 4, rows
q3 = '''
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
'''
assert len(runner.execute(q3).rows) == 10
# the tpcds catalog, a window and a streaming GROUP BY
ds = runner.execute(
    "select d_year, count(*), rank() over (order by count(*) desc) "
    "from tpcds.store_sales, tpcds.date_dim "
    "where ss_sold_date_sk = d_date_sk group by d_year")
assert len(ds.rows) == 13, ds.rows
runner.execute("select l_orderkey, sum(l_quantity) from lineitem "
               "group by l_orderkey")
ops = [s.operator for s in runner._last_task.operator_stats]
assert any("StreamingAggregation" in o for o in ops), ops
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("rows", len(rows))
"""


def test_import_and_q1_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "rows 4" in proc.stdout


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_module_imports_jax_or_presto_tpu():
    bad = []
    n = 0
    for path in _sources():
        n += 1
        for name in _imported_names(path):
            if name.split(".")[0] in _BLOCKED:
                bad.append((os.path.relpath(path, ROOT), name))
    assert n > 20
    assert not bad, bad
