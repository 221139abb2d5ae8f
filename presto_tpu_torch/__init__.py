"""presto_tpu_torch: the SQL engine on PyTorch and CUDA.

The same engine as ``presto_tpu`` (SQL in, rows out, the same plans and
row shapes), with columnar batches held as torch tensors on a CUDA
device and the hot reductions written as hand-built CUDA kernels for
Hopper (``csrc/``).  The package imports neither jax nor ``presto_tpu``:
host-only modules (parser, planner, connectors) are kept as copies.

Entry point::

    from presto_tpu_torch.localrunner import LocalQueryRunner
    runner = LocalQueryRunner.tpch(scale=1.0)          # runs on cuda
    runner.execute("select count(*) from lineitem").rows

Pass ``device="cpu"`` to run on the CPU (the tests do); without it and
without a CUDA device the runner raises.
"""

__version__ = "0.1.0"
