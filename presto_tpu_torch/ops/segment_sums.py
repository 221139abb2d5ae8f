"""Direct GROUP BY segment sums: the hand-written Hopper kernel and its
plain version.

``direct_segment_sums(gid, vals, n_seg)`` returns the ``[n_seg, A]``
float64 per-group sums of ``vals [N, A]`` (float64) by ``gid [N]`` (int32
in ``[0, n_seg)``).  It is the port of the TPU kernel
``presto_tpu/ops/pallas_groupby.py:direct_segment_sums_pallas`` (body
``_kernel``), without that kernel's TPU workarounds: the card adds
float64 natively (no hi/lo split, no Kahan pairs) and the kernel masks
its own ragged edge (no 4096-row rule).

- On a CUDA tensor the wrapper launches ``csrc/segment_sums.cu`` (built
  with nvcc for sm_90a at first use) or raises.  Its sums are the same
  bits on every run: the kernel uses no float atomics.
- On a CPU tensor it takes the plain version,
  ``direct_segment_sums_reference`` (``index_add_`` in float64).

``LAUNCHES`` counts kernel launches, so a run can show that its group
sums went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from presto_tpu_torch.cuda_build import LaunchCounter, load

MAX_SEGMENTS = 32          # the kernel keeps one register per segment
MAX_COLUMNS = 1024         # one thread per column at least
_SMEM_LIMIT = 232448       # bytes of shared memory a block may use (H100)
_MAX_BLOCKS = 1024
_MIN_ROWS_PER_BLOCK = 2048

LAUNCHES = LaunchCounter()


def direct_segment_sums_reference(gid: torch.Tensor, vals: torch.Tensor,
                                  n_seg: int) -> torch.Tensor:
    """The plain version: ``index_add_`` in float64."""
    out = torch.zeros((n_seg, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, gid.long(), vals)


def _check(gid: torch.Tensor, vals: torch.Tensor, n_seg: int) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise TypeError(f"gid must be int32 [N], got {gid.dtype} "
                        f"{tuple(gid.shape)}")
    if vals.dtype != torch.float64 or vals.dim() != 2:
        raise TypeError(f"vals must be float64 [N, A], got {vals.dtype} "
                        f"{tuple(vals.shape)}")
    if gid.shape[0] != vals.shape[0]:
        raise ValueError(f"gid has {gid.shape[0]} rows, vals "
                         f"{vals.shape[0]}")
    if gid.device != vals.device:
        raise ValueError(f"gid on {gid.device}, vals on {vals.device}")
    if not (gid.is_contiguous() and vals.is_contiguous()):
        raise ValueError("gid and vals must be contiguous")
    n, a = vals.shape
    if not 1 <= n_seg <= MAX_SEGMENTS:
        raise ValueError(f"n_seg={n_seg} outside [1, {MAX_SEGMENTS}]")
    if not 1 <= a <= MAX_COLUMNS or n_seg * a * 8 > _SMEM_LIMIT:
        raise ValueError(f"{a} columns x {n_seg} segments exceed the "
                         "kernel's shared memory")
    if n:
        lo, hi = torch.aminmax(gid)
        if int(lo) < 0 or int(hi) >= n_seg:
            raise ValueError(f"gid outside [0, {n_seg}): "
                             f"[{int(lo)}, {int(hi)}]")


def _entry():
    """The kernel's C entry point, with every argument type declared
    (pointers and the stream as void*, or ctypes would cut them to 32
    bits)."""
    fn = load("segment_sums").presto_segment_sums
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
    return fn


def _launch(gid: torch.Tensor, vals: torch.Tensor,
            n_seg: int) -> torch.Tensor:
    fn = _entry()
    n, a = vals.shape
    blocks = max(1, min(_MAX_BLOCKS, -(-n // _MIN_ROWS_PER_BLOCK)))
    rows_per_block = -(-n // blocks)
    out = torch.empty((n_seg, a), dtype=torch.float64, device=vals.device)
    partials = torch.empty((blocks, n_seg, a), dtype=torch.float64,
                           device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ctypes.c_void_p(gid.data_ptr()),
                ctypes.c_void_p(vals.data_ptr()),
                ctypes.c_void_p(out.data_ptr()),
                ctypes.c_void_p(partials.data_ptr()),
                n, a, n_seg, blocks, rows_per_block,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"segment_sums kernel launch failed: cudaError "
                           f"{rc}")
    LAUNCHES.add()
    return out


def direct_segment_sums(gid: torch.Tensor, vals: torch.Tensor,
                        n_seg: int) -> torch.Tensor:
    """``[n_seg, A]`` float64 sums of ``vals`` rows by ``gid``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    _check(gid, vals, n_seg)
    if vals.device.type == "cpu":
        return direct_segment_sums_reference(gid, vals, n_seg)
    if vals.device.type != "cuda":
        raise NotImplementedError(
            f"direct_segment_sums has no kernel for {vals.device}")
    return _launch(gid, vals, n_seg)
