"""Direct GROUP BY segment sums: the hand-written Hopper kernel and its
plain version.

``direct_segment_sums(gid, cols, n_seg)`` returns ``(sums, bad)``:
``sums`` the ``[n_seg, A]`` float64 per-group sums of the A float64
columns ``cols`` (each ``[N]``, contiguous) by ``gid [N]`` (int32 in
``[0, n_seg)``), and ``bad`` an int32 ``[1]`` count of the rows whose
group id lay outside ``[0, n_seg)`` (those rows add nothing).  It is the
port of the TPU kernel
``presto_tpu/ops/pallas_groupby.py:direct_segment_sums_pallas`` (body
``_kernel``), without that kernel's TPU workarounds: the card adds
float64 natively (no hi/lo split, no Kahan pairs), reads each column where
it lies (no stacked ``[N, A]`` block) and masks its own ragged edge (no
4096-row rule).

- On a CUDA tensor the wrapper launches ``csrc/segment_sums.cu`` (built
  with nvcc for sm_90a at first use) or raises.  It reads nothing back
  from the device: ``bad`` stays on the card for the caller to read at a
  host read it makes anyway, and a call can be captured in a CUDA graph.
  The sums are the same bits on every run: the kernel uses no float
  atomics and folds in a fixed order.
- On a CPU tensor it takes the plain version,
  ``direct_segment_sums_reference`` (``index_add_`` in float64 over the
  stacked columns), after a host check of the group ids that raises
  ``ValueError``; ``bad`` is then 0.

``launch`` is the kernel's call into buffers the caller made (``buffers``),
with no check and no allocation, for timing the device alone.  ``LAUNCHES``
counts kernel launches, so a run can show that its group sums went
through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from presto_tpu_torch.cuda_build import LaunchCounter, load

MAX_SEGMENTS = 32          # the largest build keeps 32 totals a thread

LAUNCHES = LaunchCounter()

# (device index, columns, n_seg) -> (columns a launch takes, resident
# blocks), from the build's registers and shared memory on that card
_plans: Dict[Tuple[int, int, int], Tuple[int, int]] = {}


def direct_segment_sums_reference(gid: torch.Tensor,
                                  cols: Sequence[torch.Tensor],
                                  n_seg: int) -> torch.Tensor:
    """The plain version: ``index_add_`` in float64 of the stacked
    columns."""
    vals = torch.stack(list(cols), 1)
    out = torch.zeros((n_seg, vals.shape[1]), dtype=torch.float64,
                      device=vals.device)
    return out.index_add_(0, gid.long(), vals)


def _check(gid: torch.Tensor, cols: Sequence[torch.Tensor],
           n_seg: int) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise TypeError(f"gid must be int32 [N], got {gid.dtype} "
                        f"{tuple(gid.shape)}")
    if not gid.is_contiguous():
        raise ValueError("gid must be contiguous")
    if not cols:
        raise ValueError("no columns to sum")
    n = gid.shape[0]
    for i, c in enumerate(cols):
        if c.dtype != torch.float64 or c.dim() != 1:
            raise TypeError(f"column {i} must be float64 [N], got "
                            f"{c.dtype} {tuple(c.shape)}")
        if c.shape[0] != n:
            raise ValueError(f"gid has {n} rows, column {i} "
                             f"{c.shape[0]}")
        if c.device != gid.device:
            raise ValueError(f"gid on {gid.device}, column {i} on "
                             f"{c.device}")
        if not c.is_contiguous():
            raise ValueError(f"column {i} must be contiguous")
    if not 1 <= n_seg <= MAX_SEGMENTS:
        raise ValueError(f"n_seg={n_seg} outside [1, {MAX_SEGMENTS}]")


def _lib():
    """The kernel's library, with every entry's argument types declared
    (pointers and the stream as void*, or ctypes would cut them to 32
    bits)."""
    lib = load("segment_sums")
    fn = lib.presto_segment_sums
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        plan = lib.presto_segment_sums_plan
        plan.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_int)]
        lib.presto_segment_sums_step_rows.restype = ctypes.c_int
        lib.presto_segment_sums_step_rows.argtypes = []
    return lib


def _plan(device: torch.device, ncols: int, n_seg: int) -> Tuple[int, int]:
    """(columns a launch takes, resident blocks of that width) on
    ``device``, asked of the runtime once per shape."""
    key = (device.index, ncols, n_seg)
    got = _plans.get(key)
    if got is None:
        per, blocks = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _lib().presto_segment_sums_plan(ncols, n_seg,
                                                 ctypes.byref(per),
                                                 ctypes.byref(blocks))
        if rc != 0 or per.value < 1 or blocks.value < 1:
            raise RuntimeError(f"segment_sums: no launch plan for {ncols} "
                               f"columns, {n_seg} segments (cudaError {rc})")
        got = _plans[key] = (per.value, blocks.value)
    return got


def _grid(gid: torch.Tensor, ncols: int, n_seg: int) -> Tuple[int, int]:
    """(columns a launch takes, blocks): the columns spread evenly over as
    few launches as the build allows, and the resident blocks of that
    width, fewer when the input has fewer row tiles than that."""
    most, _ = _plan(gid.device, ncols, n_seg)
    per, resident = _plan(gid.device, -(-ncols // -(-ncols // most)), n_seg)
    step = _lib().presto_segment_sums_step_rows()
    return per, max(1, min(resident, -(-gid.shape[0] // step)))


def buffers(gid: torch.Tensor, cols: Sequence[torch.Tensor], n_seg: int):
    """``(out, partials, bad)`` for one call: the ``[n_seg, A]`` sums, the
    per-block partials, and the int32 ``[1]`` status word, zeroed."""
    per, blocks = _grid(gid, len(cols), n_seg)
    dev = gid.device
    out = torch.empty((n_seg, len(cols)), dtype=torch.float64, device=dev)
    partials = torch.empty(blocks * n_seg * per, dtype=torch.float64,
                           device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    return out, partials, bad


def launch(gid: torch.Tensor, cols: Sequence[torch.Tensor], n_seg: int,
           out: torch.Tensor, partials: torch.Tensor,
           bad: torch.Tensor) -> None:
    """The kernel into ``buffers(gid, cols, n_seg)``: one launch per
    ``per`` columns, on the current stream; no check, no allocation, no
    device read.  The out-of-range rows are added to ``bad``."""
    per, blocks = _grid(gid, len(cols), n_seg)
    fn = _lib().presto_segment_sums
    a = len(cols)
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, a, per):
            part = cols[c0:c0 + per]
            ptrs = (ctypes.c_void_p * len(part))(*[c.data_ptr()
                                                   for c in part])
            rc = fn(ctypes.c_void_p(gid.data_ptr()), ptrs, len(part),
                    gid.shape[0], n_seg,
                    ctypes.c_void_p(out.data_ptr() + 8 * c0), a,
                    ctypes.c_void_p(partials.data_ptr()),
                    # the first launch counts the out-of-range rows
                    ctypes.c_void_p(bad.data_ptr() if c0 == 0 else None),
                    blocks, ctypes.c_void_p(stream))
            if rc != 0:
                raise RuntimeError(f"segment_sums kernel launch failed: "
                                   f"cudaError {rc}")
            LAUNCHES.add()


def direct_segment_sums(gid: torch.Tensor, cols: Sequence[torch.Tensor],
                        n_seg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([n_seg, A] float64 sums of the columns by gid, int32 [1] count
    of out-of-range rows)``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    cols = list(cols)
    _check(gid, cols, n_seg)
    if gid.device.type == "cpu":
        if gid.shape[0]:
            lo, hi = torch.aminmax(gid)
            if int(lo) < 0 or int(hi) >= n_seg:
                raise ValueError(f"gid outside [0, {n_seg}): "
                                 f"[{int(lo)}, {int(hi)}]")
        return (direct_segment_sums_reference(gid, cols, n_seg),
                torch.zeros(1, dtype=torch.int32))
    if gid.device.type != "cuda":
        raise NotImplementedError(
            f"direct_segment_sums has no kernel for {gid.device}")
    out, partials, bad = buffers(gid, cols, n_seg)
    launch(gid, cols, n_seg, out, partials, bad)
    return out, bad
