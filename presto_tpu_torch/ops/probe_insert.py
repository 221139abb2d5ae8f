"""Open-addressing probe-insert and lookup: the hand-written Hopper kernel
B2 and its plain version.

``insert(keys, live, t_words, t_ctrl)`` inserts-or-finds every live row's
key (int64 ``[N, k]``) in a power-of-two table (layout in
ops/hashtable.py) and returns ``(slot [N] int32, ok)``; ``lookup(...)``
walks the same table read-only and returns ``(slot [N] int32,
found [N] bool)``.  They are the port of the TPU kernel
``presto_tpu/ops/pallas_hash.py:pallas_probe_insert`` (body
``_insert_kernel``) and of the claim loop the JAX package ships
(``presto_tpu/ops/hashtable.py`` ``probe_insert``/``probe_find``), and
serve both hash tiers: the PagesHash join build (insert) and probe
(lookup), and the GroupByHash update and rehash (insert).

- On a CUDA tensor the wrapper launches ``csrc/probe_insert.cu`` (built
  with nvcc for sm_90a at first use) or raises.  Slot ids depend on which
  thread wins a contended slot and may change from run to run; the group
  partition does not (same key -> same slot, distinct keys -> distinct
  slots), nor the found flags, nor ``ok``.
- On a CPU tensor it takes the plain version, the claim loop
  (``ops/hashtable.py`` ``probe_insert``/``probe_find``).

``INSERT_LAUNCHES`` and ``LOOKUP_LAUNCHES`` count kernel launches, so a
run can show that its hash tables went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from presto_tpu_torch.cuda_build import LaunchCounter, load
from presto_tpu_torch.ops import hashtable as H

MAX_PROBES = 256           # the claim loop's round bound, min(cap, 256)
_THREADS = 256

INSERT_LAUNCHES = LaunchCounter()
LOOKUP_LAUNCHES = LaunchCounter()


def _check(keys: torch.Tensor, live: Optional[torch.Tensor],
           t_words: torch.Tensor, t_ctrl: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise TypeError(f"keys must be int64 [N, k], got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if live is not None and (live.dtype != torch.bool or live.dim() != 1
                             or live.shape[0] != keys.shape[0]):
        raise TypeError(f"live must be bool [{keys.shape[0]}], got "
                        f"{live.dtype} {tuple(live.shape)}")
    cap = t_ctrl.shape[0]
    if t_ctrl.dtype != torch.int32 or t_ctrl.dim() != 1:
        raise TypeError(f"t_ctrl must be int32 [cap], got {t_ctrl.dtype} "
                        f"{tuple(t_ctrl.shape)}")
    if (t_words.dtype != torch.int64
            or tuple(t_words.shape) != (cap, keys.shape[1])):
        raise TypeError(f"t_words must be int64 [{cap}, {keys.shape[1]}], "
                        f"got {t_words.dtype} {tuple(t_words.shape)}")
    if cap < 1 or cap & (cap - 1) or cap > 1 << 30:
        raise ValueError(f"table capacity {cap} is not a power of two "
                         "in [1, 2^30]")
    tensors = [keys, t_words, t_ctrl] + ([] if live is None else [live])
    if any(t.device != keys.device for t in tensors):
        raise ValueError("keys, live and the table must share a device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("keys, live and the table must be contiguous")


def _entries():
    """The kernel's C entry points, every argument type declared
    (pointers and the stream as void*, or ctypes would cut them to 32
    bits)."""
    lib = load("probe_insert")
    ins, look = lib.presto_probe_insert, lib.presto_probe_lookup
    if ins.argtypes is None:
        ins.restype = look.restype = ctypes.c_int
        ins.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        look.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return ins, look


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _blocks(n: int) -> int:
    return -(-n // _THREADS)


def launch_insert(keys: torch.Tensor, live: Optional[torch.Tensor],
                  t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """One launch of the insert kernel: ``(slot, fail)`` with ``fail`` a
    one-element int32 device flag (1 where a row exhausted its probe
    bound).  Reads nothing back."""
    ins, _ = _entries()
    n, k = keys.shape
    cap = t_ctrl.shape[0]
    slot = torch.empty(n, dtype=torch.int32, device=keys.device)
    fail = torch.zeros(1, dtype=torch.int32, device=keys.device)
    if n == 0:
        return slot, fail
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = ins(_ptr(keys), k, _ptr(live), n, _ptr(t_words), _ptr(t_ctrl),
                 cap, min(cap, MAX_PROBES), _ptr(slot), _ptr(fail),
                 _blocks(n), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"probe_insert kernel launch failed: cudaError "
                           f"{rc}")
    INSERT_LAUNCHES.add()
    return slot, fail


def launch_lookup(keys: torch.Tensor, live: Optional[torch.Tensor],
                  t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """One launch of the lookup kernel: ``(slot, found)``; not-found and
    dead rows get slot == cap."""
    _, look = _entries()
    n, k = keys.shape
    cap = t_ctrl.shape[0]
    slot = torch.empty(n, dtype=torch.int32, device=keys.device)
    found = torch.empty(n, dtype=torch.bool, device=keys.device)
    if n == 0:
        return slot, found
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = look(_ptr(keys), k, _ptr(live), n, _ptr(t_words), _ptr(t_ctrl),
                  cap, _ptr(slot), _ptr(found), _blocks(n),
                  ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"probe_lookup kernel launch failed: cudaError "
                           f"{rc}")
    LOOKUP_LAUNCHES.add()
    return slot, found


def _device_of(keys: torch.Tensor, name: str) -> str:
    kind = keys.device.type
    if kind not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name} has no kernel for {keys.device}")
    return kind


def insert(keys: torch.Tensor, live: Optional[torch.Tensor],
           t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """Insert-or-find every live row (``live`` None: every row), in place:
    ``(slot [N] int32, ok)``.  The CUDA kernel for a CUDA tensor, the
    plain claim loop for a CPU tensor."""
    _check(keys, live, t_words, t_ctrl)
    if _device_of(keys, "probe_insert") == "cpu":
        if live is None:
            live = torch.ones(keys.shape[0], dtype=torch.bool)
        return H.probe_insert(keys, live, t_words, t_ctrl)
    slot, fail = launch_insert(keys, live, t_words, t_ctrl)
    return slot, not bool(fail.item())


def lookup(keys: torch.Tensor, live: Optional[torch.Tensor],
           t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """Read-only walk: ``(slot [N] int32, found [N] bool)``.  The CUDA
    kernel for a CUDA tensor, the plain claim loop for a CPU tensor."""
    _check(keys, live, t_words, t_ctrl)
    if _device_of(keys, "probe_lookup") == "cpu":
        if live is None:
            live = torch.ones(keys.shape[0], dtype=torch.bool)
        return H.probe_find(keys, live, t_words, t_ctrl)
    return launch_lookup(keys, live, t_words, t_ctrl)
