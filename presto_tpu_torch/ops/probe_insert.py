"""Open-addressing probe-insert and lookup: the hand-written Hopper kernel
B2 and its plain version.

``insert(keys, live, t_words, t_ctrl)`` inserts-or-finds every live row's
key (int64 ``[N, k]``) in a power-of-two table (layout in
ops/hashtable.py) and returns ``(slot [N] int32, ok)``;
``insert_claims(...)`` returns ``(slot, ok, n_claimed, journal)``: the
count of slots the call turned from empty to ready, and the journal of
them (int32 ``[N]``: the slot each row claimed, one row per claimed slot,
-1 elsewhere), so a caller counts its groups without reading the table
and undoes a failed insert slot by slot.  ``lookup(...)`` walks the
same table read-only and returns ``(slot [N] int32, found [N] bool)``;
``lookup_ranges(..., starts, counts)`` returns each row's PagesHash match
range ``(lo, cnt)`` (int64) directly.  They are the port of the TPU
kernel ``presto_tpu/ops/pallas_hash.py:pallas_probe_insert`` (body
``_insert_kernel``) and of the claim loop the JAX package ships
(``presto_tpu/ops/hashtable.py`` ``probe_insert``/``probe_find``), and
serve both hash tiers: the PagesHash join build (insert) and probe
(lookup), and the GroupByHash update and rehash (insert).

- On a CUDA tensor the wrapper launches ``csrc/probe_insert.cu`` (built
  with nvcc for sm_90a at first use) on that tensor's card and its current
  stream, or raises (also for a table of fewer than ``WINDOW`` slots,
  which the hash tiers never make).  An insert reads the device once
  (its ``[fail, claimed]`` status word); a lookup reads nothing.  Slot ids depend on which thread wins a contended slot and may
  change from run to run; the group partition does not (same key -> same
  slot, distinct keys -> distinct slots), nor the found flags, nor ``ok``.
  A failed insert stops early, so its slots say nothing (every caller
  discards them); its journal still lists every slot it filled.
- On a CPU tensor it takes the plain version: the claim loop
  (``ops/hashtable.py`` ``probe_insert``/``probe_find``; the journal
  names each new slot's winner, its first row), and
  ``lookup_ranges_reference`` for the ranges.

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
# the kernel's probe window W (kWindow in csrc/probe_insert.cu, fixed when
# it is built): the control words a row reads per round trip, one 32-byte
# sector.  A table on the card holds at least one window.
WINDOW = 8

INSERT_LAUNCHES = LaunchCounter()
LOOKUP_LAUNCHES = LaunchCounter()

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_INSERT_ARGS = [_VP, _INT, _VP, _LL, _VP, _VP, _INT, _INT, _VP, _VP, _VP,
                _VP]
_LOOKUP_ARGS = [_VP, _INT, _VP, _LL, _VP, _VP, _INT, _VP, _VP, _VP, _VP,
                _VP, _VP, _VP]
_entries_cache = []


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


def _check_ranges(t_ctrl: torch.Tensor, starts: torch.Tensor,
                  counts: torch.Tensor) -> None:
    cap = t_ctrl.shape[0]
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32 or tuple(t.shape) != (cap,):
            raise TypeError(f"{name} must be int32 [{cap}], got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != t_ctrl.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on the table's "
                             "device")


def _entries():
    """The kernel's C entry points, resolved once with every argument type
    declared (pointers and the stream as void*, or ctypes would cut them
    to 32 bits)."""
    if not _entries_cache:
        lib = load("probe_insert")
        ins, look = lib.presto_probe_insert, lib.presto_probe_lookup
        ins.restype = look.restype = ctypes.c_int
        ins.argtypes = _INSERT_ARGS
        look.argtypes = _LOOKUP_ARGS
        _entries_cache.append((ins, look))
    return _entries_cache[0]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_windows(t_ctrl: torch.Tensor) -> None:
    """The kernel reads whole aligned windows of control words."""
    if t_ctrl.shape[0] < WINDOW or t_ctrl.data_ptr() % (4 * WINDOW):
        raise ValueError(f"the kernel needs a table of at least {WINDOW} "
                         f"slots with its control words {4 * WINDOW}-byte "
                         f"aligned, got {t_ctrl.shape[0]} at "
                         f"{t_ctrl.data_ptr():#x}")


def _launch(entry, device: torch.device, *args) -> int:
    """Call a C entry with the stream of ``device`` last, on that device
    (made current only for the call when it is not)."""
    if device.index == torch.cuda.current_device():
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)


def launch_insert(keys: torch.Tensor, live: Optional[torch.Tensor],
                  t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """One launch of the insert kernel: ``(slot, status, journal)``, with
    ``status`` the int32 ``[fail, claimed]`` device word and ``journal``
    the slot each row claimed (-1: none).  Reads nothing back."""
    ins, _ = _entries()
    _check_windows(t_ctrl)
    n, k = keys.shape
    cap = t_ctrl.shape[0]
    slot = torch.empty(n, dtype=torch.int32, device=keys.device)
    status = torch.empty(2, dtype=torch.int32, device=keys.device)
    journal = torch.empty(n, dtype=torch.int32, device=keys.device)
    rc = _launch(ins, keys.device, keys.data_ptr(), k, _ptr(live), n,
                 t_words.data_ptr(), t_ctrl.data_ptr(), cap,
                 min(cap, MAX_PROBES), slot.data_ptr(), status.data_ptr(),
                 journal.data_ptr())
    if rc != 0:
        raise RuntimeError(f"probe_insert kernel launch failed: cudaError "
                           f"{rc}")
    if n > 0:
        INSERT_LAUNCHES.add()
    return slot, status, journal


def launch_lookup(keys: torch.Tensor, live: Optional[torch.Tensor],
                  t_words: torch.Tensor, t_ctrl: torch.Tensor,
                  starts: Optional[torch.Tensor] = None,
                  counts: Optional[torch.Tensor] = None):
    """One launch of the lookup kernel: ``(slot, found)`` (not-found and
    dead rows get slot == cap), or with ``starts``/``counts`` the int64
    ranges ``(lo, cnt)`` ((0, 0) where not found or dead)."""
    _, look = _entries()
    _check_windows(t_ctrl)
    n, k = keys.shape
    cap = t_ctrl.shape[0]
    device = keys.device
    if starts is None:
        a = torch.empty(n, dtype=torch.int32, device=device)
        b = torch.empty(n, dtype=torch.bool, device=device)
        outs = (a.data_ptr(), b.data_ptr(), None, None, None, None)
    else:
        a = torch.empty(n, dtype=torch.int64, device=device)
        b = torch.empty(n, dtype=torch.int64, device=device)
        outs = (None, None, starts.data_ptr(), counts.data_ptr(),
                a.data_ptr(), b.data_ptr())
    if n == 0:
        return a, b
    rc = _launch(look, device, keys.data_ptr(), k, _ptr(live), n,
                 t_words.data_ptr(), t_ctrl.data_ptr(), cap, *outs)
    if rc != 0:
        raise RuntimeError(f"probe_lookup kernel launch failed: cudaError "
                           f"{rc}")
    LOOKUP_LAUNCHES.add()
    return a, b


def _device_of(keys: torch.Tensor, name: str) -> str:
    kind = keys.device.type
    if kind not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name} has no kernel for {keys.device}")
    return kind


def _all_live(keys: torch.Tensor, live: Optional[torch.Tensor]):
    if live is None:
        return torch.ones(keys.shape[0], dtype=torch.bool,
                          device=keys.device)
    return live


def _plain_insert(keys: torch.Tensor, live: torch.Tensor,
                  t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """The claim loop with the kernel's journal: the slot of each slot's
    winner (the lowest row that placed its key there, as the loop's
    scatter-min picks it) where the slot was empty before the call."""
    n = keys.shape[0]
    cap = t_ctrl.shape[0]
    device = keys.device
    was_free = torch.cat([t_ctrl == H.EMPTY,
                          torch.zeros(1, dtype=torch.bool, device=device)])
    slot, ok = H.probe_insert(keys, live, t_words, t_ctrl)
    s = slot.to(torch.int64)
    rows = torch.arange(n, device=device)
    first = torch.full((cap + 1,), n, dtype=torch.int64,
                       device=device).scatter_reduce_(0, s, rows, "amin")
    winner = was_free[s] & (first[s] == rows)
    journal = torch.where(winner, slot, -1).to(torch.int32)
    return slot, ok, int(winner.sum()), journal


def insert_claims(keys: torch.Tensor, live: Optional[torch.Tensor],
                  t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """Insert-or-find every live row (``live`` None: every row), in place:
    ``(slot [N] int32, ok, n_claimed, journal [N] int32)``, the journal
    holding the slot each row turned from empty to ready (one row per
    such slot; -1 for the others).  The CUDA kernel for a CUDA tensor (one
    read of the device), the plain claim loop for a CPU tensor."""
    _check(keys, live, t_words, t_ctrl)
    if _device_of(keys, "probe_insert") == "cpu":
        return _plain_insert(keys, _all_live(keys, live), t_words, t_ctrl)
    if keys.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.int32, device=keys.device)
        return empty, True, 0, empty
    slot, status, journal = launch_insert(keys, live, t_words, t_ctrl)
    fail, n_claimed = status.tolist()
    return slot, not fail, n_claimed, journal


def insert(keys: torch.Tensor, live: Optional[torch.Tensor],
           t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """``insert_claims`` without the journal: ``(slot, ok)``."""
    slot, ok, _n, _journal = insert_claims(keys, live, t_words, t_ctrl)
    return slot, ok


def lookup(keys: torch.Tensor, live: Optional[torch.Tensor],
           t_words: torch.Tensor, t_ctrl: torch.Tensor):
    """Read-only walk: ``(slot [N] int32, found [N] bool)``.  The CUDA
    kernel for a CUDA tensor, the plain claim loop for a CPU tensor."""
    _check(keys, live, t_words, t_ctrl)
    if _device_of(keys, "probe_lookup") == "cpu":
        return H.probe_find(keys, _all_live(keys, live), t_words, t_ctrl)
    return launch_lookup(keys, live, t_words, t_ctrl)


def lookup_ranges_reference(keys: torch.Tensor, live: torch.Tensor,
                            t_words: torch.Tensor, t_ctrl: torch.Tensor,
                            starts: torch.Tensor, counts: torch.Tensor):
    """The plain version of the fused lookup: the claim loop's walk, then
    each hit row's ``(starts, counts)`` at its slot, (0, 0) elsewhere."""
    slot, found = H.probe_find(keys, live, t_words, t_ctrl)
    hit = live & found
    s = torch.where(hit, slot.to(torch.int64), 0)
    lo = torch.where(hit, starts[s].to(torch.int64), 0)
    cnt = torch.where(hit, counts[s].to(torch.int64), 0)
    return lo, cnt


def lookup_ranges(keys: torch.Tensor, live: Optional[torch.Tensor],
                  t_words: torch.Tensor, t_ctrl: torch.Tensor,
                  starts: torch.Tensor, counts: torch.Tensor):
    """Each row's match range in a PagesHash table: ``(lo, cnt)`` int64
    ``[N]``, ``starts[slot]``/``counts[slot]`` where the live row's key is
    in the table and (0, 0) elsewhere.  One kernel launch for a CUDA
    tensor, ``lookup_ranges_reference`` for a CPU tensor."""
    _check(keys, live, t_words, t_ctrl)
    _check_ranges(t_ctrl, starts, counts)
    if _device_of(keys, "probe_lookup") == "cpu":
        return lookup_ranges_reference(keys, _all_live(keys, live), t_words,
                                       t_ctrl, starts, counts)
    return launch_lookup(keys, live, t_words, t_ctrl, starts, counts)
