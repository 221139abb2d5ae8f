"""Native (C++) host code: the XXH64 hash.

``src/xxh64.cpp`` is compiled with ``g++ -O3`` at first use into
``presto_tpu_torch/build/`` (cached by the source's hash) and loaded
through ctypes.  It is host code, not a device kernel: HyperLogLog hashes
each value on the host (``presto_tpu_torch/sketch.py``).

Without a compiler the module still works: ``xxh64`` falls back to the
pure-Python ``_py_xxh64`` (the same published algorithm, bit-equal), and
``available()`` says which one runs.  The JAX package's LZ4 codec, which
shares its library there, comes with the serde (ROADMAP A11).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "xxh64.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _source_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _build() -> Optional[str]:
    so_path = os.path.join(_BUILD_DIR, f"libxxh64_{_source_hash()}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # compile to a temp path and rename into place, so a concurrent or
    # killed build never leaves a half-written .so at the cached path
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp_path,
           _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.rename(tmp_path, so_path)
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return None
    return so_path


def lib() -> Optional[ctypes.CDLL]:
    """Build-if-needed and load the native library (None if unavailable)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = _build()
        if so_path is None:
            _build_failed = True
            return None
        try:
            cdll = ctypes.CDLL(so_path)
        except OSError:
            # corrupt/incompatible cached artifact: drop it and fall back
            try:
                os.unlink(so_path)
            except OSError:
                pass
            _build_failed = True
            return None
        cdll.pt_xxh64.restype = ctypes.c_uint64
        cdll.pt_xxh64.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64]
        _lib = cdll
        return _lib


def available() -> bool:
    """True when ``xxh64`` runs the g++ build."""
    return lib() is not None


def xxh64(data: bytes, seed: int = 0) -> int:
    cdll = lib()
    if cdll is None:
        return _py_xxh64(data, seed)
    return int(cdll.pt_xxh64(data, len(data), seed))


_M64 = (1 << 64) - 1
_XP1 = 11400714785074694791
_XP2 = 14029467366897019727
_XP3 = 1609587929392839161
_XP4 = 9650029242287828579
_XP5 = 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, val: int) -> int:
    return (_rotl((acc + val * _XP2) & _M64, 31) * _XP1) & _M64


def _py_xxh64(data: bytes, seed: int = 0) -> int:
    """Pure-Python XXH64 (same published algorithm as xxh64.cpp)."""
    import struct as _struct

    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _XP1 + _XP2) & _M64
        v2 = (seed + _XP2) & _M64
        v3 = seed & _M64
        v4 = (seed - _XP1) & _M64
        while p + 32 <= n:
            a, b, c, d = _struct.unpack_from("<QQQQ", data, p)
            v1, v2, v3, v4 = (_round(v1, a), _round(v2, b), _round(v3, c),
                              _round(v4, d))
            p += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _XP1 + _XP4) & _M64
    else:
        h = (seed + _XP5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = _struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _XP1 + _XP4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = _struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (k * _XP1) & _M64, 23) * _XP2 + _XP3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _XP5) & _M64, 11) * _XP1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _XP2) & _M64
    h ^= h >> 29
    h = (h * _XP3) & _M64
    h ^= h >> 32
    return h
