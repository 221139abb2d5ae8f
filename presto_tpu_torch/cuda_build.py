"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C entry point.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``presto_tpu_torch/build/`` at first use, cached by the source's hash,
and loaded with ``ctypes``.  Nothing here runs at import: the CPU-only
host that runs the tests has no ``nvcc``, and imports every module.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them: the set-up step of a run on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) per built kernel
build_logs: Dict[str, str] = {}


class LaunchCounter:
    """Counts a wrapper's kernel launches (thread-safe).  A run resets it
    before the work it wants to attribute and reads it after."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _so_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (name, so_path, tmp, process) or
    None when the cached library is already there."""
    so_path = _so_path(name)
    if os.path.exists(so_path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a temp path and rename into place, so a concurrent or
    # killed build never leaves a half-written library at the cached path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           os.path.join(SRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, so_path, tmp, proc


def _finish(job, timeout: float) -> None:
    name, so_path, tmp, proc = job
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        os.unlink(tmp)
        raise RuntimeError(f"nvcc timed out building {name}") from None
    build_logs[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}:\n{out}")
    os.replace(tmp, so_path)


def build_all(names: Optional[Sequence[str]] = None,
              timeout: float = 600.0) -> None:
    """Build every kernel (or ``names``), one nvcc each, in parallel."""
    names = sources() if names is None else list(names)
    with _lock:
        jobs = [j for j in (_start(n) for n in names) if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job, timeout)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_so_path(name))
    return lib
