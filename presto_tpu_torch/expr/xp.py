"""Array namespaces for compiled expressions.

``expr/compile.py`` runs every compiled expression over an ``xp``
namespace with numpy's names (``where``, ``floor_divide``,
``take(..., axis=0)``, ``astype`` ...).  Two namespaces implement it:

- ``NUMPY``: numpy itself plus the few names numpy spells as array
  methods (``astype``).  The host path (constant folding, dictionary
  lookups built at compile time) runs on it.
- ``TorchXp(device)``: the same names over torch tensors on one device.
  torch has no ``take(axis=)``, takes dtypes as ``torch.dtype`` and
  builds new tensors on an explicit device, so each name is adapted
  here.

Dtypes may be given in numpy's spellings (``"int64"``, ``np.int32``,
``bool``) to either namespace: the expression code holds the types'
numpy dtypes (``Type.np_dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_OF = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_NUMPY_OF = {v: k for k, v in _TORCH_OF.items()}


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype spelling (or a torch dtype) -> torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _TORCH_OF[np.dtype(dt)]
    except KeyError:
        raise NotImplementedError(
            f"dtype {dt} has no tensor form in this engine") from None


def numpy_dtype(dt) -> np.dtype:
    """torch dtype (or a numpy spelling) -> numpy dtype."""
    if isinstance(dt, torch.dtype):
        return _NUMPY_OF[dt]
    return np.dtype(dt)


class _Numpy:
    """numpy, plus ``astype`` as a function."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def astype(x, dtype):
        return np.asarray(x).astype(numpy_dtype(dtype))


NUMPY = _Numpy()


def _scalar(v):
    """numpy scalars -> Python scalars (torch takes those as weak)."""
    return v.item() if isinstance(v, np.generic) else v


class TorchXp:
    """numpy's names over torch tensors on ``device``."""

    bool_ = torch.bool
    int8 = torch.int8
    int16 = torch.int16
    int32 = torch.int32
    int64 = torch.int64
    float32 = torch.float32
    float64 = torch.float64

    def __init__(self, device):
        self.device = torch.device(device)

    # -- construction -------------------------------------------------------
    def asarray(self, x, dtype=None):
        if isinstance(x, torch.Tensor):
            t = x
        else:
            arr = np.asarray(x)
            if arr.dtype == object:
                raise NotImplementedError("object arrays stay on the host")
            t = torch.from_numpy(np.ascontiguousarray(arr))
        t = t.to(self.device)
        return t if dtype is None else t.to(torch_dtype(dtype))

    def zeros(self, shape, dtype=float):
        return torch.zeros(shape, dtype=torch_dtype(dtype),
                           device=self.device)

    def ones(self, shape, dtype=float):
        return torch.ones(shape, dtype=torch_dtype(dtype),
                          device=self.device)

    def full(self, shape, value, dtype=None):
        dt = torch_dtype(dtype) if dtype is not None else None
        return torch.full((shape,) if isinstance(shape, int) else shape,
                          _scalar(value), dtype=dt, device=self.device)

    @staticmethod
    def zeros_like(x, dtype=None):
        dt = torch_dtype(dtype) if dtype is not None else None
        return torch.zeros_like(x, dtype=dt)

    @staticmethod
    def ones_like(x, dtype=None):
        dt = torch_dtype(dtype) if dtype is not None else None
        return torch.ones_like(x, dtype=dt)

    @staticmethod
    def astype(x, dtype):
        return x.to(torch_dtype(dtype))

    # -- selection and gathers ----------------------------------------------
    def where(self, cond, a, b):
        a, b = _scalar(a), _scalar(b)
        if not isinstance(a, torch.Tensor) and not isinstance(
                b, torch.Tensor):
            a = torch.as_tensor(a, device=self.device)
        return torch.where(cond, a, b)

    def take(self, a, indices, axis=0):
        if axis != 0:
            raise NotImplementedError("take only along axis 0")
        a = self.asarray(a)
        return a.index_select(0, indices.to(self.device).long())

    @staticmethod
    def concatenate(parts):
        return torch.cat(list(parts))

    # -- elementwise --------------------------------------------------------
    abs = staticmethod(torch.abs)
    sign = staticmethod(torch.sign)
    floor = staticmethod(torch.floor)
    ceil = staticmethod(torch.ceil)
    trunc = staticmethod(torch.trunc)
    sqrt = staticmethod(torch.sqrt)
    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    log2 = staticmethod(torch.log2)
    log10 = staticmethod(torch.log10)
    isnan = staticmethod(torch.isnan)
    isinf = staticmethod(torch.isinf)
    isfinite = staticmethod(torch.isfinite)
    radians = staticmethod(torch.deg2rad)
    degrees = staticmethod(torch.rad2deg)
    arctan2 = staticmethod(torch.atan2)
    arcsin = staticmethod(torch.asin)
    arccos = staticmethod(torch.acos)
    arctan = staticmethod(torch.atan)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    tan = staticmethod(torch.tan)
    sinh = staticmethod(torch.sinh)
    cosh = staticmethod(torch.cosh)
    tanh = staticmethod(torch.tanh)
    bitwise_and = staticmethod(torch.bitwise_and)
    bitwise_or = staticmethod(torch.bitwise_or)
    bitwise_xor = staticmethod(torch.bitwise_xor)

    @staticmethod
    def floor_divide(a, b):
        # torch.floor_divide rounds toward -inf, as numpy's does
        return torch.floor_divide(a, _scalar(b))

    @staticmethod
    def mod(a, b):
        # numpy's mod takes the divisor's sign: torch.remainder
        return torch.remainder(a, _scalar(b))

    @staticmethod
    def power(a, b):
        return torch.pow(a, _scalar(b))

    @staticmethod
    def cbrt(x):
        return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)

    def minimum(self, a, b):
        return torch.minimum(self.asarray(a), self.asarray(b))

    def maximum(self, a, b):
        return torch.maximum(self.asarray(a), self.asarray(b))

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, _scalar(lo), _scalar(hi))
