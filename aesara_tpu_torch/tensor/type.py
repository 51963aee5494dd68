"""``TensorType``: dtype plus static shape (None for an unknown dim), and
the variable constructors (reference ``aesara_tpu/tensor/type.py``).

A dimension broadcasts only if its static shape is 1.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Type, Variable
from aesara_tpu_torch.scalar.ops import _np_dtype, all_dtypes, discrete_dtypes


__all__ = ["TensorType", "scalar", "vector", "matrix", "tensor3", "tensor4", "row", "col"]


class TensorType(Type):
    """An array type with a fixed dtype and static shape information."""

    def __init__(self, dtype: str, shape: Optional[Sequence[Optional[int]]] = None):
        if dtype == "floatX":
            dtype = config.floatX
        self.dtype = "bfloat16" if dtype == "bfloat16" else np.dtype(dtype).name
        if self.dtype not in all_dtypes:
            raise TypeError(f"unsupported dtype {dtype!r}")
        self.shape: Tuple[Optional[int], ...] = tuple(
            None if s is None else int(s) for s in (shape or ()))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def clone(self, dtype=None, shape=None, **kwargs) -> "TensorType":
        return type(self)(dtype or self.dtype, self.shape if shape is None else shape)

    def filter(self, data: Any, strict: bool = False, allow_downcast=None):
        """Admit a NumPy value; float64 arrays do not silently become
        float32, Python float literals may."""
        if isinstance(data, Variable):
            raise TypeError("cannot use a Variable as a Type value")
        np_dtype = _np_dtype(self.dtype)
        was_literal = not isinstance(data, np.ndarray)
        arr = np.asarray(data)
        if arr.dtype != np_dtype:
            if strict:
                raise TypeError(f"{self} (strict) got dtype {arr.dtype}")
            ok = allow_downcast or np.can_cast(arr.dtype, np_dtype) or (
                was_literal and arr.dtype.kind == "f" and self.dtype in ("float32", "float16")
            ) or (
                arr.dtype.kind in "iu" and self.dtype in discrete_dtypes
                and np.all(arr == arr.astype(np_dtype))
            )
            if not ok:
                raise TypeError(f"cannot convert dtype {arr.dtype} to {self.dtype} "
                                "without risking precision loss")
            arr = arr.astype(np_dtype)
        self.check_shape(arr.shape)
        return arr

    def check_shape(self, shape) -> None:
        if len(shape) != self.ndim:
            raise TypeError(f"{self}: wrong ndim, expected {self.ndim}, got {len(shape)} "
                            f"(shape {tuple(shape)})")
        for want, got in zip(self.shape, shape):
            if want is not None and want != got:
                raise TypeError(f"{self}: shape mismatch, expected {self.shape}, got {tuple(shape)}")

    def filter_variable(self, other, allow_convert: bool = True):
        if not isinstance(other, Variable):
            other = self.constant_type(type=self.clone(shape=np.shape(other)), data=other)
        if other.type == self:
            return other
        if allow_convert:
            conv = self.convert_variable(other)
            if conv is not None:
                return conv
        raise TypeError(f"cannot convert {other} of type {other.type} to {self}")

    def convert_variable(self, var):
        vtype = var.type
        if not isinstance(vtype, TensorType) or vtype.dtype != self.dtype or vtype.ndim != self.ndim:
            return None
        return var if self.is_super(vtype) else None

    def is_super(self, otype) -> bool:
        """Every value of ``otype`` is a valid value of ``self``."""
        return (isinstance(otype, TensorType) and self.dtype == otype.dtype
                and self.ndim == otype.ndim
                and all(s is None or s == o for s, o in zip(self.shape, otype.shape)))

    def __eq__(self, other):
        return type(self) is type(other) and self.dtype == other.dtype and self.shape == other.shape

    def __hash__(self):
        return hash((type(self), self.dtype, self.shape))

    def __str__(self):
        names = {0: "Scalar", 1: "Vector", 2: "Matrix", 3: "Tensor3", 4: "Tensor4"}
        base = names.get(self.ndim, f"Tensor{self.ndim}")
        if any(s is not None for s in self.shape):
            return f"{base}({self.dtype}, shape={self.shape})"
        return f"{base}({self.dtype})"

    def __repr__(self):
        return f"TensorType({self.dtype}, {self.shape})"


def _ctor(ndim):
    def make(name=None, dtype=None, shape=None):
        return TensorType(dtype or config.floatX, shape or (None,) * ndim)(name)

    return make


scalar = _ctor(0)
vector = _ctor(1)
matrix = _ctor(2)
tensor3 = _ctor(3)
tensor4 = _ctor(4)


def row(name=None, dtype=None):
    return TensorType(dtype or config.floatX, (1, None))(name)


def col(name=None, dtype=None):
    return TensorType(dtype or config.floatX, (None, 1))(name)


def _prefixed():
    """The typed constructors of the JAX package (``iscalar``, ``lvector``,
    ``fmatrix``, ...): each is a TensorType, which called with a name
    makes a variable."""
    dtypes = {"b": "int8", "w": "int16", "i": "int32", "l": "int64", "f": "float32", "d": "float64"}
    shapes = {"scalar": (), "vector": (None,), "matrix": (None, None), "tensor3": (None,) * 3,
              "tensor4": (None,) * 4, "row": (1, None), "col": (None, 1)}
    for prefix, dtype in dtypes.items():
        for base, shape in shapes.items():
            globals()[prefix + base] = TensorType(dtype, shape)
            __all__.append(prefix + base)


_prefixed()
