"""``TensorType``: dtype plus static shape (None for an unknown dim), and
the variable constructors (reference ``aesara_tpu/tensor/type.py``).

A dimension broadcasts only if its static shape is 1.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Type, Variable
from aesara_tpu_torch.scalar.ops import _np_dtype, all_dtypes, discrete_dtypes, is_torch_tensor, to_host


__all__ = ["TensorType", "values_eq_approx", "scalar", "vector", "matrix", "tensor3", "tensor4", "row", "col"]


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
        """Admit a NumPy value, or a torch tensor of this dtype, and return
        its host form (``scalar.ops.to_host``); float64 arrays do not
        silently become float32, Python float literals may.  Admission
        depends on the given dtype alone.  NumPy has no bfloat16, so a
        bfloat16 type admits what the JAX package admits into ml_dtypes'
        bfloat16: a torch.bfloat16 tensor (the port's user form of one), an
        ml_dtypes bfloat16 array, bool, int8 and uint8, a float literal, or
        anything with ``allow_downcast``; a float32 array only with
        ``allow_downcast``."""
        if isinstance(data, Variable):
            raise TypeError("cannot use a Variable as a Type value")
        if is_torch_tensor(data):
            if str(data.dtype).split(".")[-1] != self.dtype:
                raise TypeError(f"{self} got a torch tensor of dtype {data.dtype}")
            self.check_shape(tuple(data.shape))
            return to_host(data, self.dtype)
        np_dtype = _np_dtype(self.dtype)
        was_literal = not isinstance(data, np.ndarray)
        arr = np.asarray(data)
        if self.dtype == "bfloat16":
            ok = arr.dtype.name == "bfloat16" or not strict and (
                allow_downcast or arr.dtype.name in ("bool", "int8", "uint8") or (
                    was_literal and arr.dtype.kind == "f"))
            if not ok:
                raise TypeError(f"cannot convert dtype {arr.dtype} to bfloat16 without risking precision "
                                "loss (pass a torch.bfloat16 tensor, or allow_downcast)")
            arr = to_host(arr, "bfloat16")
        elif arr.dtype != np_dtype:
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

    def values_eq_approx(self, a, b, allow_remove_inf=False, allow_remove_nan=False, rtol=None, atol=None) -> bool:
        return values_eq_approx(a, b, allow_remove_inf, allow_remove_nan, rtol, atol)

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


def values_eq_approx(a, b, allow_remove_inf=False, allow_remove_nan=False, rtol=None, atol=None) -> bool:
    """Approximate equality of two values of one dtype, NaN and inf
    matching NaN and inf (reference ``aesara_tpu/tensor/type.py:256``):
    rtol 1e-5 and atol 1e-8 in float32, 1e-8 both in float64, and 1e-2 and
    1e-3 in bfloat16 and float16.  Torch tensors (a bfloat16 value's form)
    are compared by their values."""
    dtypes = [str(v.dtype).split(".")[-1] for v in (a, b)]
    a, b = (to_host(v, d) for v, d in zip((a, b), dtypes))
    if a.shape != b.shape or dtypes[0] != dtypes[1]:
        return False
    if dtypes[0] in discrete_dtypes:
        return bool(np.array_equal(a, b))
    low = dtypes[0] in ("float16", "bfloat16")
    if rtol is None:
        rtol = 1e-2 if low else 1e-5 if dtypes[0] == "float32" else 1e-8
    if atol is None:
        atol = 1e-3 if low else 1e-8
    af, bf = a.astype(np.float64), b.astype(np.float64)
    mask = np.zeros(a.shape, dtype=bool)
    if allow_remove_inf:
        mask |= np.isinf(af)
    if allow_remove_nan:
        mask |= np.isnan(af)
    both_nan = np.isnan(af) & np.isnan(bf)
    both_inf = np.isinf(af) & np.isinf(bf) & (np.sign(af) == np.sign(bf))
    return bool(np.all(np.isclose(af, bf, rtol=rtol, atol=atol) | both_nan | both_inf | mask))


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
