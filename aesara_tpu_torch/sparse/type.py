"""``SparseTensorType``: a CSR or CSC matrix of one dtype (reference
``aesara_tpu/sparse/type.py:13``).

Values on the host are SciPy sparse matrices.  On the device the linker
holds every sparse value as a :class:`~aesara_tpu_torch.link.torch.csr.CSRMat`,
the CSR form of the logical matrix, whatever the format: a CSC matrix of
shape (m, n) is the same storage as the CSR of its (n, m) transpose.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from aesara_tpu_torch.scalar.ops import upcast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["SparseTensorType"]


class SparseTensorType(TensorType):
    """dtype + format ('csr' or 'csc') + a 2-d static shape."""

    format_cls = {"csr": sp.csr_matrix, "csc": sp.csc_matrix}

    def __init__(self, format: str, dtype: str, shape=None):
        if format not in self.format_cls:
            raise ValueError(f"unsupported sparse format {format!r}")
        self.format = format
        super().__init__(dtype, shape if shape is not None else (None, None))
        if self.ndim != 2:
            raise TypeError("sparse tensors are 2-d")

    def clone(self, dtype=None, shape=None, **kwargs):
        return type(self)(self.format, dtype or self.dtype, self.shape if shape is None else shape)

    def filter(self, data, strict=False, allow_downcast=None):
        """A SciPy matrix in this type's format and dtype; a dense array
        is converted, a cast that loses precision raises."""
        if strict:
            if not sp.issparse(data) or data.format != self.format:
                raise TypeError(f"{self} (strict) needs a {self.format} matrix")
            if data.dtype != np.dtype(self.dtype):
                raise TypeError(f"{self} (strict) got dtype {data.dtype}")
            return data
        if sp.issparse(data):
            converted = data.asformat(self.format)
        else:
            converted = self.format_cls[self.format](np.asarray(data))
        if converted.dtype != np.dtype(self.dtype):
            if not allow_downcast and upcast(self.dtype, converted.dtype.name) != self.dtype:
                raise TypeError(f"{self}: expected {self.dtype}, got {converted.dtype} "
                                "(pass allow_downcast to cast)")
            converted = converted.astype(self.dtype)
        self.check_shape(converted.shape)
        return converted

    def is_super(self, otype):
        return (isinstance(otype, SparseTensorType) and otype.format == self.format
                and super().is_super(otype))

    def convert_variable(self, var):
        return var if self.is_super(var.type) else None

    def filter_variable(self, other, allow_convert: bool = True):
        from aesara_tpu_torch.graph.ir import Variable

        if not isinstance(other, Variable):
            raise TypeError(f"{self} takes a sparse variable, got {type(other).__name__}")
        if other.type == self or (allow_convert and self.is_super(other.type)):
            return other
        raise TypeError(f"cannot convert {other} of type {other.type} to {self}")

    def __eq__(self, other):
        return (type(other) is SparseTensorType and other.format == self.format
                and other.dtype == self.dtype and other.shape == self.shape)

    def __hash__(self):
        return hash((SparseTensorType, self.format, self.dtype, self.shape))

    def __str__(self):
        return f"Sparse[{self.dtype}, {self.format}]"

    def __repr__(self):
        return f"SparseTensorType({self.format}, {self.dtype}, {self.shape})"
