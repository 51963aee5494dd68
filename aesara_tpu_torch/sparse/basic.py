"""Sparse ops of the port (reference ``aesara_tpu/sparse/basic.py``), cut
to what a sparse-input model's train step uses: ``DenseFromSparse``,
``StructuredDot`` and its gradient ``StructuredDotGradA``, the dense-output
``Dot``, the sparse gemm ``Usmm`` and ``Transpose``.

Each op keeps its SciPy ``perform``: the tests run it as the oracle.  On
the card the ops lower to the CSR kernels K5-K7
(``link/torch/sparse_dispatch.py``).  ``SparseFromDense`` exists only
because ``Dot``'s gradient with respect to a sparse operand builds it; it
has no lowering, so a function that needs it raises when it is compiled.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from aesara_tpu_torch.graph.ir import Apply, Variable
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import upcast
from aesara_tpu_torch.sparse.type import SparseTensorType
from aesara_tpu_torch.tensor.basic import as_tensor_variable
from aesara_tpu_torch.tensor.type import TensorType
from aesara_tpu_torch.tensor.var import TensorVariable


__all__ = [
    "SparseVariable", "as_sparse_variable", "as_sparse_or_tensor_variable", "matrix",
    "csr_matrix", "DenseFromSparse", "dense_from_sparse", "SparseFromDense",
    "StructuredDot", "structured_dot", "StructuredDotGradA", "Dot", "dot", "Usmm",
    "Transpose", "transpose",
]


class SparseVariable(TensorVariable):
    """A sparse matrix variable: ``.T`` is the sparse ``Transpose``."""

    @property
    def format(self):
        return self.type.format

    @property
    def T(self):
        return transpose(self)


SparseTensorType.variable_type = SparseVariable


def matrix(format, name=None, dtype=None, shape=None):
    from aesara_tpu_torch.config import config

    return SparseTensorType(format, dtype or config.floatX, shape)(name)


def csr_matrix(name=None, dtype=None, shape=None):
    return matrix("csr", name, dtype, shape)


def _is_sparse(v) -> bool:
    return isinstance(getattr(v, "type", None), SparseTensorType)


def as_sparse_variable(x):
    """``x`` if it is a sparse variable; a SciPy value is refused (the port
    has no sparse constants: pass it through ``shared`` or as an input)."""
    if isinstance(x, Variable):
        if not _is_sparse(x):
            raise TypeError(f"{x} is not sparse")
        return x
    raise TypeError(f"{type(x).__name__} is not a sparse variable; sparse constants are not "
                    "ported, use shared() or a function input")


def as_sparse_or_tensor_variable(x):
    return x if _is_sparse(x) else as_tensor_variable(x)


# ---------------------------------------------------------------------------
# dense <-> sparse
# ---------------------------------------------------------------------------

def _pattern(a):
    """(rows, cols) of every stored entry of ``a``, in storage order."""
    major = np.repeat(np.arange(len(a.indptr) - 1), np.diff(a.indptr))
    return (major, a.indices) if a.format == "csr" else (a.indices, major)


class DenseFromSparse(Op):
    """The dense array of a sparse matrix."""

    __props__ = ("structured",)

    def __init__(self, structured: bool = True):
        self.structured = bool(structured)

    def make_node(self, x):
        x = as_sparse_variable(x)
        return Apply(self, [x], [TensorType(x.type.dtype, x.type.shape)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(inputs[0].todense(), dtype=inputs[0].dtype)


def dense_from_sparse(x):
    return DenseFromSparse()(x)


class SparseFromDense(Op):
    """The sparse matrix of a dense array's nonzeros (host only)."""

    __props__ = ("format",)

    def __init__(self, format: str):
        self.format = format

    def make_node(self, x):
        x = as_tensor_variable(x)
        if x.type.ndim != 2:
            raise TypeError("only matrices can become sparse")
        return Apply(self, [x], [SparseTensorType(self.format, x.type.dtype, x.type.shape)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = SparseTensorType.format_cls[self.format](inputs[0])


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

class StructuredDot(Op):
    """sparse @ dense, with the gradient with respect to the sparse operand
    restricted to its stored pattern."""

    __props__ = ()

    def make_node(self, a, b):
        a = as_sparse_variable(a)
        b = as_tensor_variable(b)
        if _is_sparse(b) or b.type.ndim not in (1, 2):
            raise TypeError("structured_dot rhs must be a dense vector or matrix")
        out_shape = (a.type.shape[0],) + ((b.type.shape[1],) if b.type.ndim == 2 else ())
        return Apply(self, [a, b], [TensorType(upcast(a.type.dtype, b.type.dtype), out_shape)()])

    def perform(self, node, inputs, output_storage):
        a, b = inputs
        output_storage[0][0] = np.asarray(a @ b, dtype=node.outputs[0].type.dtype)

    def grad(self, inputs, output_grads):
        a, b = inputs
        (gz,) = output_grads
        return [StructuredDotGradA()(gz, b, a), structured_dot(transpose(a), gz)]


class StructuredDotGradA(Op):
    """(gz @ bᵀ) sampled at the stored pattern of ``a``: the structured
    gradient of ``StructuredDot`` with respect to ``a``."""

    __props__ = ()

    def make_node(self, gz, b, a):
        gz, b, a = as_tensor_variable(gz), as_tensor_variable(b), as_sparse_variable(a)
        if gz.type.ndim != b.type.ndim or gz.type.ndim not in (1, 2):
            raise TypeError(f"gz and b must both be vectors or both matrices, got {gz.type}, {b.type}")
        return Apply(self, [gz, b, a], [a.type()])

    def perform(self, node, inputs, output_storage):
        gz, b, a = inputs
        rows, cols = _pattern(a)
        if np.ndim(b) == 1:
            vals = np.asarray(gz)[rows] * np.asarray(b)[cols]
        else:
            vals = np.einsum("kc,kc->k", np.asarray(gz)[rows], np.asarray(b)[cols])
        res = a.copy().astype(node.outputs[0].type.dtype)
        res.data = vals.astype(res.dtype)
        output_storage[0][0] = res

    def connection_pattern(self, node):
        return [[True], [True], [False]]


_structured_dot = StructuredDot()


def structured_dot(a, b):
    """``a @ b`` with one sparse operand; dense @ sparse is computed as
    (bᵀ @ aᵀ)ᵀ."""
    if _is_sparse(a):
        return _structured_dot(a, b)
    if _is_sparse(b):
        return _structured_dot(transpose(b), as_tensor_variable(a).T).T
    raise TypeError("structured_dot needs a sparse operand")


class Dot(Op):
    """``a @ b`` with a dense result and full (unstructured) gradients."""

    __props__ = ()

    def make_node(self, a, b):
        a, b = as_sparse_or_tensor_variable(a), as_sparse_or_tensor_variable(b)
        if a.type.ndim not in (1, 2) or b.type.ndim not in (1, 2):
            raise TypeError("sparse dot operands must be 1-D or 2-D")
        if a.type.ndim == 1 and b.type.ndim == 1:
            out_shape = ()
        elif a.type.ndim == 1:
            out_shape = (b.type.shape[1],)
        elif b.type.ndim == 1:
            out_shape = (a.type.shape[0],)
        else:
            out_shape = (a.type.shape[0], b.type.shape[1])
        return Apply(self, [a, b], [TensorType(upcast(a.type.dtype, b.type.dtype), out_shape)()])

    def perform(self, node, inputs, output_storage):
        a, b = inputs
        res = a @ b
        if sp.issparse(res):
            res = res.toarray()
        output_storage[0][0] = np.asarray(res, dtype=node.outputs[0].type.dtype)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor import math as tm

        a, b = inputs
        (gz,) = output_grads

        def dense(v):
            return dense_from_sparse(v) if _is_sparse(v) else v

        def outer(u, v):
            return tm.dot(u.dimshuffle(0, "x"), v.dimshuffle("x", 0))

        ga = outer(gz, dense(b)) if b.type.ndim == 1 else tm.dot(gz, dense(b).T)
        gb = outer(dense(a), gz) if a.type.ndim == 1 else tm.dot(dense(a).T, gz)
        if _is_sparse(a):
            ga = SparseFromDense(a.type.format)(ga)
        if _is_sparse(b):
            gb = SparseFromDense(b.type.format)(gb)
        return [ga, gb]


_dense_dot = Dot()


def dot(a, b):
    return _dense_dot(a, b)


class Usmm(Op):
    """alpha · (x @ y) + z for a sparse ``x`` and dense ``y`` and ``z``:
    the sparse gemm that ``local_usmm`` builds.  The reference also takes
    a dense ``x`` with a sparse ``y``; the port's rewrite never builds
    that form, so it is not ported."""

    __props__ = ()

    def make_node(self, alpha, x, y, z):
        alpha, x = as_tensor_variable(alpha), as_sparse_variable(x)
        y, z = as_tensor_variable(y), as_tensor_variable(z)
        if alpha.type.ndim != 0 or _is_sparse(y) or y.type.ndim != 2 or z.type.ndim != 2:
            raise TypeError(f"Usmm takes a scalar alpha, a sparse x and dense matrices y and z, "
                            f"got {alpha.type}, {x.type}, {y.type}, {z.type}")
        dtype = upcast(alpha.type.dtype, x.type.dtype, y.type.dtype, z.type.dtype)
        # the product's static shape, unless z's dim says more (z broadcasts
        # only along a dim that is statically 1)
        xy_shape = (x.type.shape[0], y.type.shape[1])
        out_shape = tuple(p if zs in (1, None) else zs for p, zs in zip(xy_shape, z.type.shape))
        return Apply(self, [alpha, x, y, z], [TensorType(dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        alpha, x, y, z = inputs
        output_storage[0][0] = np.asarray(alpha * (x @ y) + z, dtype=node.outputs[0].type.dtype)

    def grad(self, inputs, output_grads):
        """gemm rules; the gradient with respect to ``x`` keeps x's pattern.
        The reference builds it as ``sampling_dot(agz, y, sp_ones_like(x))``,
        which computes the same values as ``StructuredDotGradA``."""
        from aesara_tpu_torch.tensor import math as tm
        from aesara_tpu_torch.tensor.basic import cast

        alpha, x, y, z = inputs
        (gz,) = output_grads
        g_alpha = tm.sum(tm.mul(gz, structured_dot(x, y)))
        agz = tm.mul(gz, alpha)
        gx = StructuredDotGradA()(agz, y, x)
        gy = structured_dot(transpose(x), agz)
        to_sum = [d for d in range(2) if z.type.shape[d] == 1 and gz.type.shape[d] != 1]
        g_z = tm.sum(gz, axis=to_sum, keepdims=True) if to_sum else gz
        return [cast(g_alpha, alpha.type.dtype), gx, cast(gy, y.type.dtype), cast(g_z, z.type.dtype)]


class Transpose(Op):
    """The transpose of a sparse matrix: CSR becomes CSC and back."""

    __props__ = ()

    fmt_swap = {"csr": "csc", "csc": "csr"}

    def make_node(self, x):
        x = as_sparse_variable(x)
        return Apply(self, [x], [SparseTensorType(self.fmt_swap[x.type.format], x.type.dtype,
                                                  (x.type.shape[1], x.type.shape[0]))()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0].transpose()

    def grad(self, inputs, output_grads):
        return [Transpose()(output_grads[0])]


def transpose(x):
    return Transpose()(x)
