"""Sparse rewrites (reference ``aesara_tpu/sparse/rewriting.py``): the ones
that put a sparse-input model's graph on the CSR kernels.

- ``local_dot_to_structured_dot`` (specialize): ``sparse.Dot`` with one
  sparse operand → ``StructuredDot``.
- ``local_dense_dot_of_dense_from_sparse`` (specialize): a dense ``Dot``
  of ``DenseFromSparse(x)`` → ``StructuredDot``.  Unlike the reference
  (``:147``), it also matches the transposed operand
  ``DimShuffle{1,0}(DenseFromSparse(x))`` and rewrites it to
  ``StructuredDot(Transpose(x), ·)``: that is the form ``Dot``'s gradient
  takes for the weights of ``x @ W``, and without the match the gradient
  turns x into a dense matrix (the reference's graph does, ``ROADMAP.md``
  Queue 3).
- ``local_usmm`` (specialize): ``z + [alpha ·] sparse_dot(x, y)`` →
  ``Usmm(alpha, x, y, z)``.
- ``local_sparse_transpose_transpose`` (canonicalize and specialize, since
  the specialize rewrites above build transposes): ``Transpose(Transpose(x))``
  → x.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import register_canonicalize, register_specialize
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.sparse.basic import (
    DenseFromSparse, Dot, StructuredDot, Transpose, Usmm, structured_dot, transpose,
)
from aesara_tpu_torch.sparse.type import SparseTensorType
from aesara_tpu_torch.tensor.basic import constant
from aesara_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
from aesara_tpu_torch.tensor.math import Dot as TensorDot


def _is_sparse(v) -> bool:
    return isinstance(v.type, SparseTensorType)


def _keep(out, res):
    """``res`` as ``out``'s type, or False when it cannot be."""
    conv = out.type.convert_variable(res)
    if conv is None:
        return False
    return [copy_stack_trace(out, conv)]


@node_rewriter([Dot])
def local_dot_to_structured_dot(fgraph, node):
    """sparse.Dot(sparse, dense) or (dense, sparse) → StructuredDot"""
    a, b = node.inputs
    if _is_sparse(a) == _is_sparse(b) or (b.type.ndim not in (1, 2)):
        return False
    return _keep(node.outputs[0], structured_dot(a, b))


def _sparse_behind(v):
    """x when ``v`` is DenseFromSparse(x); Transpose(x) when it is
    DimShuffle{1,0}(DenseFromSparse(x)); else None."""
    node = v.owner
    if node is None:
        return None
    if isinstance(node.op, DenseFromSparse):
        return node.inputs[0]
    if isinstance(node.op, DimShuffle) and node.op.new_order == (1, 0):
        inner = node.inputs[0].owner
        if inner is not None and isinstance(inner.op, DenseFromSparse):
            return transpose(inner.inputs[0])
    return None


@node_rewriter([TensorDot])
def local_dense_dot_of_dense_from_sparse(fgraph, node):
    """dot(DenseFromSparse(x), y) → StructuredDot(x, y), also through a
    transpose of the dense operand: a sparse x is multiplied as it is."""
    a, b = node.inputs
    sa, sb = _sparse_behind(a), _sparse_behind(b)
    if sa is None and sb is None:
        return False
    if sa is not None:
        # keep the other side dense: StructuredDot takes a dense rhs
        return _keep(node.outputs[0], structured_dot(sa, b))
    return _keep(node.outputs[0], structured_dot(a, sb))


@node_rewriter([Elemwise])
def local_usmm(fgraph, node):
    """add(z, [alpha *] sparse_dot(x, y)) → Usmm(alpha, x, y, z) for a
    sparse x and dense matrices y and z."""
    if not isinstance(node.op.scalar_op, aes.Add) or len(node.inputs) != 2:
        return False

    def single_client(v):
        return len(fgraph.clients.get(v, [])) == 1

    def sparse_dot(v):
        n = v.owner
        ok = (n is not None and single_client(v) and isinstance(n.op, (Dot, StructuredDot))
              and _is_sparse(n.inputs[0]) and not _is_sparse(n.inputs[1])
              and n.inputs[1].type.ndim == 2)
        return n.inputs if ok else None

    def decompose(v):
        """(alpha or None, x, y) when ``v`` is [alpha *] sparse_dot(x, y)."""
        found = sparse_dot(v)
        if found is not None:
            return (None, *found)
        n = v.owner
        if (n is None or not single_client(v) or not isinstance(n.op, Elemwise)
                or not isinstance(n.op.scalar_op, aes.Mul) or len(n.inputs) != 2):
            return None
        for alpha, dot_var in (n.inputs, n.inputs[::-1]):
            found = sparse_dot(dot_var)
            if found is not None and all(s == 1 for s in alpha.type.shape):
                return (alpha, *found)
        return None

    for i, j in ((0, 1), (1, 0)):
        dec = decompose(node.inputs[i])
        z = node.inputs[j]
        if dec is None or _is_sparse(z) or z.type.ndim != 2:
            continue
        alpha, x, y = dec
        if alpha is None:
            alpha = constant(np.asarray(1, dtype=node.outputs[0].type.dtype))
        elif alpha.type.ndim:
            alpha = alpha.dimshuffle(())
        res = _keep(node.outputs[0], Usmm()(alpha, x, y, z))
        if res:
            return res
    return False


@node_rewriter([Transpose])
def local_sparse_transpose_transpose(fgraph, node):
    """Transpose(Transpose(x)) → x"""
    inner = node.inputs[0].owner
    if inner is not None and isinstance(inner.op, Transpose):
        return _keep(node.outputs[0], inner.inputs[0])
    return False


for _rw in (local_dot_to_structured_dot, local_dense_dot_of_dense_from_sparse, local_usmm,
            local_sparse_transpose_transpose):
    register_specialize(_rw)
register_canonicalize(local_sparse_transpose_transpose)
