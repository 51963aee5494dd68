"""Lowerings of the sparse ops and the plan of the linker's sparse bridge
(the counterpart of ``aesara_tpu/link/jax/sparse_dispatch.py``).

Every sparse value of a compiled graph is a
:class:`~aesara_tpu_torch.link.torch.csr.CSRMat` on the device:

- ``StructuredDot`` runs K5 or K6 (``csr_matmul``), ``Usmm`` runs the same
  product scaled by alpha plus z, ``Transpose`` hands over the transposed
  twin, ``StructuredDotGradA`` runs K7 and returns x's pattern with the new
  values, and ``DenseFromSparse`` scatters the values into a dense tensor
  (plain torch ops: it has a lowering, but the rewritten graphs of the
  port's models do not contain it).

:func:`csr_plan` is the cone walk of ``bss_inputs`` (``:163-239``) cut to
its one remaining job, deciding which graph inputs need the transposed
twin; and it refuses, when the function is compiled, a graph in which a
sparse value meets an op that has no lowering for it.  Every sparse
input takes this one bridge: there is no other device form and no size
gate.
"""

from __future__ import annotations

from aesara_tpu_torch.graph.fg import OUTPUT
from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.link.torch.dispatch import torch_funcify
from aesara_tpu_torch.link.torch.kernels.elemwise import torch_dtype
from aesara_tpu_torch.link.torch.kernels.sparse import csr_matmul, csr_sddmm, row_ids
from aesara_tpu_torch.sparse import basic as sb
from aesara_tpu_torch.sparse.type import SparseTensorType
from aesara_tpu_torch.tensor.shape import Shape, Shape_i


__all__ = ["csr_plan"]

# (op type, the operand positions at which it takes a sparse value)
_SPARSE_SLOTS = (
    (sb.StructuredDot, (0,)),
    (sb.Usmm, (1,)),
    (sb.StructuredDotGradA, (2,)),
    (sb.Transpose, (0,)),
    (sb.DenseFromSparse, (0,)),
    (Shape, (0,)),
    (Shape_i, (0,)),
)


def _is_sparse(var) -> bool:
    return isinstance(var.type, SparseTensorType)


def _transposed_input(var):
    """The graph input that ``var`` is a chain of Transposes of, or None."""
    while var.owner is not None and isinstance(var.owner.op, sb.Transpose):
        var = var.owner.inputs[0]
    return var if var.owner is None else None


def csr_plan(fgraph) -> list:
    """Per graph input: None for a dense input, else ``{"transpose": bool}``,
    whether the bridge must build the CSR of its transpose too.

    Raises ``NotImplementedError`` naming the op when a sparse value is an
    operand that no lowering takes: only the ops of ``_SPARSE_SLOTS``, at
    those positions, and graph outputs (which go back to SciPy) may read
    one.  A ``Transpose`` must read a graph input, through Transposes only:
    the twin exists for inputs alone."""
    transposed = set()
    for var in list(fgraph.variables):
        if not _is_sparse(var):
            continue
        for node, idx in fgraph.clients.get(var, ()):
            if node == OUTPUT:
                continue
            slots = next((s for cls, s in _SPARSE_SLOTS if isinstance(node.op, cls)), ())
            if idx not in slots:
                raise NotImplementedError(f"no torch lowering for {node.op} "
                                          f"({type(node.op).__name__}) with a sparse operand {idx}")
            if isinstance(node.op, sb.Transpose):
                src = _transposed_input(var)
                if src is None or isinstance(src, Constant):
                    raise NotImplementedError(f"no torch lowering for Transpose of the computed "
                                              f"sparse value {var}: only graph inputs have a twin")
                transposed.add(src)
    return [{"transpose": inp in transposed} if _is_sparse(inp) else None for inp in fgraph.inputs]


@torch_funcify.register(sb.StructuredDot)
def _torch_structured_dot(op, node):
    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    return lambda a, b: csr_matmul(a, b, out_dtype)


def _is_one(var) -> bool:
    import numpy as np

    return isinstance(var, Constant) and np.asarray(var.data).size == 1 and float(var.data) == 1.0


@torch_funcify.register(sb.Usmm)
def _torch_usmm(op, node):
    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    unit = _is_one(node.inputs[0])

    def usmm(alpha, x, y, z):
        prod = csr_matmul(x, y, out_dtype)
        return (prod if unit else alpha.to(out_dtype) * prod) + z.to(out_dtype)

    return usmm


@torch_funcify.register(sb.Transpose)
def _torch_sparse_transpose(op, node):
    return lambda x: x.transpose()


@torch_funcify.register(sb.StructuredDotGradA)
def _torch_structured_dot_grad_a(op, node):
    return lambda gz, b, a: csr_sddmm(a, gz, b)


@torch_funcify.register(sb.DenseFromSparse)
def _torch_dense_from_sparse(op, node):
    import torch

    def dense_from_sparse(x):
        out = torch.zeros(x.shape, dtype=x.data.dtype, device=x.data.device)
        return out.index_put_((row_ids(x), x.indices.long()), x.data, accumulate=True)

    return dense_from_sparse
