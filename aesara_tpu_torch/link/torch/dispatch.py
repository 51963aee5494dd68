"""Per-op lowerings: ``torch_funcify(op, node=)`` returns a plain
function on tensors (the counterpart of ``jax_funcify`` in
``aesara_tpu/link/jax/dispatch.py`` and ``nnet_dispatch.py``).

An op with no registration raises ``NotImplementedError`` naming it.
Values the linker keeps on the host (shape arithmetic) reach a lowering
as NumPy values only at the positions listed in its ``host_inputs``
attribute; every other input arrives as a tensor on the linker's device.
"""

from __future__ import annotations

import math
from functools import singledispatch

import numpy as np

from aesara_tpu_torch.scalar.composite import Composite
from aesara_tpu_torch.tensor.basic import MakeVector
from aesara_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise, check_static_broadcast
from aesara_tpu_torch.tensor.math import Dot
from aesara_tpu_torch.tensor.nnet.attention import FusedAttention, FusedAttentionGrad
from aesara_tpu_torch.tensor.shape import Reshape, Shape, Shape_i
from aesara_tpu_torch.link.torch.kernels.attention import flash_attention, flash_attention_grads
from aesara_tpu_torch.link.torch.kernels.elemwise import (
    ElemwiseKernel, apply_scalar_node, fused_elemwise, torch_dtype,
)


__all__ = ["torch_funcify"]


@singledispatch
def torch_funcify(op, node=None):
    raise NotImplementedError(f"no torch lowering for op {op} ({type(op).__name__})")


@torch_funcify.register(Elemwise)
def _torch_elemwise(op, node):
    static_shapes = [tuple(i.type.shape) for i in node.inputs]
    out_dtype = node.outputs[0].type.dtype
    if isinstance(op.scalar_op, Composite):
        # the kernel is generated now, so an op without a Triton form
        # fails when the function is compiled
        kernel = ElemwiseKernel(op.scalar_op, [i.type.dtype for i in node.inputs], out_dtype)

        def composite(*args):
            check_static_broadcast(static_shapes, [a.shape for a in args])
            return fused_elemwise(kernel, *args)

        return composite

    def elemwise(*args):
        check_static_broadcast(static_shapes, [a.shape for a in args])
        return apply_scalar_node(op.scalar_op, out_dtype, args)

    return elemwise


@torch_funcify.register(DimShuffle)
def _torch_dimshuffle(op, node):
    perm = tuple(op.transposition)

    def dimshuffle(x):
        return x.permute(perm).reshape(op.out_shape(x.shape))

    return dimshuffle


@torch_funcify.register(CAReduce)
def _torch_careduce(op, node):
    import torch

    name = str(op.scalar_op)
    if name != "add":
        raise NotImplementedError(f"no torch lowering for CAReduce({name})")
    axes = op._normalized_axes(node.inputs[0].type.ndim)
    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    acc_dtype = torch_dtype(op.acc_dtype) if op.acc_dtype else out_dtype

    def reduce_sum(x):
        x = x.to(acc_dtype)
        return (torch.sum(x, dim=axes) if axes else x).to(out_dtype)

    return reduce_sum


@torch_funcify.register(MakeVector)
def _torch_make_vector(op, node):
    import torch

    dtype = torch_dtype(op.dtype)
    return lambda *args: torch.stack([a.to(dtype) for a in args])


@torch_funcify.register(Shape_i)
def _torch_shape_i(op, node):
    # a host value, so shape arithmetic downstream folds on the host
    i = op.i
    return lambda x: np.asarray(x.shape[i], dtype=np.int64)


@torch_funcify.register(Shape)
def _torch_shape(op, node):
    return lambda x: np.asarray(x.shape, dtype=np.int64)


@torch_funcify.register(Reshape)
def _torch_reshape(op, node):
    def reshape(x, shp):
        return x.reshape(tuple(int(s) for s in np.asarray(shp)))

    reshape.host_inputs = (1,)
    return reshape


@torch_funcify.register(Dot)
def _torch_dot(op, node):
    import torch

    out_dtype = torch_dtype(node.outputs[0].type.dtype)

    def dot(x, y):
        # a plain product, left to the library as the JAX package left it to XLA
        return torch.matmul(x.to(out_dtype), y.to(out_dtype))

    return dot


@torch_funcify.register(FusedAttention)
def _torch_fused_attention(op, node):
    causal = op.causal

    def attention(q, k, v):
        return flash_attention(q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]))

    return attention


@torch_funcify.register(FusedAttentionGrad)
def _torch_fused_attention_grad(op, node):
    causal = op.causal

    def attention_grads(q, k, v, gz):
        return flash_attention_grads(q, k, v, gz, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]))

    return attention_grads
