"""The softmax family (reference ``aesara_tpu/tensor/special.py:22-151``):
``Softmax``, ``SoftmaxGrad`` and ``LogSoftmax`` with their gradients.

On the card ``Softmax`` and ``LogSoftmax`` run K4
(``link/torch/kernels/softmax.py``) over the last axis; ``SoftmaxGrad`` is
plain torch ops, as the JAX package lowers it.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import discrete_dtypes
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast


__all__ = ["Softmax", "softmax", "LogSoftmax", "log_softmax", "SoftmaxGrad"]


def _float_input(x):
    from aesara_tpu_torch.config import config

    x = as_tensor_variable(x)
    return cast(x, config.floatX) if x.type.dtype in discrete_dtypes else x


def _axis(axis, ndim):
    """The normalised axis, or None for all axes (a 0-d input has one)."""
    return None if axis is None or ndim == 0 else axis % ndim


class Softmax(Op):
    __props__ = ("axis",)

    def __init__(self, axis=-1):
        self.axis = axis if axis is None else int(axis)

    def make_node(self, x):
        x = _float_input(x)
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        ax = _axis(self.axis, x.ndim)
        z = x - x.max(axis=ax, keepdims=True)
        e = np.exp(z)
        output_storage[0][0] = (e / e.sum(axis=ax, keepdims=True)).astype(x.dtype)

    def L_op(self, inputs, outputs, output_grads):
        return [SoftmaxGrad(self.axis)(output_grads[0], outputs[0])]

    def __str__(self):
        return f"Softmax{{axis={self.axis}}}"


class SoftmaxGrad(Op):
    """The vector-Jacobian product of softmax: sm · (dy − Σ dy·sm)."""

    __props__ = ("axis",)

    def __init__(self, axis=-1):
        self.axis = axis if axis is None else int(axis)

    def make_node(self, dy, sm):
        dy, sm = as_tensor_variable(dy), as_tensor_variable(sm)
        return Apply(self, [dy, sm], [sm.type()])

    def perform(self, node, inputs, output_storage):
        dy, sm = inputs
        inner = (dy * sm).sum(axis=_axis(self.axis, sm.ndim), keepdims=True)
        output_storage[0][0] = (sm * (dy - inner)).astype(sm.dtype)

    def __str__(self):
        return f"SoftmaxGrad{{axis={self.axis}}}"


def softmax(x, axis=-1):
    return Softmax(axis)(x)


class LogSoftmax(Op):
    __props__ = ("axis",)

    def __init__(self, axis=-1):
        self.axis = axis if axis is None else int(axis)

    def make_node(self, x):
        x = _float_input(x)
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        ax = _axis(self.axis, x.ndim)
        z = x - x.max(axis=ax, keepdims=True)
        output_storage[0][0] = (z - np.log(np.exp(z).sum(axis=ax, keepdims=True))).astype(x.dtype)

    def L_op(self, inputs, outputs, output_grads):
        """gz − exp(log_softmax) · Σ gz, the sum over the op's axis."""
        from aesara_tpu_torch.tensor import math as tm

        (gz,) = output_grads
        s = tm.sum(gz, axis=self.axis, keepdims=self.axis is not None)
        return [tm.sub(gz, tm.mul(tm.exp(outputs[0]), s))]

    def __str__(self):
        return f"LogSoftmax{{axis={self.axis}}}"


def log_softmax(x, axis=-1):
    return LogSoftmax(axis)(x)
