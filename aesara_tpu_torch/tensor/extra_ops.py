"""``Repeat`` (``numpy.repeat``), the one op of the JAX package's
``aesara_tpu/tensor/extra_ops.py`` a model path of the port runs: the
decoder's grouped-query attention repeats each K/V head for its query
heads (``models/decoder.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from aesara_tpu_torch.graph.ir import Apply, Constant
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["Repeat", "repeat"]


class Repeat(Op):
    """numpy.repeat (reference ``aesara_tpu/tensor/extra_ops.py:141``)."""

    __props__ = ("axis",)

    def __init__(self, axis: Optional[int] = None):
        self.axis = axis if axis is None else int(axis)

    def make_node(self, x, repeats):
        x = as_tensor_variable(x)
        # a scalar constant count keeps the output extent static (n * k);
        # read it before the int64 cast wraps it in an Elemwise
        pre = as_tensor_variable(repeats)
        k = int(pre.data) if isinstance(pre, Constant) and pre.type.ndim == 0 else None
        repeats = cast(pre, "int64")
        if self.axis is None:
            n = x.type.shape[0] if x.type.ndim == 1 else None
            shape = (n * k if (k is not None and n is not None) else None,)
        else:
            shape = list(x.type.shape)
            n = shape[self.axis]
            shape[self.axis] = n * k if (k is not None and n is not None) else None
        return Apply(self, [x, repeats], [TensorType(x.type.dtype, tuple(shape))()])

    def perform(self, node, inputs, output_storage):
        x, repeats = inputs
        output_storage[0][0] = np.repeat(x, repeats, axis=self.axis)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type, grad_not_implemented
        from aesara_tpu_torch.tensor.math import sum as tsum
        from aesara_tpu_torch.tensor.shape import reshape, shape as tshape

        x, repeats = inputs
        (gz,) = output_grads
        if repeats.type.ndim != 0:
            return [grad_not_implemented(self, 0, x, "repeat grad with vector repeats"), disconnected_type()]
        if self.axis is None:
            return [grad_not_implemented(self, 0, x, "repeat grad with axis=None"), disconnected_type()]
        # scalar repeats: gz as (..., n, r, ...), summed over r
        ax = self.axis
        new_shape = [tshape(x)[d] for d in range(x.type.ndim)]
        new_shape.insert(ax + 1, repeats)
        g = reshape(gz, new_shape, ndim=x.type.ndim + 1)
        return [tsum(g, axis=ax + 1), disconnected_type()]

    def __str__(self):
        return f"Repeat{{axis={self.axis}}}"


def repeat(x, repeats, axis=None):
    x = as_tensor_variable(x)
    if axis is None and x.type.ndim != 1:
        x = x.flatten()
    return Repeat(axis if axis is None else int(axis) % max(x.type.ndim, 1))(x, repeats)
