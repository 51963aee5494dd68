"""Sort, argsort and top-k (the counterpart of ``aesara_tpu/tensor/sort.py``:
``SortOp``, ``ArgSortOp``, ``TopKOp`` and their functions).  The port
lowers them to ``torch.sort`` (``link/torch/dispatch.py``), stable on
both devices, so equal values keep the order of their indices, as
``jnp.sort``, ``jnp.argsort`` and ``lax.top_k`` keep them."""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["SortOp", "sort", "ArgSortOp", "argsort", "TopKOp", "topk", "argtopk", "topk_and_argtopk",
           "take_along_axis"]


def take_along_axis(arr, indices, axis=-1):
    """``numpy.take_along_axis`` for int indices of arr's rank (reference
    ``aesara_tpu/tensor/basic.py:1458``)."""
    from aesara_tpu_torch.tensor.basic import arange

    arr = as_tensor_variable(arr)
    indices = as_tensor_variable(indices)
    nd = arr.type.ndim
    ax = axis % nd
    index = []
    for d in range(nd):
        if d == ax:
            index.append(indices)
        else:
            shp = ["x"] * nd
            shp[d] = 0
            index.append(arange(0, indices.shape[d]).dimshuffle(*shp))
    return arr[tuple(index)]


class SortOp(Op):
    """(reference ``aesara_tpu/tensor/sort.py:20``)"""

    __props__ = ("kind", "order")

    def __init__(self, kind="quicksort", order=None):
        self.kind = kind
        self.order = order

    def make_node(self, x, axis):
        x = as_tensor_variable(x)
        axis = cast(as_tensor_variable(axis), "int64")
        return Apply(self, [x, axis], [x.type()])

    def perform(self, node, inputs, output_storage):
        x, axis = inputs
        output_storage[0][0] = np.sort(x, int(axis), self.kind, self.order)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def grad(self, inputs, output_grads):
        # the gradient goes back through the inverse permutation
        from aesara_tpu_torch.gradient import disconnected_type, grad_not_implemented
        from aesara_tpu_torch.tensor.basic import NotScalarConstantError, get_scalar_constant_value, zeros_like
        from aesara_tpu_torch.tensor.subtensor import AdvancedIncSubtensor1

        x, axis = inputs
        (gz,) = output_grads
        idx = ArgSortOp(self.kind, self.order)(x, axis)
        if x.type.ndim == 1:
            return [AdvancedIncSubtensor1()(zeros_like(x), gz, idx), disconnected_type()]
        # ndim > 1: argsort(argsort(x)) ranks each element, i.e. where its
        # cotangent landed in the sorted output
        try:
            static_axis = int(get_scalar_constant_value(axis))
        except NotScalarConstantError:
            return [grad_not_implemented(self, 0, x, "sort grad needs a constant axis"), disconnected_type()]
        ranks = ArgSortOp(self.kind, self.order)(idx, axis)
        return [take_along_axis(gz, ranks, axis=static_axis), disconnected_type()]


def sort(x, axis=-1, kind="quicksort", order=None):
    if axis is None:
        x = as_tensor_variable(x).flatten()
        axis = 0
    return SortOp(kind, order)(x, axis)


class ArgSortOp(Op):
    """(reference ``aesara_tpu/tensor/sort.py:94``)"""

    __props__ = ("kind", "order")

    def __init__(self, kind="quicksort", order=None):
        self.kind = kind
        self.order = order

    def make_node(self, x, axis):
        x = as_tensor_variable(x)
        axis = cast(as_tensor_variable(axis), "int64")
        return Apply(self, [x, axis], [TensorType("int64", x.type.shape)()])

    def perform(self, node, inputs, output_storage):
        x, axis = inputs
        output_storage[0][0] = np.argsort(x, int(axis), self.kind, self.order).astype(np.int64)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type, grad_undefined

        return [grad_undefined(self, 0, inputs[0]), disconnected_type()]


def argsort(x, axis=-1, kind="quicksort", order=None):
    if axis is None:
        x = as_tensor_variable(x).flatten()
        axis = 0
    return ArgSortOp(kind, order)(x, axis)


class TopKOp(Op):
    """The top-k values and/or indices along one axis (reference
    ``aesara_tpu/tensor/sort.py:125``); a negative k gives the bottom |k|."""

    __props__ = ("axis", "sorted", "return_values", "return_indices", "idx_dtype")

    def __init__(self, axis=-1, sorted=True, return_values=True, return_indices=True, idx_dtype="int64"):
        self.axis = int(axis)
        self.sorted = bool(sorted)
        self.return_values = bool(return_values)
        self.return_indices = bool(return_indices)
        self.idx_dtype = idx_dtype
        if not (return_values or return_indices):
            raise ValueError("need values and/or indices")

    def make_node(self, x, k):
        from aesara_tpu_torch.tensor.basic import NotScalarConstantError, get_scalar_constant_value

        x = as_tensor_variable(x)
        k = cast(as_tensor_variable(k), "int64")
        ax = self.axis % x.type.ndim
        shape = list(x.type.shape)
        try:
            k_static = int(get_scalar_constant_value(k))
            if k_static == 0:
                raise ValueError("topk: k must be nonzero")
            shape[ax] = abs(k_static)
        except NotScalarConstantError:
            shape[ax] = None
        outs = []
        if self.return_values:
            outs.append(TensorType(x.type.dtype, tuple(shape))())
        if self.return_indices:
            outs.append(TensorType(self.idx_dtype, tuple(shape))())
        return Apply(self, [x, k], outs)

    def perform(self, node, inputs, output_storage):
        x, k = inputs
        k = int(k)
        if k == 0:
            raise ValueError("topk: k must be nonzero")
        ax = self.axis % x.ndim
        kk = abs(k)
        # a reversing key for every dtype: bitwise not for bools and ints
        # (negation wraps for unsigned), negation for floats
        rev = np.invert(x) if x.dtype.kind in "bui" else -x
        key = rev if k > 0 else x
        idx = np.argpartition(key, min(kk, x.shape[ax]) - 1, axis=ax)
        sl = [slice(None)] * x.ndim
        sl[ax] = slice(0, kk)
        idx = idx[tuple(sl)]
        if self.sorted:
            kvals = np.take_along_axis(key, idx, axis=ax)
            order = np.argsort(kvals, axis=ax, kind="stable")
            idx = np.take_along_axis(idx, order, axis=ax)
        vals = np.take_along_axis(x, idx, axis=ax)
        pos = 0
        if self.return_values:
            output_storage[pos][0] = vals
            pos += 1
        if self.return_indices:
            output_storage[pos][0] = idx.astype(self.idx_dtype)

    def L_op(self, inputs, outputs, output_grads):
        from aesara_tpu_torch.gradient import DisconnectedType, disconnected_type, grad_undefined
        from aesara_tpu_torch.tensor.basic import arange, zeros_like
        from aesara_tpu_torch.tensor.subtensor import inc_subtensor

        x, k = inputs
        # the values' gradient scatters back to the positions they came from
        idx = outputs[-1] if self.return_indices else TopKOp(self.axis, self.sorted, False, True,
                                                              self.idx_dtype)(x, k)
        gz = output_grads[0]
        if not self.return_values or isinstance(gz.type, DisconnectedType):
            return [grad_undefined(self, 0, x), disconnected_type()]
        nd = x.type.ndim
        ax = self.axis % nd
        index = []
        for d in range(nd):
            if d == ax:
                index.append(idx)
            else:
                order = ["x"] * nd
                order[d] = 0
                index.append(arange(0, idx.shape[d]).dimshuffle(*order))
        gx = inc_subtensor(zeros_like(x)[tuple(index)], gz)
        return [gx, disconnected_type()]


def topk(x, kth, axis=-1, sorted=True, idx_dtype="int64"):
    return TopKOp(axis, sorted, True, False, idx_dtype)(x, kth)


def argtopk(x, kth, axis=-1, sorted=True, idx_dtype="int64"):
    return TopKOp(axis, sorted, False, True, idx_dtype)(x, kth)


def topk_and_argtopk(x, kth, axis=-1, sorted=True, idx_dtype="int64"):
    return TopKOp(axis, sorted, True, True, idx_dtype)(x, kth)
