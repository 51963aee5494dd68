"""Integer-array indexing (reference ``aesara_tpu/tensor/subtensor.py:530,594``):
``AdvancedSubtensor`` gathers ``x[i0, i1, ...]`` and
``AdvancedIncSubtensor`` adds (or sets) values there, its gradient.

The port takes the form a negative log-likelihood needs,
``logp[arange(n), y]``: one integer index array for each of the leading
dims of ``x``, broadcast against each other.  Slices, scalars and boolean
masks (the rest of the reference's ``idx_list``) are not ported yet.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import int_dtypes, uint_dtypes
from aesara_tpu_torch.tensor.basic import alloc, as_tensor_variable, cast, constant
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["AdvancedSubtensor", "AdvancedIncSubtensor", "advanced_subtensor"]

ARRAY = "array"


def _index_inputs(x, indices):
    """The index arrays as int64 variables, checked against ``x``."""
    indices = [as_tensor_variable(i) for i in indices]
    if not 0 < len(indices) <= x.type.ndim:
        raise IndexError(f"{len(indices)} index arrays for a {x.type.ndim}-d tensor")
    for i in indices:
        if i.type.dtype not in int_dtypes + uint_dtypes:
            raise TypeError(f"advanced index must be an integer array, got {i.type.dtype} "
                            "(boolean masks are not ported yet)")
    return [cast(i, "int64") for i in indices]


def _broadcast_static(shapes):
    """The broadcast static shape of the index arrays (None: unknown)."""
    ndim = max(len(s) for s in shapes)
    padded = [(1,) * (ndim - len(s)) + tuple(s) for s in shapes]
    out = []
    for dims in zip(*padded):
        known = {d for d in dims if d is not None and d != 1}
        if len(known) > 1:
            raise IndexError(f"index arrays of shapes {shapes} do not broadcast")
        out.append(known.pop() if known else 1 if all(d == 1 for d in dims) else None)
    return tuple(out)


class AdvancedSubtensor(Op):
    """x[i0, ..., ik-1] for k integer index arrays."""

    __props__ = ("idx_list",)

    def __init__(self, idx_list):
        self.idx_list = tuple(idx_list)
        if any(e != ARRAY for e in self.idx_list):
            raise NotImplementedError(f"index list {self.idx_list}: only integer arrays are ported")

    def make_node(self, x, *indices):
        x = as_tensor_variable(x)
        indices = _index_inputs(x, indices)
        if len(indices) != len(self.idx_list):
            raise TypeError(f"{self} takes {len(self.idx_list)} index arrays, got {len(indices)}")
        shape = _broadcast_static([i.type.shape for i in indices]) + x.type.shape[len(indices):]
        return Apply(self, [x] + indices, [TensorType(x.type.dtype, shape)()])

    def perform(self, node, inputs, output_storage):
        x, *indices = inputs
        output_storage[0][0] = np.asarray(x[tuple(indices)])

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type
        from aesara_tpu_torch.tensor.shape import shape_tuple

        x, *indices = inputs
        zeros = alloc(constant(0, dtype=x.type.dtype), *shape_tuple(x))
        gx = AdvancedIncSubtensor(self.idx_list)(zeros, output_grads[0], *indices)
        return [gx] + [disconnected_type() for _ in indices]

    def __str__(self):
        return "AdvancedSubtensor"


class AdvancedIncSubtensor(Op):
    """A copy of ``x`` with ``y`` added at x[i0, ..., ik-1] (duplicates
    accumulate), or written there with ``set_instead_of_inc``."""

    __props__ = ("idx_list", "set_instead_of_inc")

    def __init__(self, idx_list, set_instead_of_inc: bool = False):
        self.idx_list = tuple(idx_list)
        self.set_instead_of_inc = bool(set_instead_of_inc)
        if any(e != ARRAY for e in self.idx_list):
            raise NotImplementedError(f"index list {self.idx_list}: only integer arrays are ported")

    def make_node(self, x, y, *indices):
        x = as_tensor_variable(x)
        y = as_tensor_variable(y)
        if y.type.dtype != x.type.dtype:
            y = cast(y, x.type.dtype)
        indices = _index_inputs(x, indices)
        if len(indices) != len(self.idx_list):
            raise TypeError(f"{self} takes {len(self.idx_list)} index arrays, got {len(indices)}")
        return Apply(self, [x, y] + indices, [x.type()])

    def perform(self, node, inputs, output_storage):
        x, y, *indices = inputs
        out = x.copy()
        if self.set_instead_of_inc:
            out[tuple(indices)] = y
        else:
            np.add.at(out, tuple(indices), y)
        output_storage[0][0] = out

    def connection_pattern(self, node):
        return [[True], [True]] + [[False]] * (len(node.inputs) - 2)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type
        from aesara_tpu_torch.tensor.basic import zeros_like
        from aesara_tpu_torch.tensor.math import sum as tsum

        x, y, *indices = inputs
        (gz,) = output_grads
        gy = AdvancedSubtensor(self.idx_list)(gz, *indices)
        # y was broadcast against the indexed shape: sum those dims out
        extra = gy.type.ndim - y.type.ndim
        if extra:
            gy = tsum(gy, axis=list(range(extra)))
        ones = [d for d in range(y.type.ndim) if y.type.shape[d] == 1 and gy.type.shape[d] != 1]
        if ones:
            gy = tsum(gy, axis=ones, keepdims=True)
        if self.set_instead_of_inc:
            gx = AdvancedIncSubtensor(self.idx_list, True)(gz, zeros_like(gy), *indices)
        else:
            gx = gz
        return [gx, gy] + [disconnected_type() for _ in indices]

    def __str__(self):
        return f"Advanced{'Set' if self.set_instead_of_inc else 'Inc'}Subtensor"


def advanced_subtensor(x, *indices):
    return AdvancedSubtensor((ARRAY,) * len(indices))(x, *indices)
