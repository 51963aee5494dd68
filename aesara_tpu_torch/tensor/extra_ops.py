"""The ops of the JAX package's ``aesara_tpu/tensor/extra_ops.py`` a model
path of the port runs: ``Repeat`` (``numpy.repeat``; the decoder's
grouped-query attention repeats each K/V head for its query heads),
``CumOp`` (cumsum and cumprod; speculative decoding's accepted prefix)
and ``BroadcastTo`` (``broadcast_to``, ``broadcast_arrays``; beam
search's per-beam caches), all in ``models/decoder.py``, and ``Unique``
(``numpy.unique``; ``tensor/nnet/basic.py``'s ``confusion_matrix``), whose
result's length the data decides, so a function that holds one runs
eagerly.  The JAX package's XLA linker refuses ``Unique``; only its PY
linker runs it."""

from __future__ import annotations

from typing import Optional

import numpy as np

from aesara_tpu_torch.graph.ir import Apply, Constant
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["CumOp", "CumsumOp", "CumprodOp", "cumsum", "cumprod", "Repeat", "repeat", "BroadcastTo",
           "broadcast_to", "broadcast_arrays", "Unique", "unique"]


class CumOp(Op):
    """cumsum/cumprod (reference ``aesara_tpu/tensor/extra_ops.py:29``)."""

    __props__ = ("axis", "mode")

    def __init__(self, axis: Optional[int] = None, mode: str = "add"):
        if mode not in ("add", "mul"):
            raise ValueError("mode must be add or mul")
        self.axis = axis if axis is None else int(axis)
        self.mode = mode

    def make_node(self, x):
        x = as_tensor_variable(x)
        # a 0-d input admits no explicit axis
        if self.axis is not None and not (-x.type.ndim <= self.axis < x.type.ndim):
            raise ValueError(f"cum{self.mode}: axis {self.axis} out of range for {x.type.ndim}-d input")
        if self.axis is None:
            known = all(s is not None for s in x.type.shape)
            shape = (int(np.prod(x.type.shape)) if known and x.type.ndim else None,)
            if x.type.ndim == 0:
                shape = (1,)
            out_t = TensorType(x.type.dtype, shape)
        else:
            out_t = x.type
        return Apply(self, [x], [out_t()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        fn = np.cumsum if self.mode == "add" else np.cumprod
        output_storage[0][0] = fn(x, axis=self.axis).astype(x.dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.basic import constant

        (xs,) = input_shapes
        if self.axis is None:
            if len(xs) == 0:
                return [(constant(1, dtype="int64"),)]
            total = xs[0]
            for s in xs[1:]:
                total = total * s
            return [(total,)]
        return [xs]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.shape import reshape, shape as tshape

        (x,) = inputs
        (gz,) = output_grads
        axis = self.axis
        if self.mode == "add":
            if axis is None:
                return [reshape(cumsum(gz[::-1])[::-1], tshape(x), ndim=x.type.ndim)]
            rev = [slice(None)] * x.type.ndim
            rev[axis] = slice(None, None, -1)
            rev = tuple(rev)
            return [cumsum(gz[rev], axis=axis)[rev]]
        # cumprod: flip(cumsum(flip(gz * cumprod(x)))) / x, for x != 0 (the
        # zero-input case is undefined in the reference too)
        prod_out = cumprod(x, axis=axis)
        if axis is None:
            flat = gz.reshape((-1,)) * prod_out
            g = cumsum(flat[::-1])[::-1] / x.reshape((-1,))
            return [reshape(g, tshape(x), ndim=x.type.ndim)]
        rev = [slice(None)] * x.type.ndim
        rev[axis] = slice(None, None, -1)
        rev = tuple(rev)
        return [cumsum((gz * prod_out)[rev], axis=axis)[rev] / x]

    def __str__(self):
        name = "CumSum" if self.mode == "add" else "CumProd"
        return f"{name}{{axis={self.axis}}}"


class CumsumOp(Op):
    """The reference's constructor: ``CumsumOp(axis)`` is ``CumOp(axis, "add")``."""

    def __new__(cls, axis=None):
        return CumOp(axis, "add")


class CumprodOp(Op):
    """The reference's constructor: ``CumprodOp(axis)`` is ``CumOp(axis, "mul")``."""

    def __new__(cls, axis=None):
        return CumOp(axis, "mul")


def cumsum(x, axis=None):
    return CumOp(axis, "add")(x)


def cumprod(x, axis=None):
    return CumOp(axis, "mul")(x)


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


class BroadcastTo(Op):
    """``numpy.broadcast_to`` (reference ``aesara_tpu/tensor/extra_ops.py:455``):
    its result is a view of ``x``."""

    __props__ = ()
    view_map = {0: [0]}

    def make_node(self, x, *shape):
        from aesara_tpu_torch.tensor.basic import _normalize_shape_args

        x = as_tensor_variable(x)
        shape_vars, static = _normalize_shape_args(shape)
        return Apply(self, [x] + shape_vars, [TensorType(x.type.dtype, static)()])

    def perform(self, node, inputs, output_storage):
        x, *shape = inputs
        output_storage[0][0] = np.broadcast_to(x, tuple(int(s) for s in shape))

    def infer_shape(self, fgraph, node, input_shapes):
        return [tuple(node.inputs[1:])]

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type
        from aesara_tpu_torch.tensor.math import sum as tsum
        from aesara_tpu_torch.tensor.shape import specify_shape

        x, *shape = inputs
        (gz,) = output_grads
        n_extra = gz.type.ndim - x.type.ndim
        g = tsum(gz, axis=list(range(n_extra))) if n_extra else gz
        to_sum = [d for d in range(x.type.ndim) if x.type.shape[d] == 1]
        if to_sum:
            g = tsum(g, axis=to_sum, keepdims=True)
        if g.type.shape != x.type.shape:
            g = specify_shape(g, x.type.shape)
        return [g] + [disconnected_type() for _ in shape]


def broadcast_to(x, shape):
    if not isinstance(shape, (list, tuple)):
        shape = (shape,)
    return BroadcastTo()(x, *shape)


def broadcast_arrays(*args):
    """Each argument broadcast against all the others (by ``fill``, as the
    reference builds it)."""
    from aesara_tpu_torch.tensor.basic import fill

    args = [as_tensor_variable(a) for a in args]
    out = []
    for a in args:
        t = a
        for b in args:
            if b is not a:
                t = fill(b, t)
        out.append(t)
    return out


class Unique(Op):
    """``numpy.unique`` (reference ``aesara_tpu/tensor/extra_ops.py:207``):
    the sorted distinct values, and with the flags the index of each one's
    first occurrence, the inverse (flattened) and the counts."""

    __props__ = ("return_index", "return_inverse", "return_counts", "axis")

    def __init__(self, return_index=False, return_inverse=False, return_counts=False, axis=None):
        self.return_index = bool(return_index)
        self.return_inverse = bool(return_inverse)
        self.return_counts = bool(return_counts)
        self.axis = axis if axis is None else int(axis)

    def make_node(self, x):
        x = as_tensor_variable(x)
        out_ndim = 1 if self.axis is None else x.type.ndim
        outs = [TensorType(x.type.dtype, (None,) * out_ndim)()]
        outs += [TensorType("int64", (None,))() for flag in (self.return_index, self.return_inverse,
                                                              self.return_counts) if flag]
        return Apply(self, [x], outs)

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        res = np.unique(x, return_index=self.return_index, return_inverse=self.return_inverse,
                        return_counts=self.return_counts, axis=self.axis)
        if not isinstance(res, tuple):
            res = (res,)
        for storage, r, out in zip(output_storage, res, node.outputs):
            storage[0] = np.asarray(r).reshape(-1) if out.type.ndim == 1 else np.asarray(r)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, 0, inputs[0])]


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None):
    return Unique(return_index, return_inverse, return_counts, axis)(x)
