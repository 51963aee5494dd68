"""Shape ops: ``Shape``, ``Shape_i``, ``Reshape``, ``SpecifyShape`` and
``Unbroadcast`` (reference ``aesara_tpu/tensor/shape.py``).  A shape is an integer, so its
gradient is disconnected; ``Reshape``'s gradient reshapes back to
``shape(x)``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["Shape", "shape", "Shape_i", "shape_i", "shape_tuple", "Reshape", "reshape",
           "shape_padleft", "shape_padright", "SpecifyShape", "specify_shape", "Unbroadcast", "unbroadcast"]


def _disconnected_grads(inputs):
    from aesara_tpu_torch.gradient import disconnected_type

    return [disconnected_type() for _ in inputs]


class Shape(Op):
    """The runtime shape, as an int64 vector."""

    __props__ = ()

    def make_node(self, x):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        return Apply(self, [x], [TensorType("int64", (x.type.ndim,))()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(np.shape(inputs[0]), dtype=np.int64)

    def connection_pattern(self, node):
        return [[False]]

    def grad(self, inputs, output_grads):
        return _disconnected_grads(inputs)


def shape(x):
    return Shape()(x)


class Shape_i(Op):
    """One dimension of a runtime shape, as a 0-d int64."""

    __props__ = ("i",)

    def __init__(self, i: int):
        self.i = int(i)

    def make_node(self, x):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        if not 0 <= self.i < x.type.ndim:
            raise ValueError(f"axis {self.i} out of range for {x.type}")
        return Apply(self, [x], [TensorType("int64", ())()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(np.shape(inputs[0])[self.i], dtype=np.int64)

    def connection_pattern(self, node):
        return [[False]]

    def grad(self, inputs, output_grads):
        return _disconnected_grads(inputs)

    def __str__(self):
        return f"Shape_i{{{self.i}}}"


def shape_i(x, i: int):
    """A constant when the static shape knows dim ``i``, else Shape_i."""
    from aesara_tpu_torch.tensor.basic import as_tensor_variable, constant

    x = as_tensor_variable(x)
    s = x.type.shape[i]
    return constant(s, dtype="int64") if s is not None else Shape_i(i)(x)


def shape_tuple(x) -> tuple:
    """Per-dim symbolic sizes (static dims as constants)."""
    from aesara_tpu_torch.tensor.basic import as_tensor_variable

    x = as_tensor_variable(x)
    return tuple(shape_i(x, d) for d in range(x.type.ndim))


class Reshape(Op):
    """numpy.reshape with a symbolic target shape (an int64 vector)."""

    __props__ = ("ndim",)

    def __init__(self, ndim: int):
        self.ndim = int(ndim)

    def make_node(self, x, shp):
        from aesara_tpu_torch.tensor.basic import (
            MakeVector, NotScalarConstantError, as_tensor_variable, cast,
            get_scalar_constant_value, get_underlying_constant_vector, stack,
        )

        x = as_tensor_variable(x)
        if isinstance(shp, (list, tuple)):
            shp = stack([cast(as_tensor_variable(s), "int64") for s in shp])
        shp = cast(as_tensor_variable(shp), "int64")
        if shp.type.ndim != 1:
            raise TypeError("reshape target must be a vector")
        static = [None] * self.ndim
        try:
            for d, v in enumerate(get_underlying_constant_vector(shp)):
                static[d] = int(v) if int(v) != -1 else None
        except NotScalarConstantError:
            mk = shp.owner
            if mk is not None and isinstance(mk.op, MakeVector) and len(mk.inputs) == self.ndim:
                for d, el in enumerate(mk.inputs):
                    try:
                        v = int(get_scalar_constant_value(el))
                        static[d] = v if v != -1 else None
                    except NotScalarConstantError:
                        pass
            elif mk is not None and isinstance(mk.op, Shape) and mk.inputs[0].type.ndim == self.ndim:
                # reshape(g, shape(x)), the gradient's form: x's static dims
                static = list(mk.inputs[0].type.shape)
        if static.count(None) == 1 and all(s is not None for s in x.type.shape):
            total = int(np.prod(x.type.shape))
            known = int(np.prod([s for s in static if s is not None]))
            if known > 0 and total % known == 0:
                static[static.index(None)] = total // known
        return Apply(self, [x, shp], [TensorType(x.type.dtype, tuple(static))()])

    def perform(self, node, inputs, output_storage):
        x, shp = inputs
        output_storage[0][0] = np.reshape(x, tuple(int(s) for s in shp))

    def connection_pattern(self, node):
        return [[True], [False]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        x, _ = inputs
        return [reshape(output_grads[0], shape(x), ndim=x.type.ndim), disconnected_type()]


def reshape(x, newshape, ndim: Optional[int] = None):
    from aesara_tpu_torch.tensor.basic import as_tensor_variable, get_vector_length

    if ndim is None:
        if isinstance(newshape, (list, tuple)):
            ndim = len(newshape)
        else:
            ndim = get_vector_length(as_tensor_variable(newshape))
    return Reshape(int(ndim))(x, newshape)


def shape_padright(t, n_ones: int = 1):
    """``t`` with ``n_ones`` broadcastable dims appended."""
    from aesara_tpu_torch.tensor.basic import as_tensor_variable

    t = as_tensor_variable(t)
    return t.dimshuffle(*range(t.type.ndim), *(["x"] * n_ones))


def shape_padleft(t, n_ones: int = 1):
    """``t`` with ``n_ones`` broadcastable dims prepended."""
    from aesara_tpu_torch.tensor.basic import as_tensor_variable

    t = as_tensor_variable(t)
    return t.dimshuffle(*(["x"] * n_ones), *range(t.type.ndim))


class SpecifyShape(Op):
    """``x``, checked at run time to have the given dims (-1: any), with
    the static ones in its type."""

    __props__ = ()

    def make_node(self, x, *shape):
        from aesara_tpu_torch.tensor.basic import (
            NotScalarConstantError, as_tensor_variable, cast, constant, get_scalar_constant_value,
        )

        x = as_tensor_variable(x)
        if len(shape) != x.type.ndim:
            raise ValueError(f"SpecifyShape: got {len(shape)} dims for ndim {x.type.ndim}")
        shape_vars, static = [], []
        for d, s in enumerate(shape):
            if s is None:
                static.append(x.type.shape[d])
                shape_vars.append(constant(-1, dtype="int64"))
                continue
            if isinstance(s, (int, np.integer)):
                static.append(int(s))
                shape_vars.append(constant(int(s), dtype="int64"))
                continue
            s = as_tensor_variable(s)
            try:
                static.append(int(get_scalar_constant_value(s)))
            except NotScalarConstantError:
                static.append(x.type.shape[d])
            shape_vars.append(cast(s, "int64"))
        merged = []
        for d, (old, new) in enumerate(zip(x.type.shape, static)):
            if old is not None and new is not None and old != new:
                raise TypeError(f"SpecifyShape conflict at dim {d}: {old} vs {new}")
            merged.append(new if new is not None else old)
        return Apply(self, [x] + shape_vars, [TensorType(x.type.dtype, tuple(merged))()])

    def perform(self, node, inputs, output_storage):
        x, *shp = inputs
        check_specified_shape(np.shape(x), shp)
        output_storage[0][0] = x

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        return [output_grads[0]] + [disconnected_type() for _ in inputs[1:]]


def check_specified_shape(actual, shape) -> None:
    """Raise unless each dim of ``actual`` is its entry of ``shape`` (-1: any)."""
    for d, s in enumerate(shape):
        s = int(s)
        if s != -1 and actual[d] != s:
            raise AssertionError(f"SpecifyShape: dim {d} is {actual[d]}, expected {s}")


_specify_shape = SpecifyShape()


def specify_shape(x, shape):
    if not isinstance(shape, (list, tuple)):
        shape = (shape,)
    return _specify_shape(x, *shape)


class Unbroadcast(Op):
    """``x`` with the static 1 of the given dims erased from its type."""

    __props__ = ("axes",)

    def __init__(self, *axis):
        self.axes = tuple(sorted(int(a) for a in axis))

    def make_node(self, x):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        shape = list(x.type.shape)
        for a in self.axes:
            if a >= x.type.ndim:
                raise ValueError(f"axis {a} out of range")
            shape[a] = None
        return Apply(self, [x], [TensorType(x.type.dtype, tuple(shape))()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]

    def grad(self, inputs, output_grads):
        return [specify_shape(output_grads[0], inputs[0].type.shape)]


def unbroadcast(x, *axes):
    from aesara_tpu_torch.tensor.basic import as_tensor_variable

    x = as_tensor_variable(x)
    real = [a for a in axes if x.type.shape[a] == 1]
    return Unbroadcast(*real)(x) if real else x
