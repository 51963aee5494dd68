"""Tensor construction and structural ops (reference
``aesara_tpu/tensor/basic.py``): conversion to variables, constants with
the JAX package's literal dtype rules, ``cast``, ``fill`` (with
``ones_like``/``zeros_like``, which gradients build), ``switch``,
``MakeVector``, ``Alloc`` (with ``full``/``zeros``/``ones``),
``AllocEmpty``, ``ARange``, ``flatten``, the scalar/tensor bridges
``TensorFromScalar``/``ScalarFromTensor``, and ``Join``/``Split`` (with
``join``, ``concatenate``, ``stack`` and ``split``), the structural ops
Scan's graphs build."""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Apply, Constant, Variable
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.scalar.ops import ScalarType, _np_dtype, from_host, is_torch_tensor, to_host, upcast
from aesara_tpu_torch.tensor.elemwise import DimShuffle, Elemwise, check_static_broadcast
from aesara_tpu_torch.tensor.type import TensorType
from aesara_tpu_torch.tensor.var import TensorConstant, TensorVariable


__all__ = [
    "as_tensor_variable", "constant", "cast", "fill", "second", "ones_like", "zeros_like",
    "MakeVector", "stack", "get_scalar_constant_value", "get_vector_length",
    "NotScalarConstantError", "Alloc", "alloc", "ARange", "arange", "flatten", "switch", "where",
    "full", "zeros", "ones", "AllocEmpty", "empty", "TensorFromScalar", "ScalarFromTensor",
    "tensor_from_scalar", "scalar_from_tensor", "Join", "join", "concatenate", "Split", "split",
]


class NotScalarConstantError(Exception):
    """get_scalar_constant_value found no constant."""


def as_tensor_variable(x, name=None, ndim=None) -> TensorVariable:
    """Coerce ``x`` into a TensorVariable."""
    if isinstance(x, Variable):
        if not isinstance(x.type, TensorType):
            raise TypeError(f"cannot convert {x} of type {x.type} to a TensorVariable")
        if ndim is not None and x.type.ndim != ndim:
            if x.type.ndim > ndim:
                raise ValueError(f"cannot reduce ndim of {x} to {ndim}")
            x = DimShuffle(x.type.ndim, ("x",) * (ndim - x.type.ndim) + tuple(range(x.type.ndim)))(x)
        return x
    if isinstance(x, (list, tuple)) and any(isinstance(e, Variable) for e in x):
        return stack(list(x))
    if isinstance(x, (np.ndarray, np.generic, int, float, bool, list, tuple)) or is_torch_tensor(x):
        return constant(x, name=name, ndim=ndim)
    raise TypeError(f"cannot convert {x!r} to a TensorVariable")


def constant(x, name=None, ndim=None, dtype=None) -> TensorConstant:
    """A TensorConstant; bare Python ints take the smallest int dtype that
    holds them and bare floats ``config.floatX``, so literals do not
    upcast expressions."""
    if isinstance(x, TensorConstant):
        if (name in (None, x.name) and ndim in (None, x.type.ndim)
                and dtype in (None, x.type.dtype)):
            return x
        x, dtype = x.data, dtype or x.type.dtype   # a bfloat16 one's data is its host form
    if is_torch_tensor(x):
        # a torch tensor (the user form of a bfloat16 value): its dtype
        dtype = dtype or str(x.dtype).split(".")[-1]
    if dtype is None and not isinstance(x, (np.ndarray, np.generic)):
        if isinstance(x, bool):
            dtype = "bool"
        elif isinstance(x, int):
            dtype = ("int8" if -128 <= x < 128 else "int16" if -(2**15) <= x < 2**15
                     else "int32" if -(2**31) <= x < 2**31 else "int64")
        elif isinstance(x, float):
            dtype = config.floatX
    arr = np.asarray(x) if dtype is None else to_host(x, dtype)
    if ndim is not None:
        if arr.ndim > ndim:
            extra = arr.ndim - ndim
            if arr.shape[:extra] != (1,) * extra:
                raise ValueError(f"cannot reduce constant to ndim {ndim}")
            arr = arr.reshape(arr.shape[extra:])
        while arr.ndim < ndim:
            arr = arr[None]
    if dtype == "bfloat16":
        arr = from_host(arr, dtype)   # the form a bfloat16 type admits
    return TensorConstant(TensorType(dtype or arr.dtype.name, tuple(arr.shape)), arr, name=name)


def cast(x, dtype: str):
    """Symbolic dtype conversion (Elemwise over the scalar Cast)."""
    if dtype == "floatX":
        dtype = config.floatX
    x = as_tensor_variable(x)
    if x.type.dtype == dtype:
        return x
    return Elemwise(aes.Cast(ScalarType(dtype)))(x)


def switch(cond, ift, iff):
    """ift where cond is nonzero, else iff, elementwise with broadcasting."""
    return Elemwise(aes.switch)(cond, ift, iff)


where = switch


fill = Elemwise(aes.second, name="fill")
"""fill(template, value): value broadcast to the template's shape."""
second = fill


def ones_like(x, dtype=None):
    x = as_tensor_variable(x)
    return fill(x, constant(1, dtype=dtype or x.type.dtype))


def zeros_like(x, dtype=None):
    x = as_tensor_variable(x)
    return fill(x, constant(0, dtype=dtype or x.type.dtype))


class MakeVector(Op):
    """Pack N 0-d tensors into a length-N vector."""

    __props__ = ("dtype",)

    def __init__(self, dtype: str = "int64"):
        self.dtype = dtype

    def make_node(self, *inputs):
        inputs = [as_tensor_variable(i) for i in inputs]
        for i in inputs:
            if i.type.ndim != 0:
                raise TypeError("MakeVector inputs must be scalars")
            if not np.can_cast(_np_dtype(i.type.dtype), _np_dtype(self.dtype)):
                raise TypeError(f"MakeVector({self.dtype}) got {i.type.dtype}")
        inputs = [cast(i, self.dtype) for i in inputs]
        return Apply(self, inputs, [TensorType(self.dtype, (len(inputs),))()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = to_host(inputs, self.dtype)


def get_scalar_constant_value(v):
    """The Python scalar behind a constant scalar graph, walking through
    DimShuffle and Elemwise; raises NotScalarConstantError otherwise."""
    for _ in range(10):
        if isinstance(v, Constant):
            data = np.asarray(v.data)
            if data.size != 1:
                raise NotScalarConstantError(str(v))
            return data.reshape(())[()]
        if v.owner is None:
            raise NotScalarConstantError(str(v))
        op = v.owner.op
        if isinstance(op, DimShuffle):
            v = v.owner.inputs[0]
            continue
        if isinstance(op, Elemwise):
            vals = [get_scalar_constant_value(i) for i in v.owner.inputs]
            return to_host(op.scalar_op.impl(*vals), v.type.dtype)[()]
        raise NotScalarConstantError(str(v))
    raise NotScalarConstantError("max recursion")


def get_underlying_constant_vector(v):
    """Constant value of a vector graph (through MakeVector/Cast)."""
    if isinstance(v, Constant):
        return np.asarray(v.data)
    if v.owner is not None and isinstance(v.owner.op, MakeVector):
        return np.asarray([get_scalar_constant_value(i) for i in v.owner.inputs])
    if (v.owner is not None and isinstance(v.owner.op, Elemwise)
            and isinstance(v.owner.op.scalar_op, aes.Cast)):
        return get_underlying_constant_vector(v.owner.inputs[0])
    raise NotScalarConstantError(str(v))


def get_vector_length(v) -> int:
    """Static length of a symbolic vector."""
    v = as_tensor_variable(v)
    if v.type.ndim != 1:
        raise TypeError("not a vector")
    if v.type.shape[0] is not None:
        return int(v.type.shape[0])
    raise ValueError(f"length of {v} not known statically")


class Alloc(Op):
    """``value`` broadcast to a runtime shape (one int64 scalar per dim);
    a value dim broadcasts only where it is statically 1."""

    __props__ = ()

    def make_node(self, value, *shape):
        value = as_tensor_variable(value)
        shape = [cast(as_tensor_variable(s), "int64") for s in shape]
        if any(s.type.ndim != 0 for s in shape) or value.type.ndim > len(shape):
            raise TypeError(f"Alloc takes one scalar per dim and at most {len(shape)} value dims")
        static = []
        for s in shape:
            try:
                static.append(int(get_scalar_constant_value(s)))
            except NotScalarConstantError:
                static.append(None)
        offset = len(shape) - value.type.ndim
        for d, vs in enumerate(value.type.shape):
            t = static[offset + d]
            if vs is not None and vs != 1 and t is not None and vs != t:
                raise TypeError(f"Alloc cannot broadcast value dim {d} ({vs}) to {t}")
        return Apply(self, [value] + shape, [TensorType(value.type.dtype, tuple(static))()])

    def perform(self, node, inputs, output_storage):
        value, *shape = inputs
        target = tuple(int(s) for s in shape)
        check_static_broadcast([node.inputs[0].type.shape, target], [np.shape(value), target])
        output_storage[0][0] = np.broadcast_to(value, target).copy()

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def do_constant_folding(self, fgraph, node):
        # a fill on the device costs less than a host array copied there
        return False

    def grad(self, inputs, output_grads):
        """The output gradient summed over the dims the value was broadcast
        along."""
        from aesara_tpu_torch.gradient import disconnected_type, grad_undefined
        from aesara_tpu_torch.tensor.math import sum as tsum

        value, *shape = inputs
        (gz,) = output_grads
        rest = [disconnected_type() for _ in shape]
        if value.type.dtype in aes.discrete_dtypes:
            return [grad_undefined(self, 0, value, "discrete value")] + rest
        n_extra = gz.type.ndim - value.type.ndim
        gv = tsum(gz, axis=list(range(n_extra))) if n_extra else gz
        ones = [d for d in range(value.type.ndim) if value.type.shape[d] == 1]
        if ones:
            gv = tsum(gv, axis=ones, keepdims=True)
        return [gv] + rest


def alloc(value, *shape):
    return Alloc()(value, *shape)


class ARange(Op):
    """numpy.arange(start, stop, step) in ``dtype``."""

    __props__ = ("dtype",)

    def __init__(self, dtype: str):
        self.dtype = dtype

    def make_node(self, start, stop, step):
        start, stop, step = [as_tensor_variable(a) for a in (start, stop, step)]
        if any(a.type.ndim != 0 for a in (start, stop, step)):
            raise TypeError("arange takes scalars")
        try:
            s0, s1, s2 = (float(get_scalar_constant_value(a)) for a in (start, stop, step))
            length = max(0, int(np.ceil((s1 - s0) / s2)))
        except NotScalarConstantError:
            length = None
        return Apply(self, [start, stop, step], [TensorType(self.dtype, (length,))()])

    def perform(self, node, inputs, output_storage):
        start, stop, step = inputs
        output_storage[0][0] = np.arange(start, stop, step, dtype=_np_dtype(self.dtype))

    def connection_pattern(self, node):
        return [[False], [False], [False]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        return [disconnected_type() for _ in inputs]


def arange(start, stop=None, step=1, dtype=None):
    """numpy.arange; integer arguments give int64, as in the JAX package."""
    if stop is None:
        start, stop = 0, start
    if dtype is None:
        dtype = upcast(*[a.type.dtype if isinstance(a, Variable) else np.asarray(a).dtype.name
                         for a in (start, stop, step)])
        if not dtype.startswith("float"):
            dtype = upcast(dtype, "int64")
    return ARange(dtype)(start, stop, step)


def flatten(x, ndim: int = 1):
    """``x`` reshaped to one dim (the only form the port uses), to the
    product of its shape, as the JAX package builds it."""
    from aesara_tpu_torch.tensor.math import prod
    from aesara_tpu_torch.tensor.shape import reshape, shape

    x = as_tensor_variable(x)
    if ndim != 1:
        raise NotImplementedError("flatten to more than one dim is not ported yet")
    if x.type.ndim == 1:
        return x
    return reshape(x, stack([cast(prod(shape(x)), "int64")]), ndim=1)


# ---------------------------------------------------------------------------
# scalar <-> 0-d tensor bridges
# ---------------------------------------------------------------------------

class TensorFromScalar(Op):
    """A ScalarType value as a 0-d tensor."""

    __props__ = ()

    def make_node(self, s):
        if not isinstance(s.type, ScalarType):
            raise TypeError("input must be a scalar-typed variable")
        return Apply(self, [s], [TensorType(s.type.dtype, ())()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(inputs[0])

    def infer_shape(self, fgraph, node, input_shapes):
        return [()]

    def grad(self, inputs, output_grads):
        (s,) = inputs
        if s.type.dtype in aes.discrete_dtypes:
            from aesara_tpu_torch.gradient import grad_undefined

            return [grad_undefined(self, 0, s)]
        return [scalar_from_tensor(output_grads[0])]


class ScalarFromTensor(Op):
    """A 0-d tensor as a ScalarType value."""

    __props__ = ()

    def make_node(self, t):
        t = as_tensor_variable(t)
        if t.type.ndim != 0:
            raise TypeError("input must be a 0-d tensor")
        return Apply(self, [t], [ScalarType(t.type.dtype)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(inputs[0])[()]

    def infer_shape(self, fgraph, node, input_shapes):
        return [()]

    def grad(self, inputs, output_grads):
        return [tensor_from_scalar(output_grads[0])]


tensor_from_scalar = TensorFromScalar()
scalar_from_tensor = ScalarFromTensor()


# ---------------------------------------------------------------------------
# full / zeros / ones / empty
# ---------------------------------------------------------------------------

def full(shape, fill_value, dtype=None):
    fill_value = as_tensor_variable(fill_value)
    if dtype:
        fill_value = cast(fill_value, dtype)
    if not isinstance(shape, (list, tuple)):
        shape = (shape,)
    return alloc(fill_value, *shape)


def zeros(shape, dtype=None):
    return full(shape, constant(0, dtype=dtype or config.floatX))


def ones(shape, dtype=None):
    return full(shape, constant(1, dtype=dtype or config.floatX))


def _normalize_shape_args(shape):
    """Shape arguments as int64 0-d tensors, with their static values."""
    if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
        shape = tuple(shape[0])
    if len(shape) == 1 and isinstance(shape[0], Variable) and shape[0].type.ndim == 1:
        vec = shape[0]
        n = vec.type.shape[0]
        if n is None:
            raise TypeError("shape vector must have a known static length")
        shape = tuple(vec[i] for i in range(n))
    shape_vars, static_shape = [], []
    for s in shape:
        if isinstance(s, (int, np.integer)):
            static_shape.append(int(s))
            shape_vars.append(constant(int(s), dtype="int64"))
            continue
        s = as_tensor_variable(s)
        if s.type.ndim != 0 or s.type.dtype not in aes.discrete_dtypes:
            raise TypeError(f"shape entries must be integer scalars, got {s.type}")
        try:
            static_shape.append(int(get_scalar_constant_value(s)))
        except NotScalarConstantError:
            static_shape.append(None)
        shape_vars.append(cast(s, "int64"))
    return shape_vars, tuple(static_shape)


class AllocEmpty(Op):
    """An output buffer of a given shape whose values are not set."""

    __props__ = ("dtype",)

    def __init__(self, dtype: str):
        self.dtype = dtype if dtype != "floatX" else config.floatX

    def make_node(self, *shape):
        shape_vars, static_shape = _normalize_shape_args(shape)
        return Apply(self, shape_vars, [TensorType(self.dtype, static_shape)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.empty(tuple(int(s) for s in inputs), dtype=_np_dtype(self.dtype))

    def infer_shape(self, fgraph, node, input_shapes):
        return [tuple(node.inputs)]

    def connection_pattern(self, node):
        return [[False]] * len(node.inputs)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        return [disconnected_type() for _ in inputs]

    def do_constant_folding(self, fgraph, node):
        return False


def empty(shape, dtype=None):
    if not isinstance(shape, (list, tuple)):
        shape = (shape,)
    return AllocEmpty(dtype or config.floatX)(*shape)


# ---------------------------------------------------------------------------
# Join / Split / stack
# ---------------------------------------------------------------------------

class Join(Op):
    """Concatenate along an axis (an int64 0-d input)."""

    __props__ = ()

    def make_node(self, axis, *tensors):
        if not tensors:
            raise ValueError("Join needs at least one tensor")
        tensors = [as_tensor_variable(t) for t in tensors]
        ndim = tensors[0].type.ndim
        if any(t.type.ndim != ndim for t in tensors):
            raise TypeError("all Join inputs must have the same ndim")
        out_dtype = upcast(*[t.type.dtype for t in tensors])
        tensors = [cast(t, out_dtype) for t in tensors]
        try:
            static_axis = int(get_scalar_constant_value(as_tensor_variable(axis)))
        except NotScalarConstantError:
            static_axis = None
        if static_axis is not None:
            if not (-ndim <= static_axis < max(ndim, 1)):
                raise ValueError(f"Join axis {static_axis} out of range for ndim {ndim}")
            if static_axis < 0:
                static_axis += ndim
        if static_axis is None:
            # any dim may be the joined one
            out_shape = [None] * ndim
        else:
            out_shape = []
            for d in range(ndim):
                if d == static_axis:
                    sizes = [t.type.shape[d] for t in tensors]
                    out_shape.append(sum(sizes) if all(s is not None for s in sizes) else None)
                else:
                    dims = {t.type.shape[d] for t in tensors if t.type.shape[d] is not None}
                    if len(dims) > 1:
                        raise TypeError(f"Join inputs disagree on dim {d}: {dims}")
                    out_shape.append(next(iter(dims)) if dims else None)
        axis_var = cast(as_tensor_variable(axis), "int64")
        return Apply(self, [axis_var] + tensors, [TensorType(out_dtype, tuple(out_shape))()])

    def perform(self, node, inputs, output_storage):
        axis, *tensors = inputs
        output_storage[0][0] = np.concatenate(tensors, axis=int(axis))

    def connection_pattern(self, node):
        return [[False]] + [[True]] * (len(node.inputs) - 1)

    def grad(self, inputs, output_grads):
        """A Split of the output gradient at the inputs' lengths."""
        from aesara_tpu_torch.gradient import disconnected_type, grad_undefined
        from aesara_tpu_torch.tensor.shape import shape as tshape

        axis, *tensors = inputs
        (gz,) = output_grads
        rval = [disconnected_type()]
        if tensors[0].type.dtype in aes.discrete_dtypes:
            return rval + [grad_undefined(self, i + 1, t) for i, t in enumerate(tensors)]
        sizes = [tshape(t)[axis] for t in tensors]
        splits = split(gz, stack(sizes), len(tensors), axis=axis)
        out = []
        for t, g in zip(tensors, splits):
            if g.type.dtype != t.type.dtype:
                g = cast(g, t.type.dtype)
            out.append(g)
        return rval + out


join_ = Join()


def join(axis, *tensors):
    if len(tensors) == 1:
        return as_tensor_variable(tensors[0])
    return join_(axis, *tensors)


def concatenate(tensors, axis=0):
    return join(axis, *tensors)


def stack(tensors, axis: int = 0):
    """Stack along a new axis: 0-d tensors into a vector (``MakeVector``),
    others by a ``Join`` of their expanded forms."""
    if not isinstance(tensors, (list, tuple)):
        raise TypeError("stack expects a list of tensors")
    if not tensors:
        raise ValueError("empty stack")
    elems = [as_tensor_variable(t) for t in tensors]
    if all(e.type.ndim == 0 for e in elems) and axis == 0:
        return MakeVector(upcast(*[e.type.dtype for e in elems]))(*elems)
    ndim = elems[0].type.ndim
    if axis < 0:
        axis += ndim + 1
    expanded = [DimShuffle(e.type.ndim, tuple(range(axis)) + ("x",) + tuple(range(axis, ndim)))(e)
                for e in elems]
    return join(axis, *expanded)


class Split(Op):
    """Split along an axis into ``len_splits`` pieces of given lengths."""

    __props__ = ("len_splits",)

    def __init__(self, len_splits: int):
        self.len_splits = int(len_splits)

    def make_node(self, x, axis, splits):
        x = as_tensor_variable(x)
        axis = cast(as_tensor_variable(axis), "int64")
        splits = cast(as_tensor_variable(splits), "int64")
        if splits.type.ndim != 1:
            raise TypeError("splits must be a vector")
        try:
            static_axis = int(get_scalar_constant_value(axis))
            if static_axis < 0:
                static_axis += x.type.ndim
        except NotScalarConstantError:
            static_axis = None
        out_types = []
        for i in range(self.len_splits):
            shape = list(x.type.shape)
            if static_axis is not None:
                try:
                    shape[static_axis] = int(get_underlying_constant_vector(splits)[i])
                except (NotScalarConstantError, TypeError, IndexError):
                    shape[static_axis] = None
            else:
                shape = [None] * x.type.ndim
            out_types.append(TensorType(x.type.dtype, tuple(shape))())
        return Apply(self, [x, axis, splits], out_types)

    def perform(self, node, inputs, output_storage):
        x, axis, splits = inputs
        if len(splits) != self.len_splits:
            raise ValueError("wrong number of splits")
        if np.sum(splits) != x.shape[int(axis)]:
            raise ValueError(f"split sizes {splits} do not sum to axis length {x.shape[int(axis)]}")
        for storage, piece in zip(output_storage, np.split(x, np.cumsum(splits[:-1]), axis=int(axis))):
            storage[0] = piece

    def connection_pattern(self, node):
        n = self.len_splits
        return [[True] * n, [False] * n, [False] * n]

    def grad(self, inputs, output_grads):
        """The Join of the pieces' gradients (zeros for a disconnected one)."""
        from aesara_tpu_torch.gradient import DisconnectedType, disconnected_type

        x, axis, splits = inputs
        outs = self(*inputs, return_list=True)
        gouts = [zeros_like(o) if isinstance(g.type, DisconnectedType) else g
                 for g, o in zip(output_grads, outs)]
        return [join(axis, *gouts), disconnected_type(), disconnected_type()]


def split(x, splits_size, n_splits, axis=0):
    """``x`` cut along ``axis`` into ``n_splits`` pieces of the lengths in
    the vector ``splits_size``; always a list."""
    return Split(int(n_splits))(x, axis, splits_size, return_list=True)
