"""Tensor construction and structural ops (reference
``aesara_tpu/tensor/basic.py``): conversion to variables, constants with
the JAX package's literal dtype rules, ``cast``, ``fill`` (with
``ones_like``/``zeros_like``, which gradients build), ``switch``,
``MakeVector``, ``Alloc`` (with ``full``/``zeros``/``ones``),
``AllocEmpty``, ``ARange``, ``flatten``, the scalar/tensor bridges
``TensorFromScalar``/``ScalarFromTensor``, and ``Join``/``Split`` (with
``join``, ``concatenate``, ``stack`` and ``split``), the structural ops
Scan's graphs build; and the user API's core ops (``Eye``, ``Tri``,
``ExtractDiag``, ``AllocDiag``, ``Nonzero``, ``PermuteRowElements``,
``Choose``) with the helpers built on them and the shape conveniences
(``tril``, ``diag``, ``nonzero_values``, ``roll``, ``tile``,
``expand_dims``, ``mgrid``, ...)."""

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

    def infer_shape(self, fgraph, node, input_shapes):
        return [(len(node.inputs),)]


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

    def R_op(self, inputs, eval_points):
        if eval_points[0] is None:
            return [None]
        return [self.make_node(eval_points[0], *inputs[1:]).outputs[0]]

    def infer_shape(self, fgraph, node, input_shapes):
        return [tuple(node.inputs[1:])]


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

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.math import ceil as tceil, maximum as tmaximum, true_div

        start, stop, step = node.inputs
        length = cast(
            tceil(true_div(cast(stop, "float64") - cast(start, "float64"),
                           cast(step, "float64"))),
            "int64",
        )
        return [(tmaximum(length, constant(0, dtype="int64")),)]


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
    """``x`` with its trailing dims merged so that ``ndim`` remain, as the
    JAX package builds it: to a constant shape where the leading dims are
    static, else to the product of its shape (``ndim`` 1) or its leading
    dims and -1."""
    from aesara_tpu_torch.tensor.math import prod
    from aesara_tpu_torch.tensor.shape import reshape, shape

    x = as_tensor_variable(x)
    if not 1 <= ndim <= x.type.ndim:
        raise ValueError(f"flatten ndim {ndim} out of range for input ndim {x.type.ndim}")
    if ndim == x.type.ndim:
        return x
    static = x.type.shape
    if ndim > 1 and all(s is not None for s in static[:ndim - 1]):
        return reshape(x, tuple(static[:ndim - 1]) + (-1,), ndim=ndim)
    if ndim == 1:
        return reshape(x, stack([cast(prod(shape(x)), "int64")]), ndim=1)
    lead = [x.shape[i] for i in range(ndim - 1)] + [constant(-1, dtype="int64")]
    return reshape(x, stack([cast(as_tensor_variable(s), "int64") for s in lead]), ndim=ndim)


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
    view_map = {0: [0]}

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

    def R_op(self, inputs, eval_points):
        # linear in every tensor input: join the tangents
        from aesara_tpu_torch.tensor.basic import zeros_like

        evs = eval_points[1:]
        if all(e is None for e in evs):
            return [None]
        evs = [zeros_like(t) if e is None else e
               for e, t in zip(evs, inputs[1:])]
        return [self.make_node(inputs[0], *evs).outputs[0]]

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.math import add as tadd

        axis = node.inputs[0]
        n = len(node.inputs) - 1
        first = input_shapes[1]
        ndim = len(first)
        try:
            ax = int(get_scalar_constant_value(axis))
            if ax < 0:
                ax += ndim
        except NotScalarConstantError:
            from aesara_tpu_torch.tensor.shape import shape as tshape

            return [tuple(tshape(node.outputs[0])[d] for d in range(ndim))]
        out = list(first)
        total = first[ax]
        for ish in input_shapes[2:]:
            total = tadd(total, ish[ax])
        out[ax] = total
        return [tuple(out)]


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

    def R_op(self, inputs, eval_points):
        if eval_points[0] is None:
            return [None] * self.len_splits
        return self.make_node(eval_points[0], *inputs[1:]).outputs

    def infer_shape(self, fgraph, node, input_shapes):
        xshape, _, _ = input_shapes
        axis = node.inputs[1]
        splits = node.inputs[2]
        out = []
        for i in range(self.len_splits):
            out.append(
                tuple(
                    switch(_eq_idx(d, axis), splits[i], xshape[d])
                    for d in range(node.inputs[0].type.ndim)
                )
            )
        return out


def split(x, splits_size, n_splits, axis=0):
    """``x`` cut along ``axis`` into ``n_splits`` pieces of the lengths in
    the vector ``splits_size``; always a list."""
    return Split(int(n_splits))(x, axis, splits_size, return_list=True)


# ---------------------------------------------------------------------------
# the user API's helpers: conversion, Eye / Tri, diagonals, Nonzero,
# PermuteRowElements, Choose and the shape conveniences (reference
# ``aesara_tpu/tensor/basic.py:79,384-447,599-605,725-820,891-1127,
# 1197-1558``)
# ---------------------------------------------------------------------------

as_tensor = as_tensor_variable
make_vector = MakeVector()


def as_tensor_or_list(x):
    return x


def extract_constant(x, elemwise=True, only_process_constants=False):
    """The Python scalar behind ``x`` where it is a constant scalar graph,
    else ``x``."""
    try:
        return get_scalar_constant_value(x)
    except NotScalarConstantError:
        return x


def full_like(a, fill_value, dtype=None):
    res = fill(as_tensor_variable(a), as_tensor_variable(fill_value))
    return cast(res, dtype) if dtype else res


def empty_like(x, dtype=None):
    x = as_tensor_variable(x)
    return AllocEmpty(dtype or x.type.dtype)(*[x.shape[i] for i in range(x.type.ndim)])


def _static_sizes(*sizes):
    out = []
    for a in sizes:
        try:
            out.append(int(get_scalar_constant_value(a)))
        except NotScalarConstantError:
            out.append(None)
    return tuple(out)


class Eye(Op):
    """``numpy.eye(n, m, k)`` in ``dtype``; the sizes and ``k`` are int64
    scalars, which the lowering needs on the host."""

    __props__ = ("dtype",)

    def __init__(self, dtype=None):
        self.dtype = dtype or config.floatX

    def make_node(self, n, m, k):
        n, m, k = [cast(as_tensor_variable(a), "int64") for a in (n, m, k)]
        return Apply(self, [n, m, k], [TensorType(self.dtype, _static_sizes(n, m))()])

    def perform(self, node, inputs, output_storage):
        n, m, k = inputs
        output_storage[0][0] = to_host(np.eye(int(n), int(m), int(k)), self.dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        return [(node.inputs[0], node.inputs[1])]

    def connection_pattern(self, node):
        return [[False]] * 3

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        return [disconnected_type() for _ in inputs]


def eye(n, m=None, k=0, dtype=None):
    if m is None:
        m = n
    return Eye(dtype)(n, m, k)


def identity_like(x, dtype=None):
    x = as_tensor_variable(x)
    return eye(x.shape[0], x.shape[1], 0, dtype or x.type.dtype)


class Tri(Op):
    """``numpy.tri(n, m, k)``: ones on and below diagonal ``k``."""

    __props__ = ("dtype",)

    def __init__(self, dtype=None):
        self.dtype = dtype or config.floatX

    def make_node(self, n, m, k):
        n, m, k = [cast(as_tensor_variable(a), "int64") for a in (n, m, k)]
        return Apply(self, [n, m, k], [TensorType(self.dtype, _static_sizes(n, m))()])

    def perform(self, node, inputs, output_storage):
        n, m, k = inputs
        output_storage[0][0] = to_host(np.tri(int(n), int(m), int(k)), self.dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        return [(node.inputs[0], node.inputs[1])]

    def connection_pattern(self, node):
        return [[False]] * 3

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        return [disconnected_type() for _ in inputs]


def tri(n, m=None, k=0, dtype=None):
    if m is None:
        m = n
    return Tri(dtype)(n, m, k)


def tril(m, k=0):
    """``m`` with the entries above diagonal ``k`` zeroed (a product with
    ``tri``, as the JAX package builds it)."""
    m = as_tensor_variable(m)
    return m * tri(m.shape[-2], m.shape[-1], k, dtype=m.type.dtype)


def triu(m, k=0):
    m = as_tensor_variable(m)
    mask = tri(m.shape[-2], m.shape[-1], k - 1, dtype=m.type.dtype)
    return m * (constant(1, dtype=m.type.dtype) - mask)


def tril_indices(n, k=0, m=None):
    """The row and column indices of ``tril``'s kept entries (a Nonzero)."""
    from aesara_tpu_torch.tensor.math import ge

    m = n if m is None else m
    return nonzero(ge(arange(0, n).dimshuffle(0, "x") + k, arange(0, m).dimshuffle("x", 0)))


def tril_indices_from(a, k=0):
    a = as_tensor_variable(a)
    return tril_indices(a.shape[0], k=k, m=a.shape[1])


def triu_indices(n, k=0, m=None):
    from aesara_tpu_torch.tensor.math import le

    m = n if m is None else m
    return nonzero(le(arange(0, n).dimshuffle(0, "x") + k, arange(0, m).dimshuffle("x", 0)))


def triu_indices_from(a, k=0):
    a = as_tensor_variable(a)
    return triu_indices(a.shape[0], k=k, m=a.shape[1])


class ExtractDiag(Op):
    """``numpy.diagonal(x, offset, axis1, axis2)``: the other dims, then
    the diagonal.  The result is a view of ``x`` (``view_map``); the linker
    returns no output that shares a shared variable's storage with an
    update."""

    __props__ = ("offset", "axis1", "axis2")
    view_map = {0: [0]}

    def __init__(self, offset=0, axis1=0, axis2=1):
        self.offset, self.axis1, self.axis2 = int(offset), int(axis1), int(axis2)

    def make_node(self, x):
        x = as_tensor_variable(x)
        if x.type.ndim < 2:
            raise TypeError("ExtractDiag needs ndim >= 2")
        ax1, ax2 = self.axis1 % x.type.ndim, self.axis2 % x.type.ndim
        rest = [s for d, s in enumerate(x.type.shape) if d not in (ax1, ax2)]
        s1, s2 = x.type.shape[ax1], x.type.shape[ax2]
        dlen = None
        if s1 is not None and s2 is not None:
            dlen = max(0, min(s1, s2 - self.offset) if self.offset >= 0 else min(s1 + self.offset, s2))
        return Apply(self, [x], [TensorType(x.type.dtype, tuple(rest) + (dlen,))()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.diagonal(inputs[0], self.offset, self.axis1, self.axis2).copy()

    def grad(self, inputs, output_grads):
        """A zero matrix with the output gradient on the diagonal (matrices
        only, as in the JAX package)."""
        from aesara_tpu_torch.tensor.extra_ops import fill_diagonal_offset

        (x,) = inputs
        (gz,) = output_grads
        if x.type.ndim != 2:
            raise NotImplementedError("ExtractDiag grad only for matrices")
        ax1, ax2 = self.axis1 % 2, self.axis2 % 2
        sh = x.shape
        if (ax1, ax2) == (1, 0):
            g = fill_diagonal_offset(zeros((sh[1], sh[0]), dtype=gz.type.dtype), gz, self.offset).T
        else:
            g = fill_diagonal_offset(zeros((sh[0], sh[1]), dtype=gz.type.dtype), gz, self.offset)
        return [cast(g, x.type.dtype)]

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.math import maximum as tmaximum, minimum as tminimum

        (ishape,) = input_shapes
        ndim = node.inputs[0].type.ndim
        ax1, ax2 = self.axis1 % ndim, self.axis2 % ndim
        rest = [s for d, s in enumerate(ishape) if d not in (ax1, ax2)]
        off = constant(self.offset, dtype="int64")
        zero = constant(0, dtype="int64")
        if self.offset >= 0:
            dlen = tminimum(ishape[ax1], ishape[ax2] - off)
        else:
            dlen = tminimum(ishape[ax1] + off, ishape[ax2])
        return [tuple(rest) + (tmaximum(dlen, zero),)]


def diagonal(x, offset=0, axis1=0, axis2=1):
    return ExtractDiag(offset, axis1, axis2)(x)


extract_diag = diagonal


class AllocDiag(Op):
    """A vector's entries on diagonal ``offset`` of a square matrix of
    zeros (over the leading dims of a higher-dimensional input)."""

    __props__ = ("offset", "axis1", "axis2")

    def __init__(self, offset=0, axis1=0, axis2=1):
        self.offset, self.axis1, self.axis2 = int(offset), int(axis1), int(axis2)

    def make_node(self, x):
        x = as_tensor_variable(x)
        if x.type.ndim < 1:
            raise TypeError("AllocDiag needs ndim >= 1")
        n = x.type.shape[-1]
        d = None if n is None else n + abs(self.offset)
        return Apply(self, [x], [TensorType(x.type.dtype, x.type.shape[:-1] + (d, d))()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        if x.ndim == 1:
            res = np.diag(x, self.offset)
        else:
            n = x.shape[-1] + abs(self.offset)
            res = np.zeros(x.shape[:-1] + (n, n), dtype=x.dtype)
            idx = np.arange(x.shape[-1])
            if self.offset >= 0:
                res[..., idx, idx + self.offset] = x
            else:
                res[..., idx - self.offset, idx] = x
        output_storage[0][0] = res

    def grad(self, inputs, output_grads):
        return [diagonal(output_grads[0], self.offset, self.axis1, self.axis2)]

    def infer_shape(self, fgraph, node, input_shapes):
        (ishape,) = input_shapes
        d = ishape[-1] + constant(abs(self.offset), dtype="int64")
        return [tuple(ishape[:-1]) + (d, d)]


def diag(v, k=0):
    """A vector's diagonal matrix, or a matrix's diagonal."""
    v = as_tensor_variable(v)
    if v.type.ndim == 1:
        return AllocDiag(k)(v)
    if v.type.ndim >= 2:
        return diagonal(v, offset=k)
    raise ValueError("diag needs vector or matrix")


class Nonzero(Op):
    """The indices of the nonzero entries, one int64 vector a dim.  The
    result's length is the data's, so a function that holds one runs
    eagerly on the card (as ``Unique``); the JAX package runs it only on
    its PY linker."""

    __props__ = ()

    def make_node(self, a):
        a = as_tensor_variable(a)
        if a.type.ndim == 0:
            raise ValueError("nonzero of 0-d tensor")
        return Apply(self, [a], [TensorType("int64", (None,))() for _ in range(a.type.ndim)])

    def perform(self, node, inputs, output_storage):
        for storage, r in zip(output_storage, np.nonzero(inputs[0])):
            storage[0] = r.astype(np.int64)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, 0, inputs[0])]


_nonzero = Nonzero()


def nonzero(a, return_matrix: bool = False):
    res = _nonzero(a)
    if isinstance(res, Variable):
        res = [res]
    if return_matrix:
        return stack(list(res), axis=0)
    return tuple(res)


def nonzero_values(a):
    a = as_tensor_variable(a)
    return a.flatten()[nonzero(a.flatten())[0]]


def flatnonzero(a):
    return nonzero(as_tensor_variable(a).flatten())[0]


class PermuteRowElements(Op):
    """Each row of ``x`` (its last dim) permuted by the matching row of
    ``y`` (broadcast against each other): ``x[..., y]``, or with
    ``inverse`` the scatter ``out[..., y] = x``."""

    __props__ = ("inverse",)

    def __init__(self, inverse: bool = False):
        self.inverse = bool(inverse)

    def make_node(self, x, y):
        x = as_tensor_variable(x)
        y = cast(as_tensor_variable(y), "int64")
        ndim = max(x.type.ndim, y.type.ndim)
        return Apply(self, [x, y], [TensorType(x.type.dtype, (None,) * ndim)()])

    def perform(self, node, inputs, output_storage):
        x, y = inputs
        shape = np.broadcast_shapes(x.shape, y.shape)
        flat_x = np.broadcast_to(x, shape).reshape(-1, shape[-1])
        flat_y = np.broadcast_to(y, shape).reshape(-1, shape[-1])
        out = np.empty(shape, dtype=x.dtype)
        flat_o = out.reshape(-1, shape[-1])
        for i in range(flat_x.shape[0]):
            if self.inverse:
                flat_o[i][flat_y[i]] = flat_x[i]
            else:
                flat_o[i] = flat_x[i][flat_y[i]]
        output_storage[0][0] = out

    def grad(self, inputs, output_grads):
        """The inverse permutation of the output gradient, summed over the
        dims ``x`` was broadcast along."""
        from aesara_tpu_torch.gradient import grad_undefined
        from aesara_tpu_torch.tensor.math import sum as tsum

        x, y = inputs
        gx = PermuteRowElements(not self.inverse)(output_grads[0], y)
        if gx.type.ndim > x.type.ndim:
            gx = tsum(gx, axis=list(range(gx.type.ndim - x.type.ndim)))
        return [gx, grad_undefined(self, 1, y)]

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.math import maximum as tmaximum

        xs, ys = input_shapes
        nd = node.outputs[0].type.ndim
        xs = (constant(1, dtype="int64"),) * (nd - len(xs)) + tuple(xs)
        ys = (constant(1, dtype="int64"),) * (nd - len(ys)) + tuple(ys)
        return [tuple(tmaximum(a, b) for a, b in zip(xs, ys))]


def permute_row_elements(x, y, inverse=False):
    return PermuteRowElements(bool(inverse))(x, y)


def inverse_permutation(perm):
    return permute_row_elements(arange(as_tensor_variable(perm).shape[-1]), perm, inverse=True)


class Choose(Op):
    """``numpy.choose(a, choices, mode)``.  With ``mode="raise"`` the
    lowering clips an index out of range, as the JAX package's XLA lowering
    does (reading it on the host would make the card wait); ``perform``
    raises, as NumPy and the JAX package's ``perform`` do."""

    __props__ = ("mode",)

    def __init__(self, mode: str = "raise"):
        self.mode = mode

    def make_node(self, a, choices):
        a, choices = as_tensor_variable(a), as_tensor_variable(choices)
        out_shape = (None,) * (choices.type.ndim - 1)
        return Apply(self, [a, choices], [TensorType(choices.type.dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        a, choices = inputs
        output_storage[0][0] = np.choose(a, choices, mode=self.mode)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, i, inp) for i, inp in enumerate(inputs)]


def choose(a, choices, mode="raise"):
    return Choose(mode)(a, choices)


def transpose(x, axes=None):
    x = as_tensor_variable(x)
    if axes is None:
        axes = tuple(range(x.type.ndim - 1, -1, -1))
    return DimShuffle(x.type.ndim, tuple(axes))(x)


def swapaxes(x, axis1, axis2):
    x = as_tensor_variable(x)
    order = list(range(x.type.ndim))
    order[axis1], order[axis2] = order[axis2], order[axis1]
    return DimShuffle(x.type.ndim, tuple(order))(x)


def moveaxis(x, source, destination):
    x = as_tensor_variable(x)
    src = tuple(int(s) % x.type.ndim for s in np.atleast_1d(source))
    dst = tuple(int(d) % x.type.ndim for d in np.atleast_1d(destination))
    order = [n for n in range(x.type.ndim) if n not in src]
    for d, s in sorted(zip(dst, src)):
        order.insert(d, s)
    return DimShuffle(x.type.ndim, tuple(order))(x)


def expand_dims(x, axis):
    """New dims of length 1 at ``axis`` (an int or a tuple); an axis out of
    range or repeated raises, as NumPy's does."""
    x = as_tensor_variable(x)
    if isinstance(axis, int):
        axis = (axis,)
    out_ndim = x.type.ndim + len(axis)
    for a in axis:
        if not -out_ndim <= a < out_ndim:
            raise IndexError(f"expand_dims: axis {a} is out of bounds [-{out_ndim}, {out_ndim})")
    axis = tuple(a % out_ndim for a in axis)
    if len(set(axis)) != len(axis):
        raise ValueError("repeated axis in expand_dims")
    it = iter(range(x.type.ndim))
    return DimShuffle(x.type.ndim, tuple("x" if d in axis else next(it) for d in range(out_ndim)))(x)


def atleast_Nd(x, n: int):
    x = as_tensor_variable(x)
    if x.type.ndim >= n:
        return x
    return DimShuffle(x.type.ndim, ("x",) * (n - x.type.ndim) + tuple(range(x.type.ndim)))(x)


def atleast_1d(x):
    return atleast_Nd(x, 1)


def atleast_2d(x):
    return atleast_Nd(x, 2)


def atleast_3d(*args):
    res = []
    for a in args:
        a = as_tensor_variable(a)
        pattern = {0: ("x", "x", "x"), 1: ("x", 0, "x"), 2: ("x", 0, 1)}.get(a.type.ndim)
        res.append(a.dimshuffle(*pattern) if pattern else a)
    return res if len(res) > 1 else res[0]


def horizontal_stack(*args):
    return concatenate([atleast_2d(a) for a in args], axis=1)


def vertical_stack(*args):
    return concatenate([atleast_2d(a) for a in args], axis=0)


def stacklists(arg):
    """Nested lists of tensors stacked into one tensor."""
    if isinstance(arg, (tuple, list)):
        return stack([stacklists(a) for a in arg], axis=0)
    return as_tensor_variable(arg)


def tensor_copy(x):
    """``x`` as a fresh copy at run time (``DeepCopyOp``)."""
    from aesara_tpu_torch.compile.ops import deep_copy_op

    return deep_copy_op(as_tensor_variable(x))


def is_flat(var, ndim=1):
    return as_tensor_variable(var).type.ndim == ndim


def mul_scalars(xs):
    from aesara_tpu_torch.tensor.math import mul

    res = xs[0]
    for e in xs[1:]:
        res = mul(res, e)
    return res


def roll(x, shift, axis=None):
    """``numpy.roll`` as a take of ``(arange(n) - shift) % n``, so the
    shift may be symbolic."""
    from aesara_tpu_torch.tensor.subtensor import take

    x = as_tensor_variable(x)
    if axis is None:
        flat = x.reshape((mul_scalars([x.shape[i] for i in range(x.type.ndim)]),))
        return roll(flat, shift, 0).reshape(x.shape)
    n = x.shape[axis]
    return take(x, (arange(0, n) - shift) % n, axis=axis)


def tile(x, reps, ndim=None):
    """``numpy.tile`` with static ``reps``: a Join of copies per axis."""
    x = as_tensor_variable(x)
    if isinstance(reps, (int, np.integer)):
        reps = (int(reps),)
    reps = tuple(int(r) for r in reps)
    nd = max(len(reps), x.type.ndim) if ndim is None else ndim
    while x.type.ndim < nd:
        x = x.dimshuffle(*(["x"] + list(range(x.type.ndim))))
    reps = (1,) * (nd - len(reps)) + reps
    for axis, r in enumerate(reps):
        if r == 1:
            continue
        if r < 0:
            raise ValueError("tile reps must be non-negative")
        if r == 0:
            x = x[tuple(slice(0, 0) if d == axis else slice(None) for d in range(nd))]
        else:
            x = join(axis, *([x] * r))
    return x


def transfer(var, target):
    """The identity: the linker places values on its device."""
    return as_tensor_variable(var)


def default(x, default_value):
    """``x`` as an input that takes ``default_value`` when not given."""
    from aesara_tpu_torch.compile.io import In

    return In(as_tensor_variable(x), value=np.asarray(default_value))


class _GridBase:
    """``mgrid[a:b, c:d]`` and ``ogrid[...]`` of aranges."""

    def __init__(self, sparse_grid):
        self.sparse = sparse_grid

    def __getitem__(self, key):
        from aesara_tpu_torch.tensor.math import add

        if not isinstance(key, tuple):
            key = (key,)
        ranges = [arange(0 if sl.start is None else sl.start, sl.stop, 1 if sl.step is None else sl.step)
                  for sl in key]
        nd = len(ranges)
        outs = []
        for i, r in enumerate(ranges):
            order = ["x"] * nd
            order[i] = 0
            outs.append(r.dimshuffle(*order))
        if self.sparse:
            return outs if nd > 1 else outs[0]
        full_ = outs[0]
        for o in outs[1:]:
            full_ = add(full_, o * 0)
        dense = [o + full_ * 0 for o in outs]
        return dense if nd > 1 else dense[0]


mgrid = _GridBase(sparse_grid=False)
ogrid = _GridBase(sparse_grid=True)


__all__ += [
    "as_tensor", "make_vector", "as_tensor_or_list", "extract_constant", "full_like", "empty_like", "Eye", "eye",
    "identity_like", "Tri", "tri", "tril", "triu", "tril_indices", "tril_indices_from", "triu_indices",
    "triu_indices_from", "ExtractDiag", "diagonal", "extract_diag", "AllocDiag", "diag", "Nonzero", "nonzero",
    "nonzero_values", "flatnonzero", "PermuteRowElements", "permute_row_elements", "inverse_permutation",
    "Choose", "choose", "transpose", "swapaxes", "moveaxis", "expand_dims", "atleast_Nd", "atleast_1d",
    "atleast_2d", "atleast_3d", "horizontal_stack", "vertical_stack", "stacklists", "tensor_copy", "is_flat",
    "roll", "tile", "transfer", "default", "mgrid", "ogrid",
]


def _eq_idx(d, axis):
    from aesara_tpu_torch.tensor.math import eq

    return eq(constant(d, dtype="int64"), axis)
