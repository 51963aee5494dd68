"""Indexing ops (reference ``aesara_tpu/tensor/subtensor.py``).

- ``Subtensor`` / ``IncSubtensor`` (``:135,252``): basic indexing with
  slices and integers.  Static entries live in ``idx_list``; a symbolic
  one is ``SYM`` there and a node input, in order.
- ``AdvancedSubtensor1`` / ``AdvancedIncSubtensor1`` (``:399,463``): one
  integer vector over axis 0.
- ``AdvancedSubtensor`` / ``AdvancedIncSubtensor`` (``:530,594``): the
  general fancy index: slices (their bounds may be symbolic), integers and
  index arrays, integer or boolean (a rank-k mask indexes k dims), placed
  as NumPy places them (``_fancy_layout``).  The static output shape is
  the broadcast of the arrays' (a mask's length where it is a constant)
  and the slices' lengths.
- ``DynamicSlice`` / ``DynamicIncSubtensor`` (``:923,1018``): a window of
  static length at a start computed at run time, clamped into the axis as
  ``lax.dynamic_slice`` clamps it (a negative start is wrapped once
  first).  The specialize rewrite ``local_affine_slice_to_dynamic`` makes
  one of ``data[i*B:(i+1)*B]``, the minibatch idiom of the tutorials.

Every op computes out of place, but where the caller owns ``x``: a Scan's
loop-carried state or a donated shared variable
(``link/torch/dispatch.py::in_place_lowering``).
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply, Constant, Variable
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import discrete_dtypes, int_dtypes, uint_dtypes
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast, constant
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["SYM", "Subtensor", "IncSubtensor", "AdvancedSubtensor1", "AdvancedIncSubtensor1",
           "AdvancedSubtensor", "AdvancedIncSubtensor", "DynamicSlice", "DynamicIncSubtensor",
           "set_subtensor", "inc_subtensor", "take_slice", "indices_from_subtensor"]

ARRAY = "array"


class _Sym:
    """The placeholder in an ``idx_list`` for the next node input."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "SYM"

    def __reduce__(self):
        return (_Sym, ())


SYM = _Sym()


def _norm_entry(e, inputs=None):
    """(encoded entry, the inputs it consumes) of one index entry
    (``inputs``, the inputs so far, is the JAX package's parameter and is
    not read)."""
    if isinstance(e, (int, np.integer)) and not isinstance(e, bool):
        return int(e), []
    if isinstance(e, Variable):
        v = as_tensor_variable(e)
        if v.type.ndim != 0:
            raise TypeError("basic index entries must be scalars")
        if v.type.dtype not in int_dtypes + uint_dtypes:
            raise TypeError(f"index must be an integer, got {v.type.dtype}")
        if isinstance(v, Constant):
            return int(v.data), []
        return SYM, [cast(v, "int64")]
    raise TypeError(f"invalid index entry {e!r}")


def encode_indices(idx):
    """(idx_list, inputs) of a tuple of slices, integers and integer
    scalars."""
    idx_list, inputs = [], []
    for e in idx:
        if isinstance(e, slice):
            parts = []
            for p in (e.start, e.stop, e.step):
                if p is None:
                    parts.append(None)
                else:
                    enc, cons = _norm_entry(p)
                    parts.append(enc)
                    inputs.extend(cons)
            idx_list.append(slice(*parts))
        else:
            enc, cons = _norm_entry(e)
            idx_list.append(enc)
            inputs.extend(cons)
    return tuple(idx_list), inputs


def indices_from_subtensor(op_inputs, idx_list):
    """The index tuple of ``idx_list`` with its ``SYM`` entries taken from
    ``op_inputs`` in order."""
    it = iter(op_inputs)

    def get(e):
        return next(it) if e is SYM else e

    return tuple(slice(get(e.start), get(e.stop), get(e.step)) if isinstance(e, slice) else get(e)
                 for e in idx_list)


def _static_slice_len(length, sl: slice):
    if any(e is SYM for e in (sl.start, sl.stop, sl.step)) or length is None:
        # a bounded slice over an unknown dim is clamped at run time
        return None
    return len(range(*sl.indices(length)))


def _idx_str(idx_list) -> str:
    def f(v):
        return "" if v is None else ("?" if v is SYM else str(v))

    return ", ".join(f"{f(e.start)}:{f(e.stop)}:{f(e.step)}" if isinstance(e, slice) else f(e)
                     for e in idx_list)


def _disconnected(n):
    from aesara_tpu_torch.gradient import disconnected_type

    return [disconnected_type() for _ in range(n)]


def _sum_grad_over_bcasted_dims(y, gy):
    """gy summed down to y's shape where y was broadcast into the region."""
    from aesara_tpu_torch.tensor.math import sum as tsum

    if gy.type.ndim > y.type.ndim:
        gy = tsum(gy, axis=list(range(gy.type.ndim - y.type.ndim)))
    ones = [d for d in range(y.type.ndim) if y.type.shape[d] == 1 and gy.type.shape[d] != 1]
    if ones:
        gy = tsum(gy, axis=ones, keepdims=True)
    return gy


class Subtensor(Op):
    """x[idx] for basic indices: slices and integers."""

    __props__ = ("idx_list",)
    view_map = {0: [0]}

    def __init__(self, idx_list):
        self.idx_list = tuple(idx_list)

    def make_node(self, x, *inputs):
        x = as_tensor_variable(x)
        if len(self.idx_list) > x.type.ndim:
            raise IndexError("too many indices")
        inputs = [cast(as_tensor_variable(i), "int64") for i in inputs]
        out_shape = [_static_slice_len(x.type.shape[d], e) for d, e in enumerate(self.idx_list)
                     if isinstance(e, slice)]
        out_shape.extend(x.type.shape[len(self.idx_list):])
        return Apply(self, [x] + inputs, [TensorType(x.type.dtype, tuple(out_shape))()])

    def perform(self, node, inputs, output_storage):
        x, *index_inputs = inputs
        idx = indices_from_subtensor([int(i) for i in index_inputs], self.idx_list)
        output_storage[0][0] = np.asarray(x[idx])

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, *index_inputs = inputs
        rest = _disconnected(len(index_inputs))
        if x.type.dtype in discrete_dtypes:
            return [grad_undefined(self, 0, x)] + rest
        return [IncSubtensor(self.idx_list)(zeros_like(x), output_grads[0], *index_inputs)] + rest

    def __str__(self):
        return f"Subtensor{{{_idx_str(self.idx_list)}}}"

    def R_op(self, inputs, eval_points):
        return _gather_r_op(self, inputs, eval_points)

    def infer_shape(self, fgraph, node, input_shapes):
        xshape = input_shapes[0]
        idx = indices_from_subtensor(node.inputs[1:], self.idx_list)
        out = []
        for d, e in enumerate(idx):
            if isinstance(e, slice):
                out.append(_symbolic_slice_len(xshape[d], e))
        out.extend(xshape[len(idx):])
        return [tuple(out)]


def _symbolic_slice_len(dim, sl: slice):
    """The symbolic length of slice ``sl`` over a dim of symbolic size
    ``dim`` (the rules of CPython's ``slice.indices``)."""
    from aesara_tpu_torch.tensor import math as tm
    from aesara_tpu_torch.tensor.basic import switch

    def norm(v):
        if isinstance(v, int):
            return constant(v, dtype="int64")
        return cast(as_tensor_variable(v), "int64")

    zero = constant(0, dtype="int64")
    one = constant(1, dtype="int64")
    dim = cast(as_tensor_variable(dim), "int64")
    step = norm(sl.step) if sl.step is not None else one
    pos_step = tm.ge(step, zero)

    lower = switch(pos_step, zero, -one)
    upper = switch(pos_step, dim, dim - one)

    def resolve(v, default_pos, default_neg):
        if v is None:
            return switch(pos_step, default_pos, default_neg)
        v = norm(v)
        return switch(
            tm.lt(v, zero),
            tm.maximum(v + dim, lower),
            tm.minimum(v, upper),
        )

    start_c = resolve(sl.start, zero, dim - one)
    stop_c = resolve(sl.stop, dim, -one)
    astep = tm.abs(step)
    diff = switch(pos_step, stop_c - start_c, start_c - stop_c)
    length = tm.int_div(diff + astep - one, astep)
    return tm.maximum(length, zero)


class IncSubtensor(Op):
    """A copy of x with x[idx] incremented by y (set to y with
    ``set_instead_of_inc``)."""

    __props__ = ("idx_list", "set_instead_of_inc")

    def __init__(self, idx_list, set_instead_of_inc: bool = False):
        self.idx_list = tuple(idx_list)
        self.set_instead_of_inc = bool(set_instead_of_inc)

    def make_node(self, x, y, *inputs):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if y.type.dtype != x.type.dtype:
            y = cast(y, x.type.dtype)
        inputs = [cast(as_tensor_variable(i), "int64") for i in inputs]
        return Apply(self, [x, y] + inputs, [x.type()])

    def perform(self, node, inputs, output_storage):
        x, y, *index_inputs = inputs
        idx = indices_from_subtensor([int(i) for i in index_inputs], self.idx_list)
        out = x.copy()
        if self.set_instead_of_inc:
            out[idx] = y
        else:
            out[idx] += y
        output_storage[0][0] = out

    def connection_pattern(self, node):
        return [[True], [True]] + [[False]] * (len(node.inputs) - 2)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, y, *index_inputs = inputs
        (gz,) = output_grads
        gy = _sum_grad_over_bcasted_dims(y, Subtensor(self.idx_list)(gz, *index_inputs))
        if self.set_instead_of_inc:
            zeros = zeros_like(Subtensor(self.idx_list)(gz, *index_inputs))
            gx = IncSubtensor(self.idx_list, set_instead_of_inc=True)(gz, zeros, *index_inputs)
        else:
            gx = gz
        return [gx, gy] + _disconnected(len(index_inputs))

    def __str__(self):
        return f"{'Set' if self.set_instead_of_inc else 'Inc'}Subtensor{{{_idx_str(self.idx_list)}}}"

    def R_op(self, inputs, eval_points):
        return _inc_r_op(self, inputs, eval_points)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]


def _int_vector(ilist):
    ilist = as_tensor_variable(ilist)
    if ilist.type.dtype not in int_dtypes + uint_dtypes:
        raise TypeError(f"index must be integers, got {ilist.type.dtype}")
    if ilist.type.ndim != 1:
        raise TypeError("index must be a vector")
    return cast(ilist, "int64")


class AdvancedSubtensor1(Op):
    """x[ilist] for one integer vector over axis 0."""

    __props__ = ()

    def make_node(self, x, ilist):
        x = as_tensor_variable(x)
        ilist = _int_vector(ilist)
        if x.type.ndim == 0:
            raise TypeError("cannot index a scalar")
        return Apply(self, [x, ilist], [TensorType(x.type.dtype, (ilist.type.shape[0],) + x.type.shape[1:])()])

    def perform(self, node, inputs, output_storage):
        x, i = inputs
        output_storage[0][0] = x.take(i, axis=0)

    def connection_pattern(self, node):
        return [[True], [False]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, ilist = inputs
        return [AdvancedIncSubtensor1()(zeros_like(x), output_grads[0], ilist)] + _disconnected(1)

    def __str__(self):
        return "AdvancedSubtensor1"

    def R_op(self, inputs, eval_points):
        return _gather_r_op(self, inputs, eval_points)

    def infer_shape(self, fgraph, node, input_shapes):
        xshape, ishape = input_shapes
        return [(ishape[0],) + tuple(xshape[1:])]


class AdvancedIncSubtensor1(Op):
    """A copy of x with y added at the rows ``ilist`` (duplicates
    accumulate), or written there with ``set_instead_of_inc``."""

    __props__ = ("set_instead_of_inc",)

    def __init__(self, set_instead_of_inc: bool = False):
        self.set_instead_of_inc = bool(set_instead_of_inc)

    def make_node(self, x, y, ilist):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if y.type.dtype != x.type.dtype:
            y = cast(y, x.type.dtype)
        return Apply(self, [x, y, _int_vector(ilist)], [x.type()])

    def perform(self, node, inputs, output_storage):
        x, y, i = inputs
        out = x.copy()
        if self.set_instead_of_inc:
            out[i] = y
        else:
            np.add.at(out, i, y)
        output_storage[0][0] = out

    def connection_pattern(self, node):
        return [[True], [True], [False]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, y, ilist = inputs
        (gz,) = output_grads
        gy = _sum_grad_over_bcasted_dims(y, AdvancedSubtensor1()(gz, ilist))
        gx = AdvancedIncSubtensor1(set_instead_of_inc=True)(gz, zeros_like(gy), ilist) \
            if self.set_instead_of_inc else gz
        return [gx, gy] + _disconnected(1)

    def __str__(self):
        return f"Advanced{'Set' if self.set_instead_of_inc else 'Inc'}Subtensor1"

    def R_op(self, inputs, eval_points):
        return _inc_r_op(self, inputs, eval_points)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]


def _index_var(i):
    """An index array as a variable: integers as int64, booleans kept."""
    i = as_tensor_variable(i)
    if i.type.dtype not in discrete_dtypes:
        # a float index must fail when the graph is built, not truncate
        raise TypeError(f"advanced index must be integer or boolean, got {i.type.dtype}")
    return i if i.type.dtype == "bool" else cast(i, "int64")


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


def _mask_length(m):
    """The static count of True entries of a boolean index (None: data)."""
    return int(np.count_nonzero(m.data)) if isinstance(m, Constant) else None


def _fancy_layout(x, idx_list, inputs):
    """(static output shape, the dims of x the advanced entries index, in
    order, and whether NumPy puts their broadcast dims in place): an
    integer entry beside an array is an advanced index too, and the
    broadcast dims of advanced entries that are not adjacent go first, as
    NumPy and torch place them."""
    it = iter(inputs)
    adv_shapes, adv_dims, entry_pos, sliced = [], [], [], []
    d = 0
    for pos, e in enumerate(idx_list):
        if e == ARRAY:
            a = next(it)
            if a.type.dtype == "bool":
                adv_shapes.append((_mask_length(a),))
                adv_dims.extend(range(d, d + a.type.ndim))
                d += a.type.ndim
            else:
                adv_shapes.append(a.type.shape)
                adv_dims.append(d)
                d += 1
            entry_pos.append(pos)
        elif isinstance(e, slice):
            for p in (e.start, e.stop, e.step):
                if p is SYM:
                    next(it)
            sliced.append((d, e))
            d += 1
        else:
            if e is SYM:
                next(it)
            adv_shapes.append(())
            adv_dims.append(d)
            entry_pos.append(pos)
            d += 1
    if d > x.type.ndim:
        raise IndexError(f"too many indices for {x.type}")
    bshape = _broadcast_static(adv_shapes) if adv_shapes else ()
    in_place = entry_pos == list(range(entry_pos[0], entry_pos[-1] + 1)) if entry_pos else True
    kept = [(dim, _static_slice_len(x.type.shape[dim], e) if e is not None else x.type.shape[dim])
            for dim, e in sliced + [(k, None) for k in range(d, x.type.ndim)]]
    if in_place and adv_dims:
        before = [n for dim, n in kept if dim < adv_dims[0]]
        after = [n for dim, n in kept if dim > adv_dims[0]]
        shape = tuple(before) + bshape + tuple(after)
    else:
        shape = bshape + tuple(n for _, n in kept)
    return shape, adv_dims, in_place


class AdvancedSubtensor(Op):
    """General fancy indexing: ``idx_list`` holds slices (their bounds may
    be ``SYM``), integers (or ``SYM``), and ``ARRAY`` for an index-array
    input, integer or boolean (a rank-k mask indexes k dims)."""

    __props__ = ("idx_list",)

    def __init__(self, idx_list):
        self.idx_list = tuple(idx_list)

    def make_node(self, x, *inputs):
        x = as_tensor_variable(x)
        kinds = _input_kinds(self.idx_list)
        if len(inputs) != len(kinds):
            raise TypeError(f"{self} takes {len(kinds)} index inputs, got {len(inputs)}")
        inputs = [_index_var(i) if e == ARRAY else cast(as_tensor_variable(i), "int64")
                  for e, i in zip(kinds, inputs)]
        shape, _, _ = _fancy_layout(x, self.idx_list, inputs)
        return Apply(self, [x] + inputs, [TensorType(x.type.dtype, shape)()])

    def perform(self, node, inputs, output_storage):
        x, *idx_inputs = inputs
        output_storage[0][0] = np.asarray(x[_decode_fancy(self.idx_list, idx_inputs)])

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.shape import shape as tshape

        out = tshape(node.outputs[0])
        return [tuple(out[i] for i in range(node.outputs[0].type.ndim))]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, *idx_inputs = inputs
        gx = AdvancedIncSubtensor(self.idx_list)(zeros_like(x), output_grads[0], *idx_inputs)
        return [gx] + _disconnected(len(idx_inputs))

    def R_op(self, inputs, eval_points):
        return _gather_r_op(self, inputs, eval_points)

    def __str__(self):
        return "AdvancedSubtensor"


class AdvancedIncSubtensor(Op):
    """A copy of ``x`` with ``y`` added at the fancy index (duplicates
    accumulate, unless ``ignore_duplicates``), or written there with
    ``set_instead_of_inc``."""

    __props__ = ("idx_list", "set_instead_of_inc", "ignore_duplicates")

    def __init__(self, idx_list, set_instead_of_inc: bool = False, ignore_duplicates: bool = False):
        self.idx_list = tuple(idx_list)
        self.set_instead_of_inc = bool(set_instead_of_inc)
        self.ignore_duplicates = bool(ignore_duplicates)

    def make_node(self, x, y, *inputs):
        x = as_tensor_variable(x)
        y = as_tensor_variable(y)
        if y.type.dtype != x.type.dtype:
            y = cast(y, x.type.dtype)
        kinds = _input_kinds(self.idx_list)
        if len(inputs) != len(kinds):
            raise TypeError(f"{self} takes {len(kinds)} index inputs, got {len(inputs)}")
        inputs = [_index_var(i) if e == ARRAY else cast(as_tensor_variable(i), "int64")
                  for e, i in zip(kinds, inputs)]
        _fancy_layout(x, self.idx_list, inputs)
        return Apply(self, [x, y] + inputs, [x.type()])

    def perform(self, node, inputs, output_storage):
        x, y, *idx_inputs = inputs
        idx = _decode_fancy(self.idx_list, idx_inputs)
        out = x.copy()
        if self.set_instead_of_inc:
            out[idx] = y
        elif self.ignore_duplicates:
            out[idx] += y
        else:
            np.add.at(out, idx, y)
        output_storage[0][0] = out

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[True], [True]] + [[False]] * (len(node.inputs) - 2)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, y, *idx_inputs = inputs
        (gz,) = output_grads
        gy = _sum_grad_over_bcasted_dims(y, AdvancedSubtensor(self.idx_list)(gz, *idx_inputs))
        if self.set_instead_of_inc:
            gx = AdvancedIncSubtensor(self.idx_list, set_instead_of_inc=True)(gz, zeros_like(gy), *idx_inputs)
        else:
            gx = gz
        return [gx, gy] + _disconnected(len(idx_inputs))

    def __str__(self):
        return f"Advanced{'Set' if self.set_instead_of_inc else 'Inc'}Subtensor"


def _gather_r_op(op, inputs, eval_points):
    """A gather is linear in x: gather the tangent."""
    if eval_points[0] is None:
        return [None]
    return op.make_node(eval_points[0], *inputs[1:]).outputs


def _inc_r_op(op, inputs, eval_points):
    """An inc or set is linear in (x, y): apply it to the tangents (None
    is zeros)."""
    from aesara_tpu_torch.tensor.basic import zeros_like

    ex, ey = eval_points[0], eval_points[1]
    if ex is None and ey is None:
        return [None]
    ex = zeros_like(inputs[0]) if ex is None else ex
    ey = zeros_like(inputs[1]) if ey is None else ey
    return [op.make_node(ex, ey, *inputs[2:]).outputs[0]]


def _input_kinds(idx_list):
    """What each index input of ``idx_list`` is, in order: ``ARRAY`` or
    ``SYM`` (a scalar, as an integer or a slice bound)."""
    kinds = []
    for e in idx_list:
        if e == ARRAY:
            kinds.append(ARRAY)
        elif isinstance(e, slice):
            kinds.extend(SYM for p in (e.start, e.stop, e.step) if p is SYM)
        elif e is SYM:
            kinds.append(SYM)
    return kinds


def _decode_fancy(idx_list, idx_inputs):
    """The NumPy index tuple of ``idx_list`` over host index inputs."""
    it = iter(idx_inputs)

    def get_scalar(e):
        return int(next(it)) if e is SYM else e

    out = []
    for e in idx_list:
        if e == ARRAY:
            out.append(np.asarray(next(it)))
        elif isinstance(e, slice):
            out.append(slice(get_scalar(e.start), get_scalar(e.stop), get_scalar(e.step)))
        else:
            out.append(get_scalar(e))
    return tuple(out)


def _fancy_output_ndim(x, idx_list, array_inputs) -> int:
    """The rank of NumPy's result of a fancy index."""
    return len(_fancy_layout(x, idx_list, list(array_inputs))[0])


def _iter_array_inputs(idx_list, inputs):
    """The index-array inputs among a fancy index's inputs."""
    return [i for e, i in zip(_input_kinds(idx_list), inputs) if e == ARRAY]


def _collect_array_vars(idx_list, inputs):
    return _iter_array_inputs(idx_list, inputs)


class DynamicSlice(Op):
    """A window of static length at a start computed at run time.

    ``lengths`` covers the leading axes: an int is a window of that length
    at the next start input, None keeps the axis whole; trailing axes are
    kept whole.  A start is wrapped once if negative, then clamped into
    ``[0, dim - length]``, as ``lax.dynamic_slice`` does: an overhanging
    window slides back instead of shortening.  In-range starts give
    NumPy's slice.
    """

    __props__ = ("lengths",)

    def __init__(self, lengths):
        self.lengths = tuple(int(n) if n is not None else None for n in lengths)
        if not any(n is not None for n in self.lengths):
            raise ValueError("DynamicSlice needs at least one sized axis")

    def make_node(self, x, *starts):
        x = as_tensor_variable(x)
        n_dyn = sum(n is not None for n in self.lengths)
        if len(starts) != n_dyn:
            raise ValueError(f"DynamicSlice{self.lengths} expects {n_dyn} starts, got {len(starts)}")
        if len(self.lengths) > x.type.ndim:
            raise IndexError("too many dynamic-slice axes")
        starts = [cast(as_tensor_variable(s), "int64") for s in starts]
        if any(s.type.ndim != 0 for s in starts):
            raise TypeError("dynamic-slice starts must be scalars")
        out_shape = [n if n is not None else x.type.shape[d] for d, n in enumerate(self.lengths)]
        out_shape.extend(x.type.shape[len(self.lengths):])
        return Apply(self, [x] + starts, [TensorType(x.type.dtype, tuple(out_shape))()])

    def clamped_index(self, xshape, starts):
        """The index tuple of a window for host ``starts``."""
        it = iter(starts)
        idx = []
        for d, n in enumerate(self.lengths):
            if n is None:
                idx.append(slice(None))
                continue
            if n > xshape[d]:
                raise ValueError(f"a window of {n} does not fit in axis {d} of length {xshape[d]}")
            s = int(next(it))
            s = s + xshape[d] if s < 0 else s
            s = min(max(s, 0), xshape[d] - n)
            idx.append(slice(s, s + n))
        return tuple(idx)

    def perform(self, node, inputs, output_storage):
        x, *starts = inputs
        output_storage[0][0] = np.asarray(x[self.clamped_index(x.shape, starts)])

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, *starts = inputs
        rest = _disconnected(len(starts))
        if x.type.dtype in discrete_dtypes:
            return [grad_undefined(self, 0, x)] + rest
        return [DynamicIncSubtensor(self.lengths)(zeros_like(x), output_grads[0], *starts)] + rest

    def __str__(self):
        return f"DynamicSlice{{{', '.join('?:?+%d' % n if n is not None else ':' for n in self.lengths)}}}"

    def R_op(self, inputs, eval_points):
        return _gather_r_op(self, inputs, eval_points)

    def infer_shape(self, fgraph, node, input_shapes):
        xshape = input_shapes[0]
        out = [
            (constant(l, dtype="int64") if l is not None else xshape[d])
            for d, l in enumerate(self.lengths)
        ]
        out.extend(xshape[len(self.lengths):])
        return [tuple(out)]


class DynamicIncSubtensor(Op):
    """A copy of x with y added to (or written into) the window of
    :class:`DynamicSlice` at run-time starts, clamped the same way."""

    __props__ = ("lengths", "set_instead_of_inc")

    def __init__(self, lengths, set_instead_of_inc: bool = False):
        self.lengths = tuple(int(n) if n is not None else None for n in lengths)
        self.set_instead_of_inc = bool(set_instead_of_inc)

    def make_node(self, x, y, *starts):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        n_dyn = sum(n is not None for n in self.lengths)
        if len(starts) != n_dyn:
            raise ValueError(f"DynamicIncSubtensor{self.lengths} expects {n_dyn} starts")
        if y.type.ndim != x.type.ndim:
            raise TypeError(f"window rank {y.type.ndim} must equal target rank {x.type.ndim}")
        starts = [cast(as_tensor_variable(s), "int64") for s in starts]
        return Apply(self, [x, y] + starts, [x.type()])

    def perform(self, node, inputs, output_storage):
        x, y, *starts = inputs
        idx = DynamicSlice.clamped_index(self, x.shape, starts)
        out = x.copy()
        if self.set_instead_of_inc:
            out[idx] = y
        else:
            out[idx] += y
        output_storage[0][0] = out

    def connection_pattern(self, node):
        return [[True], [True]] + [[False]] * (len(node.inputs) - 2)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, y, *starts = inputs
        (gz,) = output_grads
        gx = DynamicIncSubtensor(self.lengths, set_instead_of_inc=True)(gz, zeros_like(y), *starts) \
            if self.set_instead_of_inc else gz
        return [gx, DynamicSlice(self.lengths)(gz, *starts)] + _disconnected(len(starts))

    def __str__(self):
        kind = "Set" if self.set_instead_of_inc else "Inc"
        return f"Dynamic{kind}Subtensor{{{', '.join('?:?+%d' % n if n is not None else ':' for n in self.lengths)}}}"

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]


def set_subtensor(x, y):
    """The base tensor of the indexing expression ``x`` with that region
    set to ``y``."""
    return inc_subtensor(x, y, set_instead_of_inc=True)


def inc_subtensor(x, y, set_instead_of_inc: bool = False):
    """The base tensor of the indexing expression ``x`` with ``y`` added
    to that region (written there with ``set_instead_of_inc``)."""
    if x.owner is None:
        raise TypeError("x must be the result of indexing")
    op = x.owner.op
    if isinstance(op, Subtensor):
        base, *index_inputs = x.owner.inputs
        return IncSubtensor(op.idx_list, set_instead_of_inc=set_instead_of_inc)(base, y, *index_inputs)
    if isinstance(op, AdvancedSubtensor1):
        base, ilist = x.owner.inputs
        return AdvancedIncSubtensor1(set_instead_of_inc=set_instead_of_inc)(base, y, ilist)
    if isinstance(op, AdvancedSubtensor):
        base, *index_inputs = x.owner.inputs
        return AdvancedIncSubtensor(op.idx_list, set_instead_of_inc=set_instead_of_inc)(base, y, *index_inputs)
    if isinstance(op, DynamicSlice):
        base, *starts = x.owner.inputs
        return DynamicIncSubtensor(op.lengths, set_instead_of_inc=set_instead_of_inc)(base, y, *starts)
    raise TypeError(f"cannot inc_subtensor through {op}")


def _is_array_like(a) -> bool:
    if isinstance(a, (list, np.ndarray)):
        return True
    return isinstance(a, Variable) and (getattr(a.type, "ndim", 0) >= 1 or getattr(a.type, "dtype", "") == "bool")


def _is_bool_array(a) -> bool:
    if isinstance(a, np.ndarray) and a.dtype == np.bool_:
        return True
    return isinstance(a, Variable) and getattr(a.type, "dtype", None) == "bool" and a.type.ndim >= 1


def _bool_ndim(a) -> int:
    return a.ndim if isinstance(a, np.ndarray) else a.type.ndim


def _array_ndim(a) -> int:
    return a.type.ndim if isinstance(a, Variable) else np.asarray(a).ndim


def _unwrap_slice(a):
    """A ``SliceConstant`` as its Python slice, a ``MakeSlice`` output as a
    slice of its parts; anything else as it is."""
    from aesara_tpu_torch.tensor.type_other import MakeSlice, NoneTypeT, SliceType

    if not (hasattr(a, "type") and isinstance(a.type, SliceType)):
        return a
    if isinstance(a, Constant):
        return a.data
    if a.owner is not None and isinstance(a.owner.op, MakeSlice):
        parts = [None if isinstance(p.type, NoneTypeT) else p for p in a.owner.inputs]
        # make_slice(2) is slice(start=2): MakeSlice pads trailing Nones
        while len(parts) < 3:
            parts.append(None)
        return slice(*parts)
    raise NotImplementedError("free symbolic slice variables are not indexable; build them with "
                              "make_slice(start, stop, step)")


def take_slice(x, args):
    """``x[args]``: slices, integers (Python or integer scalars), None,
    Ellipsis, and integer or boolean arrays.  Basic indices give a
    ``Subtensor`` (a ``DimShuffle`` adds the None axes); a single leading
    integer vector gives ``AdvancedSubtensor1``; any other index with an
    array gives ``AdvancedSubtensor``.  A rank-k mask consumes k dims when
    Ellipsis expands."""
    from aesara_tpu_torch.tensor.elemwise import DimShuffle

    x = as_tensor_variable(x)
    args = args if isinstance(args, tuple) else (args,)
    args = tuple(_unwrap_slice(a) for a in args)
    if sum(a is Ellipsis for a in args) > 1:
        raise IndexError("an index can only have a single ellipsis")
    n_real = sum(_bool_ndim(a) if _is_bool_array(a) else 1 for a in args if a is not None and a is not Ellipsis)
    expanded = []
    for a in args:
        expanded.extend([slice(None)] * (x.type.ndim - n_real) if a is Ellipsis else [a])
    newaxis, stripped, out_dim = [], [], 0
    for a in expanded:
        if a is None:
            newaxis.append(out_dim)
            out_dim += 1
        else:
            stripped.append(a)
            out_dim += isinstance(a, slice) or _is_array_like(a)
    if sum(_bool_ndim(a) if _is_bool_array(a) else 1 for a in stripped) > x.type.ndim:
        raise IndexError(f"too many indices for {x.type}")
    arrays = [k for k, a in enumerate(stripped) if _is_array_like(a)]
    if not arrays:
        if all(a == slice(None) for a in stripped):
            res = x
        else:
            idx_list, inputs = encode_indices(stripped)
            res = Subtensor(idx_list)(x, *inputs)
    elif (arrays == [0] and not _is_bool_array(stripped[0]) and _array_ndim(stripped[0]) == 1
          and all(a == slice(None) for a in stripped[1:])):
        res = AdvancedSubtensor1()(x, stripped[0])
    else:
        idx_list, inputs = [], []
        for a in stripped:
            if _is_array_like(a):
                idx_list.append(ARRAY)
                inputs.append(as_tensor_variable(a))
            else:
                enc, cons = encode_indices((a,))
                idx_list.extend(enc)
                inputs.extend(cons)
        res = AdvancedSubtensor(tuple(idx_list))(x, *inputs)
    if newaxis:
        order, k = [], 0
        for d in range(res.type.ndim + len(newaxis)):
            if d in newaxis:
                order.append("x")
            else:
                order.append(k)
                k += 1
        res = DimShuffle(res.type.ndim, tuple(order))(res)
    return res


def take(x, indices, axis=None, mode="raise"):
    """``numpy.take``: over the flattened ``x``, or along ``axis``."""
    from aesara_tpu_torch.tensor.shape import reshape

    x = as_tensor_variable(x)
    indices = as_tensor_variable(indices)
    if axis is None:
        flat = x.flatten()
        if indices.type.ndim == 1:
            return AdvancedSubtensor1()(flat, indices)
        res = AdvancedSubtensor1()(flat, indices.flatten())
        return reshape(res, indices.shape, ndim=indices.type.ndim)
    axis = int(axis) % x.type.ndim
    if axis == 0 and indices.type.ndim == 1:
        return AdvancedSubtensor1()(x, indices)
    return take_slice(x, tuple([slice(None)] * axis + [indices]))


__all__ += ["take"]
