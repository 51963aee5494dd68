"""Indexing ops (reference ``aesara_tpu/tensor/subtensor.py``).

- ``Subtensor`` / ``IncSubtensor`` (``:135,252``): basic indexing with
  slices and integers.  Static entries live in ``idx_list``; a symbolic
  one is ``SYM`` there and a node input, in order.
- ``AdvancedSubtensor1`` / ``AdvancedIncSubtensor1`` (``:399,463``): one
  integer vector over axis 0.
- ``AdvancedSubtensor`` / ``AdvancedIncSubtensor`` (``:530,594``): one
  integer index array for each of the leading dims of ``x``, broadcast
  against each other (the form a negative log-likelihood needs,
  ``logp[arange(n), y]``).  Slices mixed among the arrays and boolean
  masks are not ported.
- ``DynamicSlice`` / ``DynamicIncSubtensor`` (``:923,1018``): a window of
  static length at a start computed at run time, clamped into the axis as
  ``lax.dynamic_slice`` clamps it (a negative start is wrapped once
  first).  The specialize rewrite ``local_affine_slice_to_dynamic`` makes
  one of ``data[i*B:(i+1)*B]``, the minibatch idiom of the tutorials.

Every op computes out of place: the port has no destroy handler yet.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply, Constant, Variable
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import discrete_dtypes, int_dtypes, uint_dtypes
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["SYM", "Subtensor", "IncSubtensor", "AdvancedSubtensor1", "AdvancedIncSubtensor1",
           "AdvancedSubtensor", "AdvancedIncSubtensor", "DynamicSlice", "DynamicIncSubtensor",
           "advanced_subtensor", "set_subtensor", "inc_subtensor", "take_slice", "indices_from_subtensor"]

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


def _norm_entry(e):
    """(encoded entry, the inputs it consumes) of one index entry."""
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
        from aesara_tpu_torch.tensor.basic import zeros_like

        x, *indices = inputs
        gx = AdvancedIncSubtensor(self.idx_list)(zeros_like(x), output_grads[0], *indices)
        return [gx] + _disconnected(len(indices))

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
    return isinstance(a, Variable) and getattr(a.type, "ndim", 0) >= 1


def take_slice(x, args):
    """``x[args]``: slices, integers (Python or integer scalars), None and
    Ellipsis (Subtensor, with DimShuffle for None), a leading integer
    vector (AdvancedSubtensor1), or integer arrays over the leading dims
    (AdvancedSubtensor)."""
    from aesara_tpu_torch.tensor.elemwise import DimShuffle

    x = as_tensor_variable(x)
    args = args if isinstance(args, tuple) else (args,)
    if sum(a is Ellipsis for a in args) > 1:
        raise IndexError("an index can only have a single ellipsis")
    n_real = sum(a is not None and a is not Ellipsis for a in args)
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
    if len(stripped) > x.type.ndim:
        raise IndexError(f"too many indices for {x.type}")
    if any(_is_array_like(a) for a in stripped):
        while stripped and stripped[-1] == slice(None):
            stripped.pop()
        if not all(_is_array_like(a) for a in stripped):
            raise NotImplementedError(f"index {args}: integer arrays mixed with slices or integers are not "
                                      "ported")
        if len(stripped) == 1 and as_tensor_variable(stripped[0]).type.ndim == 1:
            res = AdvancedSubtensor1()(x, stripped[0])
        else:
            res = advanced_subtensor(x, *stripped)
    elif all(a == slice(None) for a in stripped):
        res = x
    else:
        idx_list, inputs = encode_indices(stripped)
        res = Subtensor(idx_list)(x, *inputs)
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
