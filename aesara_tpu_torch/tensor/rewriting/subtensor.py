"""Rewrites of the slice family (reference ``aesara_tpu/tensor/rewriting/
subtensor.py``, at its registrations):

- the JAX package's rewrites: merging slices of slices, slices of an
  ``Alloc``, of a ``Dot``, of a set, of a ``SpecifyShape``, negative-slice
  normalisation, useless incs and slices (``local_trim_trailing_full_slices``
  also takes x[:] to x), lifting a slice through a unary op, set-to-inc,
  joins of adjacent slices, and the advanced-index decompositions
  (``local_replace_AdvancedSubtensor``,
  ``local_AdvancedIncSubtensor_to_AdvancedIncSubtensor1``,
  ``local_adv_sub1_adv_inc_sub1``); several ask ``ShapeFeature``;
- ``local_affine_slice_to_dynamic`` (specialize): ``x[e:e+K]`` whose
  bounds are computed at run time but whose length K is provably constant
  becomes a ``DynamicSlice`` of length K: the minibatch idiom
  ``data[i*B:(i+1)*B]`` of the tutorials then has a static shape and a
  start the device computes;
- ``local_affine_inc_slice_to_dynamic`` (specialize): the same for
  ``set_subtensor``/``inc_subtensor`` of such a window;
- ``local_IncSubtensor_serialize`` (canonicalize): a sum of increments
  becomes one chain of increments on the sum of the rest;
- ``local_subtensor_make_vector`` (canonicalize): ``MakeVector(a, b)[1]``
  is ``b``, so a dim read as ``x.shape[i]`` becomes that dim.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import register_canonicalize, register_specialize, register_useless
from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.tensor.basic import (
    Alloc, Join, MakeVector, NotScalarConstantError, as_tensor_variable, cast, constant, get_scalar_constant_value,
)
from aesara_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
from aesara_tpu_torch.tensor.math import Dot
from aesara_tpu_torch.tensor.subtensor import (
    ARRAY, SYM, AdvancedIncSubtensor, AdvancedIncSubtensor1, AdvancedSubtensor, AdvancedSubtensor1,
    DynamicIncSubtensor, DynamicSlice, IncSubtensor, Subtensor, indices_from_subtensor,
)


def _static_slice(e):
    """slice with all-int/None parts, else None."""
    if isinstance(e, slice):
        parts = (e.start, e.stop, e.step)
        if any(p is SYM for p in parts):
            return None
        return e
    if e is SYM:
        return None
    return e


@node_rewriter([Subtensor])
def local_subtensor_merge(fgraph, node):
    """x[a:b][c:d] → x[combined] when both slices are static 1-dim
    non-negative forward slices (reference local_subtensor_merge)."""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Subtensor):
        return False
    if node.inputs[1:] or inner.inputs[1:]:
        return False  # only fully-static index lists
    out_idx = node.op.idx_list
    in_idx = inner.op.idx_list
    if len(out_idx) != 1 or len(in_idx) != 1:
        return False
    o, i = _static_slice(out_idx[0]), _static_slice(in_idx[0])
    if not isinstance(i, slice):
        return False
    # static dim: the composition of two slices is always one slice (an
    # arithmetic progression of an arithmetic progression) — compute it
    # EXACTLY with python range slicing, negative steps included
    # (reference merge_two_slices handles this symbolically)
    n0 = inner.inputs[0].type.shape[0]
    if n0 is not None and (isinstance(o, (int, slice))):
        try:
            r = range(n0)[i][o]
        except IndexError:
            return False  # runtime IndexError must be preserved
        if isinstance(r, int):
            res = Subtensor((r,))(inner.inputs[0])
        else:
            if len(r) == 0:
                new_sl = slice(0, 0, None)
            else:
                stop = r.stop
                if r.step < 0 and stop < 0:
                    stop = None  # slice(k, -1, -1) means something else
                new_sl = slice(r.start, stop, r.step if r.step != 1 else None)
            res = Subtensor((new_sl,))(inner.inputs[0])
        conv = node.outputs[0].type.convert_variable(res)
        if conv is None:
            return False
        copy_stack_trace(node.outputs[0], conv)
        return [conv]
    if i.step not in (None, 1):
        return False
    i_start = i.start or 0
    if i_start < 0 or (i.stop is not None and i.stop < 0):
        return False
    if isinstance(o, slice):
        if o.step not in (None, 1):
            return False
        o_start = o.start or 0
        if o_start < 0 or (o.stop is not None and o.stop < 0):
            return False
        new_start = i_start + o_start
        if o.stop is None:
            new_stop = i.stop
        else:
            new_stop = i_start + o.stop
            if i.stop is not None:
                new_stop = min(new_stop, i.stop)
        res = Subtensor((slice(new_start, new_stop, None),))(inner.inputs[0])
    elif isinstance(o, int):
        if o < 0:
            return False
        res = Subtensor((i_start + o,))(inner.inputs[0])
    else:
        return False
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_subtensor_merge)


@node_rewriter([Subtensor])
def local_subtensor_of_alloc(fgraph, node):
    """alloc(v, ...)[int-index on a broadcast dim] stays an alloc of the
    sliced shape — avoids materializing then slicing."""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Alloc):
        return False
    # only the simple full-int or basic forward-slice lead index
    idx = node.op.idx_list
    if len(idx) != 1 or not isinstance(idx[0], int) or idx[0] < 0:
        return False
    value = inner.inputs[0]
    shape_vars = inner.inputs[1:]
    if len(shape_vars) < 2:
        return False
    if value.type.ndim == len(shape_vars):
        # value has the full rank; dropping dim 0 only valid if broadcast
        if value.type.shape[0] != 1:
            return False
        from aesara_tpu_torch.tensor.basic import alloc

        res = alloc(value[0], *shape_vars[1:])
    else:
        from aesara_tpu_torch.tensor.basic import alloc

        res = alloc(value, *shape_vars[1:])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_specialize(local_subtensor_of_alloc)


def _normalize_idx_list(x, idx_list):
    """Replace unit-step slices with negative bounds that PROVABLY cover
    their whole static dim by ``slice(None)`` (e.g. ``x[-n:]`` with dim
    n).  Only covering slices normalize: tail windows like ``x[-k:]``
    (k < n) must keep their negative form — scan_save_mem's ring
    recognition matches it.  Returns (new_idx_list, changed)."""
    changed = False
    out = []
    for d, e in enumerate(idx_list):
        if (
            isinstance(e, slice)
            and e.step in (None, 1)
            and e.start is not SYM and e.stop is not SYM
            and (
                (isinstance(e.start, int) and e.start < 0)
                or (isinstance(e.stop, int) and e.stop < 0)
            )
        ):
            n = x.type.shape[d] if d < x.type.ndim else None
            if n is not None:
                lo, hi, _ = e.indices(n)
                if lo == 0 and hi >= n:
                    out.append(slice(None, None, None))
                    changed = True
                    continue
        out.append(e)
    return tuple(out), changed


@node_rewriter([Subtensor])
def local_normalize_negative_slices(fgraph, node):
    """``x[-n:]`` over a STATIC dim n → the covering ``x[:]`` so the
    useless-slice rules fold it (the grad of a full-tail window
    otherwise keeps a no-op Subtensor/IncSubtensor pair)."""
    x = node.inputs[0]
    new_idx, changed = _normalize_idx_list(x, node.op.idx_list)
    if not changed:
        return False
    res = Subtensor(new_idx)(x, *node.inputs[1:])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


@node_rewriter([IncSubtensor])
def local_normalize_negative_inc_slices(fgraph, node):
    """The scatter dual of local_normalize_negative_slices."""
    x, y = node.inputs[0], node.inputs[1]
    new_idx, changed = _normalize_idx_list(x, node.op.idx_list)
    if not changed:
        return False
    res = IncSubtensor(
        new_idx, set_instead_of_inc=node.op.set_instead_of_inc
    )(x, y, *node.inputs[2:])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_normalize_negative_slices)
register_canonicalize(local_normalize_negative_inc_slices)


@node_rewriter([IncSubtensor])
def local_useless_inc_subtensor(fgraph, node):
    """set_subtensor(x[full slice], y) → y (type-permitting).  Trailing
    unindexed dims are implicitly full, so indexing a PREFIX of dims
    with full slices also covers the whole tensor."""
    if not node.op.set_instead_of_inc:
        return False
    x, y = node.inputs[0], node.inputs[1]

    def _is_full(d, e):
        # full window in any spelling: [:], [0:], [::1], [0:n] with n
        # >= the static extent (same contract as local_useless_subtensor)
        if not isinstance(e, slice):
            return False
        if e.step not in (None, 1) or (e.start or 0) != 0:
            return False
        if e.stop is None:
            return True
        static = x.type.shape[d]
        return (
            e.stop is not SYM and static is not None and e.stop >= static
        )

    if not all(_is_full(d, e) for d, e in enumerate(node.op.idx_list)):
        return False
    if len(node.op.idx_list) > x.type.ndim:
        return False
    if y.type.ndim != x.type.ndim:
        return False
    conv = node.outputs[0].type.convert_variable(y)
    if conv is None:
        return False
    return [conv]


register_canonicalize(local_useless_inc_subtensor)
# also at specialize: local_inc_subtensor_of_zeros turns an inc into a set
# there, so the covering-set elimination runs again
register_specialize(local_useless_inc_subtensor)





def _same_index_vector(a, b) -> bool:
    """True when two index vectors are literally the same variable, or
    differ only by an int-widening Cast of the same variable (the sugar
    layer casts gather indices to int64, so ``x[i]`` twice can yield
    ``i`` and ``cast(i, int64)``)."""
    if a is b:
        return True

    # value-preserving (strictly widening) integer casts only: the
    # target must embed the source's whole range, else a truncating or
    # sign-wrapping cast yields DIFFERENT indices (int64→int32 and
    # uint32→int32 are not widening)
    widening = {
        "int64": ("int8", "int16", "int32", "uint8", "uint16", "uint32"),
        "int32": ("int8", "int16", "uint8", "uint16"),
    }

    def strip(v):
        n = v.owner
        if (
            n is not None
            and isinstance(n.op, Elemwise)
            and type(n.op.scalar_op).__name__ == "Cast"
            and n.inputs[0].type.dtype in widening.get(v.type.dtype, ())
        ):
            return n.inputs[0]
        return v

    return strip(a) is strip(b)


def _is_zeros(v) -> bool:
    """Graph-provably all-zero value: zero Constant, fill(x, 0), or
    Alloc(0, ...)."""
    from aesara_tpu_torch import scalar as aes
    from aesara_tpu_torch.tensor.basic import Alloc

    if isinstance(v, Constant):
        return bool(np.all(v.data == 0))
    node = v.owner
    if node is None:
        return False
    if isinstance(node.op, Elemwise) and isinstance(
        node.op.scalar_op, aes.ops.Second
    ):
        return _is_zeros(node.inputs[1])
    if isinstance(node.op, Alloc):
        return _is_zeros(node.inputs[0])
    if isinstance(node.op, DimShuffle):
        return _is_zeros(node.inputs[0])
    return False


@node_rewriter([Subtensor])
def local_trim_trailing_full_slices(fgraph, node):
    """Trim trailing full slices: x[a:b, :] → x[a:b]; x[:, :] → x
    (reference local_useless_slice; the full-slices-only case also
    lives in rewriting/basic.py)."""
    idx = list(node.op.idx_list)
    full = slice(None, None, None)
    n_trim = 0
    while idx and isinstance(idx[-1], slice) and idx[-1] == full:
        idx.pop()
        n_trim += 1
    if n_trim == 0:
        return False
    x = node.inputs[0]
    if not idx:
        res = x
    else:
        # symbolic index inputs are consumed left-to-right; trailing full
        # slices hold none, so the input list is unchanged
        res = Subtensor(tuple(idx))(x, *node.inputs[1:])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_trim_trailing_full_slices)


@node_rewriter([Subtensor])
def local_useless_subtensor(fgraph, node):
    """x[0:n] → x when n provably covers the dim (static shape or
    ShapeFeature; reference local_useless_subtensor)."""
    x = node.inputs[0]
    if node.inputs[1:]:
        return False
    sf = getattr(fgraph, "shape_feature", None)
    for d, e in enumerate(node.op.idx_list):
        if not isinstance(e, slice):
            return False
        if e.step not in (None, 1) or (e.start or 0) != 0:
            return False
        if e.stop is None:
            continue
        stop = e.stop
        if stop is SYM:
            return False
        static = x.type.shape[d]
        if static is not None and stop >= static:
            continue
        if sf is not None and x in sf.shape_of and sf.shape_of[x] is not None:
            dim = sf.shape_of[x][d]
            if isinstance(dim, Constant) and stop >= int(dim.data):
                continue
        return False
    conv = node.outputs[0].type.convert_variable(x)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_useless_subtensor)


@node_rewriter([Subtensor])
def local_subtensor_lift(fgraph, node):
    """f(x)[idx] → f(x[idx]) for single-client unary Elemwise — slice
    before computing (reference local_subtensor_lift)."""
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if (
        inner is None
        or not isinstance(inner.op, Elemwise)
        or len(inner.inputs) != 1
        or len(inner.outputs) != 1
        or len(fgraph.clients.get(inner_var, [])) > 1
    ):
        return False
    sliced = Subtensor(node.op.idx_list)(inner.inputs[0], *node.inputs[1:])
    res = inner.op(sliced)
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_subtensor_lift)


@node_rewriter([Subtensor])
def local_subtensor_of_expand_dims(fgraph, node):
    """DimShuffle-inserted leading broadcast dim indexed at 0 drops the
    dimshuffle: x.dimshuffle('x', ...)[0] → x.dimshuffle(...)."""
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not isinstance(inner.op, DimShuffle):
        return False
    order = inner.op.new_order
    idx = node.op.idx_list
    if not order or order[0] != "x" or not idx:
        return False
    e = idx[0]
    if not isinstance(e, int) or e not in (0, -1):
        return False
    x = inner.inputs[0]
    rest_order = tuple(order[1:])
    from aesara_tpu_torch.tensor.elemwise import DimShuffle as DS

    base = DS(x.type.ndim, rest_order)(x) if rest_order != tuple(
        range(x.type.ndim)
    ) else x
    rest_idx = tuple(idx[1:])
    res = Subtensor(rest_idx)(base, *node.inputs[1:]) if rest_idx else base
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_subtensor_of_expand_dims)


@node_rewriter([Subtensor])
def local_subtensor_of_dot(fgraph, node):
    """dot(a, b)[leading-idx] → dot(a[leading-idx], b) — slice the
    operand, not the product (reference local_subtensor_of_dot)."""
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if (
        inner is None
        or not isinstance(inner.op, Dot)
        or len(fgraph.clients.get(inner_var, [])) > 1
    ):
        return False
    idx = node.op.idx_list
    if len(idx) != 1:
        return False
    a, b = inner.inputs
    if a.type.ndim < 1:
        return False
    a_sliced = Subtensor((idx[0],))(a, *node.inputs[1:])
    from aesara_tpu_torch.tensor.math import dot as tdot

    res = tdot(a_sliced, b)
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_specialize(local_subtensor_of_dot)






@node_rewriter([Subtensor])
def local_subtensor_of_set_subtensor(fgraph, node):
    """set_subtensor(x[idx], y)[same static idx] → y (reference
    local_subtensor_inc_subtensor)."""
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not isinstance(inner.op, IncSubtensor):
        return False
    if not inner.op.set_instead_of_inc:
        return False
    if node.inputs[1:] or inner.inputs[2:]:
        return False  # static indices only
    if node.op.idx_list != inner.op.idx_list:
        return False
    y = inner.inputs[1]
    conv = node.outputs[0].type.convert_variable(y)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_subtensor_of_set_subtensor)


@node_rewriter([IncSubtensor])
def local_inc_subtensor_of_zeros(fgraph, node):
    """inc_subtensor(zeros[idx], y) → set_subtensor(zeros[idx], y)
    (reference local_incsubtensor_of_zeros) — XLA scatter-set beats
    scatter-add."""
    if node.op.set_instead_of_inc:
        return False
    x, y = node.inputs[0], node.inputs[1]
    if not _is_zeros(x):
        return False
    if y.type.dtype in ("bool",):
        return False
    res = IncSubtensor(node.op.idx_list, set_instead_of_inc=True)(
        x, y, *node.inputs[2:]
    )
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_specialize(local_inc_subtensor_of_zeros)


@node_rewriter([IncSubtensor])
def local_useless_inc_subtensor_of_zeros_increment(fgraph, node):
    """inc_subtensor(x[idx], zeros) → x (reference
    local_useless_inc_subtensor_alloc family)."""
    if node.op.set_instead_of_inc:
        return False
    x, y = node.inputs[0], node.inputs[1]
    if not _is_zeros(y):
        return False
    conv = node.outputs[0].type.convert_variable(x)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_useless_inc_subtensor_of_zeros_increment)


@node_rewriter([AdvancedSubtensor1])
def local_adv_sub1_of_adv_set_sub1(fgraph, node):
    """AdvancedSubtensor1(AdvancedSetSubtensor1(x, y, idx), idx) → y
    when y already has the gathered shape (reference
    local_adv_sub1_adv_inc_sub1).

    Guards: the index vector must be a PROVABLY
    unique, in-bounds constant (duplicate indices make the gather read
    last-write-wins values, not y's rows; out-of-bounds indices raise on
    the unrewritten path and must keep raising), and y must not have a
    static-1 dim that broadcast into the set window (returning y then
    narrows the runtime shape)."""
    inner_var, ilist = node.inputs
    inner = inner_var.owner
    if (
        inner is None
        or not isinstance(inner.op, AdvancedIncSubtensor1)
        or not inner.op.set_instead_of_inc
    ):
        return False
    x, y, inner_ilist = inner.inputs
    if not _same_index_vector(inner_ilist, ilist):
        return False
    if not isinstance(ilist, Constant):
        return False
    idx = np.asarray(ilist.data)
    if idx.ndim != 1:
        return False
    n0 = x.type.shape[0]
    if n0 is None:
        # in-bounds not provable: the rewrite would erase the runtime
        # IndexError the set op raises
        return False
    if np.any(idx < -n0) or np.any(idx >= n0):
        return False
    norm = np.where(idx < 0, idx + n0, idx)
    if len(np.unique(norm)) != len(norm):
        return False
    # y must carry the window shape itself: a static-1 y dim where the
    # window dim is larger broadcast at set time, so returning y would
    # shrink the result (same class as rewriting/math._keep_type)
    if y.type.ndim != node.outputs[0].type.ndim:
        return False
    if y.type.shape[0] == 1 and len(idx) != 1:
        return False
    for d in range(1, y.type.ndim):
        if y.type.shape[d] == 1 and x.type.shape[d] != 1:
            return False
    conv = node.outputs[0].type.convert_variable(y)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_specialize(local_adv_sub1_of_adv_set_sub1)


@node_rewriter([AdvancedSubtensor1])
def local_useless_adv_sub1_arange(fgraph, node):
    """x[arange(n)] → x when the constant index is exactly 0..n-1 over a
    static first dim."""
    x, ilist = node.inputs
    if not isinstance(ilist, Constant):
        return False
    n = x.type.shape[0]
    if n is None:
        return False
    data = np.asarray(ilist.data)
    if data.shape != (n,) or not np.array_equal(data, np.arange(n)):
        return False
    conv = node.outputs[0].type.convert_variable(x)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_useless_adv_sub1_arange)


@node_rewriter([Subtensor])
def local_subtensor_of_alloc_slice(fgraph, node):
    """alloc(scalar, s0, ...)[static a:b] → alloc(scalar, b-a, ...) —
    never materialize the unsliced buffer (reference
    local_subtensor_of_alloc)."""
    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not isinstance(inner.op, Alloc):
        return False
    if node.inputs[1:]:
        return False
    idx = node.op.idx_list
    if len(idx) != 1 or not isinstance(idx[0], slice):
        return False
    e = idx[0]
    if e.start is SYM or e.stop is SYM or e.step is SYM:
        return False
    if e.step not in (None, 1):
        return False
    start = e.start or 0
    if start < 0 or (e.stop is not None and e.stop < 0):
        return False
    value = inner.inputs[0]
    if value.type.ndim != 0:
        return False
    dims = inner.inputs[1:]
    d0 = dims[0]
    try:
        d0_val = int(get_scalar_constant_value(d0))
    except NotScalarConstantError:
        return False
    stop = d0_val if e.stop is None else min(e.stop, d0_val)
    new_len = max(stop - start, 0)
    from aesara_tpu_torch.tensor.basic import alloc

    res = alloc(value, constant(new_len, dtype="int64"), *dims[1:])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_specialize(local_subtensor_of_alloc_slice)


@node_rewriter([IncSubtensor])
def local_set_to_inc_subtensor(fgraph, node):
    """set_subtensor(x[idx], x[idx] + v) → inc_subtensor(x[idx], v)
    (reference local_set_to_inc_subtensor:842) — one scatter-add instead
    of gather + add + scatter-set."""
    if not node.op.set_instead_of_inc:
        return False
    x, y = node.inputs[0], node.inputs[1]
    yn = y.owner
    if yn is None or not isinstance(yn.op, Elemwise):
        return False
    if type(yn.op.scalar_op).__name__ != "Add" or len(yn.inputs) != 2:
        return False
    sym_idx = tuple(node.inputs[2:])
    for i, j in ((0, 1), (1, 0)):
        g = yn.inputs[i]
        gn = g.owner
        if (
            gn is not None
            and isinstance(gn.op, Subtensor)
            and gn.inputs[0] is x
            and gn.op.idx_list == node.op.idx_list
            and tuple(gn.inputs[1:]) == sym_idx
        ):
            v = yn.inputs[j]
            res = IncSubtensor(node.op.idx_list)(x, v, *node.inputs[2:])
            conv = node.outputs[0].type.convert_variable(res)
            if conv is None:
                return False
            copy_stack_trace(node.outputs[0], conv)
            return [conv]
    return False


register_canonicalize(local_set_to_inc_subtensor)


@node_rewriter([Join])
def local_join_subtensors(fgraph, node):
    """join(axis, x[..:k], x[k:..]) → one slice of x (reference
    local_join_subtensors:1651) — contiguous static slices of the same
    base concatenate back to the base."""
    axis_in, *parts = node.inputs
    if len(parts) != 2:
        return False
    from aesara_tpu_torch.tensor.basic import get_scalar_constant_value
    from aesara_tpu_torch.tensor.basic import NotScalarConstantError

    try:
        axis = int(get_scalar_constant_value(axis_in))
    except NotScalarConstantError:
        return False
    a, b = parts
    an, bn = a.owner, b.owner
    if not (
        an is not None and bn is not None
        and isinstance(an.op, Subtensor) and isinstance(bn.op, Subtensor)
        and an.inputs[0] is bn.inputs[0]
        and not an.inputs[1:] and not bn.inputs[1:]
    ):
        return False
    x = an.inputs[0]
    ia, ib = list(an.op.idx_list), list(bn.op.idx_list)
    if len(ia) != len(ib) or len(ia) <= axis:
        return False
    # all dims except `axis` must slice identically; `axis` must be
    # contiguous forward slices (a.stop == b.start, steps 1)
    for d, (ea, eb) in enumerate(zip(ia, ib)):
        sa, sb = _static_slice(ea), _static_slice(eb)
        if sa is None or sb is None:
            return False
        if not isinstance(sa, slice) or not isinstance(sb, slice):
            return False
        if d != axis:
            if sa != sb:
                return False
            continue
        if (sa.step not in (None, 1)) or (sb.step not in (None, 1)):
            return False
        if sa.stop is None or sb.start is None or sa.stop != sb.start:
            return False
        if (sa.stop is not None and sa.stop < 0) or (
            sb.start is not None and sb.start < 0
        ):
            return False
        merged = slice(sa.start, sb.stop, None)
    new_idx = list(ia)
    new_idx[axis] = merged
    res = Subtensor(tuple(new_idx))(x)
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_join_subtensors)


@node_rewriter([IncSubtensor])
def local_setsubtensor_of_constants(fgraph, node):
    """set_subtensor(const_x[static idx], const_y) folds to one constant
    (reference local_setsubtensor_of_constants:1354)."""
    from aesara_tpu_torch.graph.ir import Constant

    if not node.op.set_instead_of_inc or node.inputs[2:]:
        return False
    x, y = node.inputs[0], node.inputs[1]
    if not (isinstance(x, Constant) and isinstance(y, Constant)):
        return False
    idx = tuple(_static_slice(e) for e in node.op.idx_list)
    if any(e is None for e in idx):
        return False
    data = np.array(x.data, copy=True)
    try:
        data[idx if len(idx) > 1 else idx[0]] = y.data
    except Exception:
        return False
    res = constant(data.astype(node.outputs[0].type.dtype))
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_setsubtensor_of_constants)


@node_rewriter([Subtensor])
def local_subtensor_remove_broadcastable_index(fgraph, node):
    """x[0] / x[-1] on a static-1 dim → DimShuffle dropping the dim
    (reference local_subtensor_remove_broadcastable_index:546) — no
    gather, just a layout view XLA removes entirely."""
    x = node.inputs[0]
    if node.inputs[1:]:
        return False
    from aesara_tpu_torch.tensor.shape import Shape

    if x.owner is not None and isinstance(x.owner.op, Shape):
        return False  # Shape(v)[i] belongs to local_subtensor_of_shape
    idx = node.op.idx_list
    keep_order = []
    changed = False
    pos = 0
    for d, e in enumerate(idx):
        se = _static_slice(e)
        if se is None:
            return False
        if isinstance(se, slice):
            if se != slice(None, None, None):
                return False
            keep_order.append(d)
        else:
            if x.type.shape[d] == 1 and se in (0, -1):
                changed = True  # dropped broadcastable dim
            else:
                return False
    if not changed:
        return False
    keep_order += list(range(len(idx), x.type.ndim))
    res = DimShuffle(x.type.ndim, tuple(keep_order))(x)
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_subtensor_remove_broadcastable_index)





def _single_leading_int_vector(op, array_inputs):
    """True when idx_list is one 'array' entry (optionally followed by
    full slices) and the array is a 1-d non-bool integer vector."""
    idx = op.idx_list
    if not idx or idx[0] != ARRAY:
        return False
    if any(
        not (isinstance(e, slice) and e == slice(None, None, None))
        for e in idx[1:]
    ):
        return False
    if len(array_inputs) != 1:
        return False
    ilist = array_inputs[0]
    return ilist.type.ndim == 1 and ilist.type.dtype != "bool"


@node_rewriter([AdvancedSubtensor])
def local_replace_AdvancedSubtensor(fgraph, node):
    """x[int_vector] (general fancy form) → AdvancedSubtensor1 — the
    axis-0 gather the rest of the pack (adv_sub1-of-set, arange
    elimination) and the donation pass understand (reference
    local_replace_AdvancedSubtensor:211)."""
    x, *idx_inputs = node.inputs
    if not _single_leading_int_vector(node.op, idx_inputs):
        return False
    res = AdvancedSubtensor1()(x, idx_inputs[0])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_replace_AdvancedSubtensor)


@node_rewriter([AdvancedIncSubtensor])
def local_AdvancedIncSubtensor_to_AdvancedIncSubtensor1(fgraph, node):
    """inc/set_subtensor(x[int_vector], y) in the general fancy form →
    AdvancedIncSubtensor1 (reference :240).  ``ignore_duplicates`` inc
    has no Adv1 equivalent (Adv1 inc always accumulates duplicates), so
    that combination is left alone."""
    if node.op.ignore_duplicates and not node.op.set_instead_of_inc:
        return False
    x, y, *idx_inputs = node.inputs
    if not _single_leading_int_vector(node.op, idx_inputs):
        return False
    res = AdvancedIncSubtensor1(
        set_instead_of_inc=node.op.set_instead_of_inc
    )(x, y, idx_inputs[0])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_AdvancedIncSubtensor_to_AdvancedIncSubtensor1)


def _static_region_shape(node):
    """Static shape of the slice/gather region an inc/set writes to, or
    None when it can't be built."""
    x = node.inputs[0]
    try:
        if isinstance(node.op, IncSubtensor):
            probe = Subtensor(node.op.idx_list).make_node(
                x, *node.inputs[2:]
            )
        elif isinstance(node.op, AdvancedIncSubtensor1):
            return (node.inputs[2].type.shape[0],) + tuple(x.type.shape[1:])
        else:
            probe = AdvancedSubtensor(node.op.idx_list).make_node(
                x, *node.inputs[2:]
            )
        return tuple(probe.outputs[0].type.shape)
    except Exception:
        return None


@node_rewriter([IncSubtensor, AdvancedIncSubtensor1, AdvancedIncSubtensor])
def local_useless_inc_subtensor_alloc(fgraph, node):
    """inc/set_subtensor(x[idx], alloc(y, ...)) → inc/set_subtensor(
    x[idx], y): the scatter broadcasts y itself, so materializing the
    broadcast buffer first is a pure waste of memory traffic (reference
    local_useless_inc_subtensor_alloc:1457).

    Only fires when the alloc's static shape provably equals the target
    region's — otherwise dropping the Alloc would also drop the runtime
    shape error the original graph raises (the reference guards with
    ``same_shape``/Assert for the same reason)."""
    y = node.inputs[1]
    yn = y.owner
    if yn is None or not isinstance(yn.op, Alloc):
        return False
    v = yn.inputs[0]
    region = _static_region_shape(node)
    if region is None:
        return False
    if len(region) != y.type.ndim:
        return False
    for rd, yd in zip(region, y.type.shape):
        if rd is None or yd is None or rd != yd:
            return False
    res = node.op(node.inputs[0], v, *node.inputs[2:])
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_useless_inc_subtensor_alloc)
register_specialize(local_useless_inc_subtensor_alloc)






@node_rewriter([Subtensor])
def local_subtensor_SpecifyShape_lift(fgraph, node):
    """SpecifyShape(x, ...)[static ints / full slices] → SpecifyShape of
    the sliced x with the surviving dim specs — indexing escapes the
    assertion so the rest of the pack can see through it (reference
    local_subtensor_SpecifyShape_lift:1617)."""
    from aesara_tpu_torch.tensor.shape import SpecifyShape, specify_shape

    inner_var = node.inputs[0]
    inner = inner_var.owner
    if inner is None or not isinstance(inner.op, SpecifyShape):
        return False
    if node.inputs[1:]:
        return False
    idx = node.op.idx_list
    full = slice(None, None, None)
    for e in idx:
        se = _static_slice(e)
        if se is None:
            return False
        if isinstance(se, slice) and se != full:
            return False
    x = inner.inputs[0]
    spec_vars = inner.inputs[1:]

    def spec_entry(d):
        sv = spec_vars[d]
        if isinstance(sv, Constant) and int(np.asarray(sv.data)) == -1:
            return None
        return sv

    kept = [
        spec_entry(d) for d, e in enumerate(idx) if isinstance(e, slice)
    ] + [spec_entry(d) for d in range(len(idx), x.type.ndim)]
    sliced = Subtensor(idx)(x)
    res = specify_shape(sliced, kept) if any(
        k is not None for k in kept
    ) else sliced
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_subtensor_SpecifyShape_lift)



@node_rewriter([Subtensor])
def local_subtensor_inc_subtensor(fgraph, node):
    """``set_subtensor(x[idx], y)[idx] → y`` — reading back exactly the
    slice just written returns the written value (reference
    ``local_subtensor_inc_subtensor``, subtensor.py:663)."""
    from aesara_tpu_torch.tensor.basic import alloc, cast as t_cast

    inner_var = node.inputs[0]
    inner = inner_var.owner
    if (
        inner is None
        or not isinstance(inner.op, IncSubtensor)
        or not inner.op.set_instead_of_inc
    ):
        return False
    if tuple(inner.op.idx_list) != tuple(node.op.idx_list):
        return False
    if list(inner.inputs[2:]) != list(node.inputs[1:]):
        return False
    out = node.outputs[0]
    y = inner.inputs[1]
    if y.type.dtype != out.type.dtype:
        y = t_cast(y, out.type.dtype)
    conv = out.type.convert_variable(y)
    if conv is not None:
        copy_stack_trace(out, conv)
        return [conv]
    if y.type.ndim == out.type.ndim:
        # only 1-ness differs: y was broadcast into the slice — realize it
        sub = node.op(inner.inputs[0], *node.inputs[1:])
        res = alloc(y, *[sub.shape[i] for i in range(out.type.ndim)])
        conv = out.type.convert_variable(res)
        if conv is None:
            return False
        copy_stack_trace(out, conv)
        return [conv]
    return False


register_useless(local_subtensor_inc_subtensor)
register_specialize(local_subtensor_inc_subtensor)


@node_rewriter([AdvancedSubtensor1])
def local_adv_sub1_adv_inc_sub1(fgraph, node):
    """``inc_subtensor(x[ilist], y)[ilist] → x[ilist] + y`` when the
    gather indices are constant and unique (duplicates accumulate, so
    the identity only holds index-wise-unique; reference
    ``local_adv_sub1_adv_inc_sub1``).  The set case is handled by
    ``local_adv_sub1_of_adv_set_sub1``."""
    import aesara_tpu_torch.tensor.math as tm
    from aesara_tpu_torch.graph.ir import Constant

    inner_var, ilist = node.inputs
    inner = inner_var.owner
    if (
        inner is None
        or not isinstance(inner.op, AdvancedIncSubtensor1)
        or inner.op.set_instead_of_inc
    ):
        return False
    x, y, inner_ilist = inner.inputs
    if not _same_index_vector(inner_ilist, ilist):
        return False
    if not isinstance(ilist, Constant):
        return False
    idx = np.asarray(ilist.data)
    if idx.ndim != 1:
        return False
    # uniqueness must hold AFTER negative-index normalization (-1 and
    # n-1 alias the same row); normalize with the static dim, else only
    # accept all-nonnegative index sets ([4, -1] on a length-5 axis
    # passes a raw np.unique check and would drop the accumulated
    # increment)
    n0 = x.type.shape[0]
    if np.any(idx < 0):
        if n0 is None:
            return False
        idx = np.where(idx < 0, idx + n0, idx)
    if len(np.unique(idx)) != len(idx):
        return False
    res = tm.add(AdvancedSubtensor1()(x, ilist), y)
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_specialize(local_adv_sub1_adv_inc_sub1)


def _affine_parts(v, depth=0):
    """({id: (variable, coefficient)}, constant) of an integer scalar
    graph of constants, variables, add, sub, neg, mul by constants and
    casts, or None when it is not affine in that form."""
    if depth > 12:
        return None
    if isinstance(v, Constant):
        data = np.asarray(v.data)
        return None if data.size != 1 else ({}, int(data))
    node = v.owner
    if node is None or not isinstance(node.op, Elemwise):
        return {id(v): (v, 1)}, 0
    sop = node.op.scalar_op

    def combine(parts, signs):
        coeffs, const = {}, 0
        for p, sign in zip(parts, signs):
            if p is None:
                return None
            for k, (var, c) in p[0].items():
                coeffs[k] = (var, coeffs.get(k, (var, 0))[1] + sign * c)
            const += sign * p[1]
        return coeffs, const

    if isinstance(sop, aes.Add):
        return combine([_affine_parts(i, depth + 1) for i in node.inputs], [1] * len(node.inputs))
    if isinstance(sop, aes.Sub):
        return combine([_affine_parts(i, depth + 1) for i in node.inputs], [1, -1])
    if isinstance(sop, aes.Neg):
        return combine([_affine_parts(node.inputs[0], depth + 1)], [-1])
    if isinstance(sop, aes.Mul):
        factor, sym = 1, None
        for i in node.inputs:
            if isinstance(i, Constant) and np.asarray(i.data).size == 1:
                factor *= int(np.asarray(i.data))
            elif sym is None:
                sym = i
            else:
                return None
        if sym is None:
            return {}, factor
        return combine([_affine_parts(sym, depth + 1)], [factor])
    if isinstance(sop, aes.Cast):
        return _affine_parts(node.inputs[0], depth + 1)
    return {id(v): (v, 1)}, 0


def _static_difference(stop, start):
    """stop - start as an int where it is provably constant, else None."""
    pa, pb = _affine_parts(stop), _affine_parts(start)
    if pa is None or pb is None:
        return None
    (ca, ka), (cb, kb) = pa, pb
    coeffs = {k: c for k, (_, c) in ca.items()}
    for k, (_, c) in cb.items():
        coeffs[k] = coeffs.get(k, 0) - c
    return None if any(coeffs.values()) else ka - kb


def _windows(x, idx):
    """(lengths, starts) of ``DynamicSlice`` for an index of slices only
    where every slice with a run-time bound has step 1 and a constant
    positive length that fits x's static dim, and every other slice keeps
    its axis whole; else None."""
    lengths, starts = [], []
    for d, e in enumerate(idx):
        if not isinstance(e, slice) or e.step not in (None, 1):
            return None
        start = e.start if e.start is not None else 0
        if isinstance(start, (int, np.integer)) and (e.stop is None or isinstance(e.stop, (int, np.integer))):
            if start == 0 and e.stop is None:
                lengths.append(None)
                continue
            return None
        if e.stop is None:
            return None
        start_v, stop_v = as_tensor_variable(start), as_tensor_variable(e.stop)
        k = _static_difference(stop_v, start_v)
        dim = x.type.shape[d]
        if k is None or k <= 0 or (dim is not None and k > dim):
            return None
        lengths.append(k)
        starts.append(start_v)
    if not starts:
        return None
    while lengths[-1] is None:
        lengths.pop()
    return lengths, starts


@node_rewriter([Subtensor])
def local_affine_slice_to_dynamic(fgraph, node):
    """x[e:e+K, ...] with run-time bounds and a constant K → DynamicSlice"""
    if not node.inputs[1:]:
        return False
    win = _windows(node.inputs[0], indices_from_subtensor(node.inputs[1:], node.op.idx_list))
    if win is None:
        return False
    res = DynamicSlice(win[0])(node.inputs[0], *win[1])
    return [copy_stack_trace(node.outputs[0], res)] if res.type.dtype == node.outputs[0].type.dtype else False


@node_rewriter([IncSubtensor])
def local_affine_inc_slice_to_dynamic(fgraph, node):
    """set/inc_subtensor over such a window → DynamicIncSubtensor"""
    x, y = node.inputs[:2]
    if not node.inputs[2:] or y.type.ndim != x.type.ndim:
        return False
    win = _windows(x, indices_from_subtensor(node.inputs[2:], node.op.idx_list))
    if win is None:
        return False
    lengths, starts = win
    if any(n is not None and y.type.shape[d] not in (n, None) for d, n in enumerate(lengths)):
        return False
    res = DynamicIncSubtensor(lengths, set_instead_of_inc=node.op.set_instead_of_inc)(x, y, *starts)
    return [copy_stack_trace(node.outputs[0], res)] if res.type.dtype == node.outputs[0].type.dtype else False


@node_rewriter([Subtensor])
def local_subtensor_make_vector(fgraph, node):
    """MakeVector(a, b, c)[1] → b; a constant slice selects a sub-vector."""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, MakeVector):
        return False
    idx = node.op.idx_list
    if len(idx) != 1 or node.inputs[1:]:
        return False
    e, elems, out = idx[0], inner.inputs, node.outputs[0]
    if isinstance(e, int):
        i = e + len(elems) if e < 0 else e
        if not 0 <= i < len(elems):
            return False
        res = elems[i]
        if res.type.dtype != out.type.dtype:
            res = cast(res, out.type.dtype)
    elif isinstance(e, slice):
        picked = elems[e]
        if list(picked) == list(elems):
            return False    # the identity slice would make the same node again
        res = MakeVector(inner.op.dtype)(*picked) if picked else constant(np.zeros((0,), dtype=inner.op.dtype))
    else:
        return False
    if res.type.ndim != out.type.ndim or any(
            a is not None and b is not None and a != b for a, b in zip(res.type.shape, out.type.shape)):
        return False
    return [copy_stack_trace(out, res)]


register_canonicalize(local_subtensor_make_vector)
register_specialize(local_affine_slice_to_dynamic)
register_specialize(local_affine_inc_slice_to_dynamic)


@node_rewriter([Elemwise])
def local_IncSubtensor_serialize(fgraph, node):
    """add(p, inc_subtensor(b1, c), inc_subtensor(b2, d)) →
    inc_subtensor(inc_subtensor(add(p, b1, b2), c), d): a gradient's
    zeros-based increments chain onto one accumulator (canonicalize,
    ``aesara_tpu/tensor/rewriting/subtensor.py:1028``).  An increment the
    add broadcasts stays where it is."""
    if not isinstance(node.op.scalar_op, aes.Add) or len(node.inputs) < 2:
        return False
    o_type = node.outputs[0].type

    def movable(i):
        return (i.owner is not None and isinstance(i.owner.op, (IncSubtensor, AdvancedIncSubtensor1,
                                                                AdvancedIncSubtensor))
                and not i.owner.op.set_instead_of_inc and i.type.dtype == o_type.dtype
                and i.type.shape == o_type.shape and len(fgraph.clients.get(i, [])) == 1)

    moved = [i for i in node.inputs if movable(i)]
    if not moved:
        return False
    terms = [i for i in node.inputs if i not in moved] + [i.owner.inputs[0] for i in moved]
    acc = terms[0] if len(terms) == 1 else Elemwise(node.op.scalar_op)(*terms)
    if acc.type.dtype != o_type.dtype:
        acc = cast(acc, o_type.dtype)
    for i in moved:
        acc = i.owner.op(acc, *i.owner.inputs[1:])
    conv = o_type.convert_variable(acc)
    return False if conv is None else [copy_stack_trace(node.outputs[0], conv)]


register_canonicalize(local_IncSubtensor_serialize)
