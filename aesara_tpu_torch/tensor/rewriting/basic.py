"""Canonicalization rewrites the encoder's forward and train step need
(the counterparts of rules in ``aesara_tpu/tensor/rewriting/basic.py``,
``math.py`` and ``shape.py``):

- ``constant_folding``: nodes over constants become constants.
- ``local_useless_dimshuffle``: an identity DimShuffle goes;
  ``local_dimshuffle_lift`` (canonicalize and specialize): a DimShuffle
  of a DimShuffle is one.
- the shape rewrites (``ShapeFeature``, ``local_track_shape_i``,
  ``local_shape_to_shape_i``, ...) are in ``shape.py``.
- ``local_mul_one`` and ``local_flatten_add_mul``: the neutral-element and
  flattening part of the algebraic canonicalizer.
- ``local_reshape_chain``: a reshape of a reshape is one reshape;
  ``local_useless_reshape``: a reshape to the input's own shape goes.
- ``local_reduce_broadcastable``: summing a static-1 axis is dropping it
  (the gradients of broadcast operands build such sums).
- ``local_fill_sink`` and ``local_useless_fill``: the ``fill`` nodes of
  gradients move below the elemwise ops that read them, and go once
  their value has the output's shape; ``local_fill_to_alloc``
  (specialize): a fill that stays becomes an ``Alloc`` of the template's
  shape.
- ``local_useless_split`` (useless, canonicalize and specialize): a
  split into one piece is its input, behind an ``Assert`` that the size
  is the axis length unless that is known statically.
- ``local_remove_useless_assert`` (canonicalize): constant-true
  conditions go, and an assert left with none is its input;
  ``local_remove_all_assert`` strips every assert, under the tag
  "unsafe" only, so never by default.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import canonicalize, register_canonicalize, register_specialize, register_useless
from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from aesara_tpu_torch.graph.utils import MethodNotDefined
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.tensor.basic import (
    NotScalarConstantError, Split, alloc, cast, constant, fill, get_scalar_constant_value,
)
from aesara_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
from aesara_tpu_torch.tensor.math import Sum, add, mul
from aesara_tpu_torch.tensor.shape import Reshape, Shape, shape_tuple


def _const_val(var):
    """The value of a size-1 Constant, else None."""
    if isinstance(var, Constant) and np.asarray(var.data).size == 1:
        return np.asarray(var.data).reshape(())
    return None


def _keep_type(out_var, res):
    """``res`` converted to ``out_var``'s type, or None when that could
    narrow the runtime shape (a static-1 dim where the output's is not)."""
    if res.type.dtype != out_var.type.dtype:
        res = cast(res, out_var.type.dtype)
    if res.type.ndim != out_var.type.ndim:
        return None
    if any(sr == 1 and so != 1 for so, sr in zip(out_var.type.shape, res.type.shape)):
        return None
    return out_var.type.convert_variable(res)


@node_rewriter(None)
def constant_folding(fgraph, node):
    """Evaluate nodes whose inputs are all constants."""
    if not node.inputs or not all(isinstance(i, Constant) for i in node.inputs):
        return False
    if not node.op.do_constant_folding(fgraph, node):
        return False
    storage = [[None] for _ in node.outputs]
    try:
        node.op.perform(node, [i.data for i in node.inputs], storage)
    except (MethodNotDefined, NotImplementedError):
        return False
    results = []
    for s, o in zip(storage, node.outputs):
        const = constant(s[0], dtype=o.type.dtype)
        results.append(copy_stack_trace(o, const))
    return results


@node_rewriter([DimShuffle])
def local_useless_dimshuffle(fgraph, node):
    """DimShuffle that changes nothing → x"""
    if node.op.new_order == tuple(range(node.op.input_ndim)):
        return [node.inputs[0]]
    return False


@node_rewriter([DimShuffle])
def local_dimshuffle_lift(fgraph, node):
    """DimShuffle(DimShuffle(x)) → one DimShuffle of x"""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, DimShuffle):
        return False
    order = tuple("x" if d == "x" else inner.op.new_order[d] for d in node.op.new_order)
    res = DimShuffle(inner.inputs[0].type.ndim, order)(inner.inputs[0])
    res = _keep_type(node.outputs[0], res)
    return False if res is None else [copy_stack_trace(node.outputs[0], res)]


@node_rewriter([Sum])
def local_reduce_broadcastable(fgraph, node):
    """A sum over static-1 axes drops them: Sum(x) over axes that are
    all 1 → DimShuffle(x); otherwise the sum runs over the rest."""
    x = node.inputs[0]
    axes = node.op._normalized_axes(x.type.ndim)
    ones = [d for d in axes if x.type.shape[d] == 1]
    if not ones:
        return False
    order = [d for d in range(x.type.ndim) if d not in ones]
    res = DimShuffle(x.type.ndim, tuple(order))(x)
    rest = [order.index(d) for d in axes if d not in ones]
    if rest:
        res = Sum(axis=rest, dtype=node.op.dtype, acc_dtype=node.op.acc_dtype)(res)
    res = _keep_type(node.outputs[0], res)
    return False if res is None else [copy_stack_trace(node.outputs[0], res)]


def _is_fill(var) -> bool:
    return (var.owner is not None and isinstance(var.owner.op, Elemwise)
            and isinstance(var.owner.op.scalar_op, aes.Second))


@node_rewriter([Elemwise])
def local_fill_sink(fgraph, node):
    """f(fill(a, b), c) → fill(a, f(b, c)): the fill moves below the op
    that reads it, toward the point where it is useless."""
    if isinstance(node.op.scalar_op, aes.Second) or len(node.outputs) != 1:
        return False
    if not any(_is_fill(i) for i in node.inputs):
        return False
    templates = [i.owner.inputs[0] for i in node.inputs if _is_fill(i)]
    res = node.op(*[i.owner.inputs[1] if _is_fill(i) else i for i in node.inputs])
    for t in templates:
        res = fill(t, res)
    res = _keep_type(node.outputs[0], res)
    return False if res is None else [copy_stack_trace(node.outputs[0], res)]


@node_rewriter([Elemwise])
def local_useless_fill(fgraph, node):
    """fill(t, v) → v when v already has the output's static shape"""
    if not isinstance(node.op.scalar_op, aes.Second):
        return False
    v, out = node.inputs[1], node.outputs[0]
    if v.type.dtype == out.type.dtype and v.type.shape == out.type.shape:
        return [v]
    return False


@node_rewriter([Elemwise])
def local_mul_one(fgraph, node):
    """x * 1 → x"""
    if not isinstance(node.op.scalar_op, aes.Mul):
        return False
    rest = [i for i in node.inputs if _const_val(i) is None or _const_val(i) != 1]
    if len(rest) == len(node.inputs) or not rest:
        return False
    res = rest[0] if len(rest) == 1 else mul(*rest)
    res = _keep_type(node.outputs[0], res)
    return False if res is None else [copy_stack_trace(node.outputs[0], res)]


@node_rewriter([Elemwise])
def local_flatten_add_mul(fgraph, node):
    """Flatten nested single-client add/mul chains into one variadic node
    and fold their constants."""
    sop = node.op.scalar_op
    if not isinstance(sop, (aes.Add, aes.Mul)):
        return False
    is_add = isinstance(sop, aes.Add)
    flat, changed = [], False
    for inp in node.inputs:
        inner = inp.owner
        if (inner is not None and isinstance(inner.op, Elemwise)
                and type(inner.op.scalar_op) is type(sop)
                and len(fgraph.clients.get(inp, [])) == 1):
            flat.extend(inner.inputs)
            changed = True
        else:
            flat.append(inp)
    consts = [_const_val(v) for v in flat if _const_val(v) is not None]
    rest = [v for v in flat if _const_val(v) is None]
    if len(consts) > 1:
        changed = True
    if not changed or not rest:
        return False
    if consts:
        total = consts[0]
        for c in consts[1:]:
            total = total + c if is_add else total * c
        if not np.all(total == (0 if is_add else 1)):
            rest.append(constant(total[()]))
    res = rest[0] if len(rest) == 1 else (add(*rest) if is_add else mul(*rest))
    res = _keep_type(node.outputs[0], res)
    return False if res is None else [copy_stack_trace(node.outputs[0], res)]


@node_rewriter([Reshape])
def local_reshape_chain(fgraph, node):
    """Reshape(Reshape(x, s1), s2) → Reshape(x, s2)"""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Reshape):
        return False
    res = node.op(inner.inputs[0], node.inputs[1])
    res = _keep_type(node.outputs[0], res)
    return False if res is None else [copy_stack_trace(node.outputs[0], res)]


@node_rewriter([Reshape])
def local_useless_reshape(fgraph, node):
    """Reshape(x, shape(x)), or to x's own full static shape → x"""
    x, shp = node.inputs
    out = node.outputs[0]
    if x.type.ndim != out.type.ndim:
        return False
    same_static = None not in x.type.shape and x.type.shape == out.type.shape
    own_shape = shp.owner is not None and isinstance(shp.owner.op, Shape) and shp.owner.inputs[0] is x
    if not (same_static or own_shape):
        return False
    res = _keep_type(out, x)
    return False if res is None else [res]


for _rw in (constant_folding, local_useless_dimshuffle, local_dimshuffle_lift, local_mul_one, local_flatten_add_mul,
            local_reshape_chain, local_useless_reshape, local_reduce_broadcastable,
            local_fill_sink, local_useless_fill):
    register_canonicalize(_rw)
# as in the JAX package, also after the scan rewrites build DimShuffles
register_specialize(local_dimshuffle_lift)


@node_rewriter([Elemwise])
def local_fill_to_alloc(fgraph, node):
    """fill(template, v) that survives canonicalize → alloc(v, *shape of
    the template) (specialize, ``aesara_tpu/tensor/rewriting/basic.py:874``),
    where v does not broadcast the template."""
    if not isinstance(node.op.scalar_op, aes.Second):
        return False
    template, v = node.inputs
    out = node.outputs[0]
    if (v.type.ndim > template.type.ndim or template.type.ndim != out.type.ndim
            or any((t == 1) != (o == 1) for t, o in zip(template.type.shape, out.type.shape))):
        return False
    if v.type.dtype != out.type.dtype:
        v = cast(v, out.type.dtype)
    conv = out.type.convert_variable(alloc(v, *shape_tuple(template)))
    return False if conv is None else [copy_stack_trace(out, conv)]


register_specialize(local_fill_to_alloc)


@node_rewriter([Split])
def local_useless_split(fgraph, node):
    """A split into one piece is its input, behind the run-time check the
    split itself would make (the sizes must sum to the axis length), unless
    the static shape proves it."""
    from aesara_tpu_torch.raise_op import Assert
    from aesara_tpu_torch.tensor.math import eq
    from aesara_tpu_torch.tensor.shape import shape, specify_shape

    if node.op.len_splits != 1:
        return False
    x, axis, splits = node.inputs
    res = x
    try:
        ax = int(get_scalar_constant_value(axis))
        sp0 = get_scalar_constant_value(splits)
        static_ok = x.type.shape[ax if ax >= 0 else ax + x.type.ndim] == int(sp0)
    except NotScalarConstantError:
        static_ok = False
    if not static_ok:
        check = Assert("Split{1}: split size must equal the axis length")
        res = check(x, eq(shape(x)[axis], splits[0]))
        copy_stack_trace(node.outputs[0], res)
    if not node.outputs[0].type.is_super(res.type):
        # the piece's static length is the split size's (the JAX package's
        # convert_variable builds the same SpecifyShape)
        res = specify_shape(res, node.outputs[0].type.shape)
    return {node.outputs[0]: res}


register_useless(local_useless_split)
register_canonicalize(local_useless_split)
register_specialize(local_useless_split)


@node_rewriter(None)
def local_remove_useless_assert(fgraph, node):
    """Constant-true conditions go; an assert with none left is its input.
    A constant-false one stays, to raise when the function is called."""
    from aesara_tpu_torch.raise_op import CheckAndRaise

    if not isinstance(node.op, CheckAndRaise):
        return False
    value, *conds = node.inputs
    kept = []
    for c in conds:
        if isinstance(c, Constant):
            if not bool(np.asarray(c.data)):
                return False
            continue
        kept.append(c)
    if len(kept) == len(conds):
        return False
    res = node.op(value, *kept) if kept else value
    conv = node.outputs[0].type.convert_variable(res)
    if conv is None:
        return False
    copy_stack_trace(node.outputs[0], conv)
    return [conv]


register_canonicalize(local_remove_useless_assert)


@node_rewriter(None)
def local_remove_all_assert(fgraph, node):
    """Every assert is its input: unsafe, so only under the tag "unsafe"."""
    from aesara_tpu_torch.raise_op import CheckAndRaise

    if not isinstance(node.op, CheckAndRaise):
        return False
    conv = node.outputs[0].type.convert_variable(node.inputs[0])
    return False if conv is None else [conv]


canonicalize.register("local_remove_all_assert", local_remove_all_assert, "unsafe")
