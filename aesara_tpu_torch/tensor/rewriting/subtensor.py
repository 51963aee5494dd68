"""Rewrites of the slice family (reference ``aesara_tpu/tensor/rewriting/
subtensor.py:1334,1413`` and ``basic.py:217``):

- ``local_useless_slice`` (canonicalize): x[:] (full slices only) is x;
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
  is ``b``, so a dim read as ``x.shape[i]`` becomes that dim
  (``aesara_tpu/tensor/rewriting/subtensor.py:483``).
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import register_canonicalize, register_specialize
from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.tensor.basic import MakeVector, as_tensor_variable, cast, constant
from aesara_tpu_torch.tensor.elemwise import Elemwise
from aesara_tpu_torch.tensor.subtensor import (
    AdvancedIncSubtensor, AdvancedIncSubtensor1, DynamicIncSubtensor, DynamicSlice, IncSubtensor, Subtensor,
    indices_from_subtensor,
)


@node_rewriter([Subtensor])
def local_useless_slice(fgraph, node):
    """x[:] (full slices only) → x"""
    if all(isinstance(e, slice) and e == slice(None) for e in node.op.idx_list):
        return [node.inputs[0]]
    return False


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


register_canonicalize(local_useless_slice)
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
