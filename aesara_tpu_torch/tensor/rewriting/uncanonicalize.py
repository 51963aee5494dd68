"""The uncanonicalize pack (the counterpart of ``aesara_tpu/tensor/
rewriting/uncanonicalize.py``, optdb position 3, after specialize): it
undoes canonical forms that are good for matching but cost work when run.

- ``local_max_to_min``: ``neg(max(neg(x)))`` is ``min(x)``;
- ``local_alloc_dimshuffle_lift`` and ``local_dimshuffle_alloc``: a
  DimShuffle of an Alloc of a 0-d value is an Alloc in the final layout
  (Scan's gradient builds one where it pads an initial state);
- ``local_reshape_dimshuffle``: a Reshape of a DimShuffle that only
  inserts broadcast dims reshapes the DimShuffle's input.
"""

from __future__ import annotations

from aesara_tpu_torch.compile.mode import register_uncanonicalize
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import Alloc, constant
from aesara_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
from aesara_tpu_torch.tensor.shape import Reshape


__all__ = ["local_max_to_min", "local_alloc_dimshuffle_lift", "local_reshape_dimshuffle", "local_dimshuffle_alloc"]


def _is_neg(node) -> bool:
    return node is not None and isinstance(node.op, Elemwise) and isinstance(node.op.scalar_op, aes.Neg)


@node_rewriter([Elemwise])
def local_max_to_min(fgraph, node):
    """``neg(max(neg(x)))`` → ``min(x)``"""
    if not _is_neg(node):
        return False
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, tm.Max) or not _is_neg(inner.inputs[0].owner):
        return False
    res = tm.min(inner.inputs[0].owner.inputs[0], axis=inner.op.axis)
    return [copy_stack_trace(node.outputs[0], res)]


def _alloc_in_layout(node):
    """Alloc(v, permuted shape) for DimShuffle(Alloc(v, shape)) with a 0-d
    v, or None."""
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Alloc):
        return None
    value, *shape = inner.inputs
    if value.type.ndim != 0:
        return None
    one = constant(1, dtype="int64")
    return Alloc()(value, *[one if d == "x" else shape[d] for d in node.op.new_order])


@node_rewriter([DimShuffle])
def local_alloc_dimshuffle_lift(fgraph, node):
    """``DimShuffle(Alloc(scalar, shp))`` → ``Alloc(scalar, permuted shp)``"""
    res = _alloc_in_layout(node)
    return False if res is None else [copy_stack_trace(node.outputs[0], res)]


@node_rewriter([Reshape])
def local_reshape_dimshuffle(fgraph, node):
    """``Reshape(DimShuffle(x))`` → ``Reshape(x)`` where the DimShuffle only
    inserts broadcast dims."""
    ds = node.inputs[0].owner
    if ds is None or not isinstance(ds.op, DimShuffle):
        return False
    kept = [o for o in ds.op.new_order if o != "x"]
    if kept != sorted(kept) or len(kept) != ds.inputs[0].type.ndim:
        return False
    res = node.op(ds.inputs[0], node.inputs[1])
    return [copy_stack_trace(node.outputs[0], res)]


@node_rewriter([DimShuffle])
def local_dimshuffle_alloc(fgraph, node):
    """DimShuffle(Alloc(v, shp)) → Alloc(v, permuted shp) for a 0-d v,
    where the types agree."""
    res = _alloc_in_layout(node)
    if res is None:
        return False
    conv = node.outputs[0].type.convert_variable(res)
    return False if conv is None else [copy_stack_trace(node.outputs[0], conv)]


register_uncanonicalize(local_max_to_min)
register_uncanonicalize(local_alloc_dimshuffle_lift)
register_uncanonicalize(local_reshape_dimshuffle)
register_uncanonicalize(local_dimshuffle_alloc)
