"""Softmax recognition (reference ``aesara_tpu/tensor/rewriting/special.py``):

- ``local_softmax_graph`` (specialize, ``:53``): exp(x) / sum(exp(x),
  axis, keepdims) becomes ``Softmax(axis)``, one K4 launch in place of an
  exp, a sum and a division;
- ``local_logsoftmax`` (stabilize and specialize, ``:75``): log(Softmax(x))
  becomes ``LogSoftmax``.
"""

from __future__ import annotations

from aesara_tpu_torch.compile.mode import register_specialize, register_stabilize
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
from aesara_tpu_torch.tensor.math import Sum
from aesara_tpu_torch.tensor.special import LogSoftmax, Softmax


def _is_ew(node, cls):
    return node is not None and isinstance(node.op, Elemwise) and isinstance(node.op.scalar_op, cls)


def _match_softmax(var):
    """(x, axis) of exp(x) / sum(exp(x), axis, keepdims), or None."""
    node = var.owner
    if not _is_ew(node, aes.TrueDiv):
        return None
    num, den = node.inputs
    if not _is_ew(num.owner, aes.Exp):
        return None
    x = num.owner.inputs[0]
    d = den
    if d.owner is not None and isinstance(d.owner.op, DimShuffle):
        d = d.owner.inputs[0]
    if d.owner is None or not isinstance(d.owner.op, Sum):
        return None
    summed = d.owner.inputs[0]
    if summed is not num and not (_is_ew(summed.owner, aes.Exp) and summed.owner.inputs[0] is x):
        return None
    axes = d.owner.op.axis
    if axes is None or len(axes) != 1:
        return None
    return x, axes[0]


def _converted(out, res):
    if res.type != out.type:
        res = out.type.convert_variable(res)
    return False if res is None else [copy_stack_trace(out, res)]


@node_rewriter([Elemwise])
def local_softmax_graph(fgraph, node):
    """exp(x) / sum(exp(x)) → Softmax"""
    if not isinstance(node.op.scalar_op, aes.TrueDiv):
        return False
    m = _match_softmax(node.outputs[0])
    if m is None:
        return False
    x, axis = m
    return _converted(node.outputs[0], Softmax(axis)(x))


@node_rewriter([Elemwise])
def local_logsoftmax(fgraph, node):
    """log(Softmax(x)) → LogSoftmax(x)"""
    if not isinstance(node.op.scalar_op, aes.Log):
        return False
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, Softmax):
        return False
    return _converted(node.outputs[0], LogSoftmax(inner.op.axis)(inner.inputs[0]))


register_specialize(local_softmax_graph)
register_stabilize(local_logsoftmax)
register_specialize(local_logsoftmax, name="local_logsoftmax_specialize")
