"""Compile-support ops (reference ``aesara_tpu/compile/ops.py``):
``DeepCopyOp`` (a fresh copy at run time), ``ViewOp`` (the identity, its
output a view of its input) and ``FromFunctionOp`` with its decorator
``as_op``, which make an Op of a user's Python function on NumPy values.

On the card the linker returns no output that shares storage with a
shared variable it updates, or with another result, unless the caller
asks with ``Out(borrow=True)`` (``link/torch/linker.py``); a ``ViewOp``
output is a view all the same.  A ``FromFunctionOp`` runs on the host:
its lowering copies its inputs there and its results back, and keeps the
function from being captured.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op


__all__ = ["DeepCopyOp", "deep_copy_op", "ViewOp", "view_op", "FromFunctionOp", "as_op"]


class DeepCopyOp(Op):
    """A copy of the input, made at run time."""

    __props__ = ()

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        output_storage[0][0] = x.copy() if isinstance(x, np.ndarray) else copy.deepcopy(x)

    def infer_shape(self, fgraph, node, input_shapes):
        return input_shapes

    def grad(self, inputs, output_grads):
        return [output_grads[0]]

    def __str__(self):
        return "DeepCopyOp"

    def R_op(self, inputs, eval_points):
        return [eval_points[0]]


class ViewOp(Op):
    """The identity; its output is a view of its input."""

    __props__ = ()
    view_map = {0: [0]}

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]

    def infer_shape(self, fgraph, node, input_shapes):
        return input_shapes

    def grad(self, inputs, output_grads):
        return [output_grads[0]]

    def __str__(self):
        return "ViewOp"

    def R_op(self, inputs, eval_points):
        return [eval_points[0]]


deep_copy_op = DeepCopyOp()
view_op = ViewOp()


class FromFunctionOp(Op):
    """An Op of a Python function ``fn`` on NumPy values, with inputs of
    the types ``itypes`` and outputs of the types ``otypes``; ``infer_shape``
    is optional."""

    def __init__(self, fn: Callable, itypes, otypes, infer_shape=None):
        self._fn = fn
        self.itypes = list(itypes)
        self.otypes = list(otypes)
        self._infer_shape = infer_shape
        self.__name__ = getattr(fn, "__name__", str(fn))

    def make_node(self, *inputs):
        if len(inputs) != len(self.itypes):
            raise ValueError(f"{self} takes {len(self.itypes)} inputs, got {len(inputs)}")
        inputs = [t.filter_variable(i) for t, i in zip(self.itypes, inputs)]
        return Apply(self, inputs, [t() for t in self.otypes])

    def perform(self, node, inputs, output_storage):
        outs = self._fn(*inputs)
        if not isinstance(outs, (list, tuple)):
            outs = (outs,)
        for storage, o in zip(output_storage, outs):
            storage[0] = o

    def infer_shape(self, fgraph, node, input_shapes):
        if self._infer_shape is not None:
            return self._infer_shape(fgraph, node, input_shapes)
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self._fn == other._fn

    def __hash__(self):
        return hash((type(self), self._fn))

    def __str__(self):
        return f"FromFunctionOp{{{self.__name__}}}"


def as_op(itypes, otypes, infer_shape=None):
    """Decorator: a Python function on NumPy values becomes an Op."""
    if not isinstance(itypes, (list, tuple)):
        itypes = [itypes]
    if not isinstance(otypes, (list, tuple)):
        otypes = [otypes]

    def make_op(fn):
        return FromFunctionOp(fn, itypes, otypes, infer_shape)

    return make_op
