"""Graph-embedded runtime checks (the counterpart of
``aesara_tpu/raise_op.py``): ``CheckAndRaise``, ``Assert`` and
``assert_op``.

The op passes its value through and raises ``exc_type(msg)`` when a
condition is false.  How far that holds on a device is the lowering's
(``link/torch/control_dispatch.py``): a condition the linker keeps on the
host (a constant, or one computed from shapes) is checked on every call,
one that lives on the device passes the value through unread, as the JAX
package's XLA lowering does.  Unlike the JAX package's op, this one never
folds as a constant (``do_constant_folding``), so a false constant
condition raises at each call, not inside a rewrite.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable


__all__ = ["CheckAndRaise", "Assert", "assert_op"]


class CheckAndRaise(Op):
    """Pass through the value; raise ``exc_type(msg)`` if any condition is
    false (an array condition is reduced with ``all``)."""

    __props__ = ("msg", "exc_type")
    view_map = {0: [0]}

    def __init__(self, exc_type=AssertionError, msg=""):
        self.exc_type = exc_type
        self.msg = msg

    def make_node(self, value, *conds):
        value = as_tensor_variable(value)
        conds = [as_tensor_variable(c) for c in conds]
        return Apply(self, [value] + conds, [value.type()])

    def perform(self, node, inputs, output_storage):
        value, *conds = inputs
        for c in conds:
            if not np.all(c):
                raise self.exc_type(self.msg)
        output_storage[0][0] = value

    def do_constant_folding(self, fgraph, node):
        return False

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        (gz,) = output_grads
        return [gz] + [disconnected_type() for _ in inputs[1:]]

    def __str__(self):
        return f"CheckAndRaise{{{self.exc_type.__name__}({self.msg})}}"


class Assert(CheckAndRaise):
    """``CheckAndRaise`` raising ``AssertionError``."""

    def __init__(self, msg="Aesara Assert failed!"):
        super().__init__(AssertionError, msg)

    def __str__(self):
        return f"Assert{{msg={self.msg}}}"


assert_op = Assert()
