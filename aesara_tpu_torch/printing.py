"""The ``Print`` op (the counterpart of ``Print`` in
``aesara_tpu/printing.py``): a value printed as a side effect of the
graph.  Only the op is ported; the graph printers (``debugprint``,
``pprint``) are not.

Its lowering (``link/torch/control_dispatch.py``) prints ``message`` and
the value on every call, in the JAX package's ``jax.debug.print`` format,
so a function that holds one reads the value on the host each call and
runs eagerly (its ``capture_blocker`` says so).
"""

from __future__ import annotations

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op


__all__ = ["Print"]


class Print(Op):
    """Pass through the value, printing it: ``perform`` prints ``message``
    and each of ``attrs`` of the value, the lowering ``message`` and the
    value."""

    __props__ = ("message", "attrs", "global_fn")
    view_map = {0: [0]}

    def __init__(self, message: str = "", attrs=("__str__",), global_fn=None):
        self.message = message
        self.attrs = tuple(attrs)
        self.global_fn = global_fn

    def make_node(self, xin):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        xin = as_tensor_variable(xin)
        return Apply(self, [xin], [xin.type()])

    def perform(self, node, inputs, output_storage):
        (xin,) = inputs
        for attr in self.attrs:
            obj = getattr(xin, attr)
            val = obj() if callable(obj) else obj
            print(f"{self.message} {attr} = {val}")
        output_storage[0][0] = xin

    def do_constant_folding(self, fgraph, node):
        return False

    def infer_shape(self, fgraph, node, input_shapes):
        return input_shapes

    def grad(self, inputs, output_grads):
        return output_grads

    def __str__(self):
        return f"Print{{{self.message}}}"
