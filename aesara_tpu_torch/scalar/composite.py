"""``Composite``: a scalar sub-graph fused into one op, the unit of
elemwise fusion (reference ``aesara_tpu/scalar/composite.py``).

In the port each distinct Composite becomes one generated Triton kernel
on the card (``link/torch/kernels/elemwise.py``).
"""

from __future__ import annotations

from typing import Sequence

from aesara_tpu_torch.graph.ir import Apply, Variable, clone, equal_computations, io_toposort
from aesara_tpu_torch.scalar.ops import ScalarOp, as_scalar


__all__ = ["Composite"]


class Composite(ScalarOp):
    """A fused scalar computation with ``len(inputs)`` ins and
    ``len(outputs)`` outs."""

    def __init__(self, inputs: Sequence[Variable], outputs: Sequence[Variable], name=None):
        self.inputs, self.outputs = clone(list(inputs), list(outputs))
        self.inputs_type = tuple(i.type for i in self.inputs)
        self.outputs_type = tuple(o.type for o in self.outputs)
        self.nin = len(inputs)
        self.nout = len(outputs)
        self.nodes = io_toposort(self.inputs, self.outputs)
        ops = sorted({str(v.owner.op) for v in self.outputs if v.owner is not None})
        self.name = name or f"Composite{{{','.join(ops)}}}"

    def output_types(self, types):
        if tuple(types) != self.inputs_type:
            raise TypeError(f"{self.name} built for input types {self.inputs_type}, got {types}")
        return self.outputs_type

    def make_node(self, *inputs):
        inputs = [as_scalar(i) for i in inputs]
        if len(inputs) != self.nin:
            raise ValueError(f"{self.name} expects {self.nin} inputs")
        return Apply(self, inputs, [t() for t in self.output_types([i.type for i in inputs])])

    def impl(self, *values):
        env = dict(zip(self.inputs, values))
        for node in self.nodes:
            res = node.op.impl(*[env[i] if i in env else i.data for i in node.inputs])
            for o, r in zip(node.outputs, (res,) if node.op.nout == 1 else res):
                env[o] = r
        outs = tuple(env[o] if o in env else o.data for o in self.outputs)
        return outs if len(outs) > 1 else outs[0]

    def __eq__(self, other):
        if self is other:
            return True
        if type(other) is not Composite or self.nin != other.nin or self.nout != other.nout:
            return False
        return equal_computations(self.outputs, other.outputs, self.inputs, other.inputs)

    def __hash__(self):
        return hash((Composite, self.nin, self.nout, self.inputs_type, self.outputs_type))

    def __str__(self):
        return self.name
