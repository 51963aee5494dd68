"""``Op``: the symbolic operation contract (reference ``graph/op.py``).

- ``make_node(*inputs) -> Apply`` validates inputs and types the outputs.
- ``__call__`` builds the node and returns its output(s).
- ``perform(node, inputs, output_storage)`` evaluates with NumPy; the
  torch linker uses it to fold host values (shape arithmetic).
- ``do_constant_folding`` says whether that folding is allowed.
- ``grad``/``L_op`` give the symbolic vector-Jacobian product that
  ``aesara_tpu_torch.gradient.grad`` composes; ``connection_pattern``
  says which inputs reach which outputs.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from aesara_tpu_torch.graph.ir import Apply, Variable
from aesara_tpu_torch.graph.utils import MethodNotDefined, add_tag_trace


__all__ = ["Op"]


class Op:
    """A symbolic operation; ``__props__`` names define equality and hash."""

    __props__: Optional[tuple] = None
    default_output: Optional[int] = None

    def make_node(self, *inputs: Variable) -> Apply:
        raise NotImplementedError(f"{type(self).__name__}.make_node")

    def __call__(self, *inputs, name=None, return_list=False, **kwargs):
        node = self.make_node(*inputs, **kwargs)
        if name is not None:
            if len(node.outputs) == 1:
                node.outputs[0].name = name
            else:
                for i, o in enumerate(node.outputs):
                    o.name = f"{name}_{i}"
        for o in node.outputs:
            add_tag_trace(o)
        if self.default_output is not None:
            rval = node.outputs[self.default_output]
            return [rval] if return_list else rval
        if len(node.outputs) == 1 and not return_list:
            return node.outputs[0]
        return node.outputs

    def perform(self, node: Apply, inputs: Sequence[Any], output_storage: Sequence[list]) -> None:
        """NumPy evaluation: write results into ``output_storage[i][0]``."""
        raise MethodNotDefined(f"{type(self).__name__}.perform")

    def do_constant_folding(self, fgraph, node: Apply) -> bool:
        return True

    def grad(self, inputs: Sequence[Variable], output_grads: Sequence[Variable]):
        raise NotImplementedError(f"{type(self).__name__}.grad")

    def L_op(self, inputs, outputs, output_grads):
        """The VJP given the outputs too; defaults to ``grad``."""
        return self.grad(inputs, output_grads)

    def connection_pattern(self, node: Apply) -> List[List[bool]]:
        """[n_in][n_out]: which inputs influence which outputs."""
        return [[True for _ in node.outputs] for _ in node.inputs]

    def __eq__(self, other):
        if self is other:
            return True
        props = self.__props__
        if props is None or type(self) is not type(other):
            return NotImplemented if props is None else False
        return all(getattr(self, p) == getattr(other, p) for p in props)

    def __hash__(self):
        props = self.__props__
        if props is None:
            return id(self)
        return hash((type(self),) + tuple(getattr(self, p) for p in props))

    def __str__(self):
        name = type(self).__name__
        if self.__props__:
            args = ", ".join(f"{p}={getattr(self, p)!r}" for p in self.__props__)
            return f"{name}{{{args}}}"
        return name

    __repr__ = __str__
