"""``function(inputs, outputs, mode=)``: graph → FunctionGraph → optdb
rewrites → linker (reference ``aesara_tpu/compile/function.py``).

Updates, givens and bucketing are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

from aesara_tpu_torch.compile.mode import get_mode
from aesara_tpu_torch.compile.sharedvalue import SharedVariable
from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.ir import Constant, Variable, graph_inputs


__all__ = ["function", "Function"]


class Function:
    """A compiled graph: call it with one value per input; it returns a
    list of torch tensors on the linker's device (one tensor when
    ``outputs`` was a single variable)."""

    def __init__(self, fn, fgraph, n_inputs: int, single_output: bool):
        self.fn = fn
        self.fgraph = fgraph
        self.maker = self  # ``f.maker.fgraph``, as in the JAX package
        self.n_inputs = n_inputs
        self.single_output = single_output

    def __call__(self, *args):
        if len(args) != self.n_inputs:
            raise TypeError(f"expected {self.n_inputs} arguments, got {len(args)}")
        outs = self.fn(*args)
        return outs[0] if self.single_output else list(outs)


def function(inputs: Sequence[Variable], outputs, mode=None) -> Function:
    """Compile ``outputs`` as a function of ``inputs``."""
    if isinstance(inputs, Variable):
        raise TypeError("inputs must be a list/tuple")
    inputs = list(inputs)
    single = isinstance(outputs, Variable)
    outputs = [outputs] if single else list(outputs)
    shared = [v for v in graph_inputs(outputs)
              if isinstance(v, SharedVariable) and v not in inputs]
    missing = [v for v in graph_inputs(outputs)
               if v.owner is None and not isinstance(v, (Constant, SharedVariable))
               and v not in inputs]
    if missing:
        raise TypeError(f"graph depends on inputs not given to function(): {missing}")
    mode = get_mode(mode)
    fgraph = FunctionGraph(inputs + shared, outputs, clone=True)
    mode.optimizer.rewrite(fgraph)
    fn = mode.linker.make_function(fgraph, n_user_inputs=len(inputs))
    return Function(fn, fgraph, len(inputs), single)
