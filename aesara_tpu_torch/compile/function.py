"""``function(inputs, outputs, mode=, updates=)``: graph → FunctionGraph →
optdb rewrites → linker (reference ``aesara_tpu/compile/function.py``).

``updates`` pairs shared variables with expressions of their new values.
The update expressions are outputs of the one compiled graph, so they
read every shared value as it was before the call; the new values are
bound to their shared variables only after the whole graph has run.
The JAX package donates the old buffers to XLA instead
(``aesara_tpu/link/jax/linker.py:304-343``); here the shared variable is
rebound to the new tensor and the old one is freed when nothing else
holds it.  Givens, ``In`` specs and bucketing are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from aesara_tpu_torch.compile.io import Out
from aesara_tpu_torch.compile.mode import get_mode
from aesara_tpu_torch.compile.sharedvalue import SharedVariable
from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.ir import Constant, Variable, graph_inputs


__all__ = ["function", "Function"]


def _storage_ptr(value) -> int:
    """The address of the memory a tensor or array argument lives in."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.untyped_storage().data_ptr()
    if isinstance(value, np.ndarray):
        return value.__array_interface__["data"][0]
    return 0


class Function:
    """A compiled graph: call it with one value per input; it returns a
    list of torch tensors on the linker's device (one tensor when
    ``outputs`` was a single variable, None when there were none), and
    then binds each updated shared variable to its new value."""

    def __init__(self, fn, fgraph, n_inputs: int, single_output: bool, borrow: Sequence[bool],
                 update_targets: Sequence[SharedVariable]):
        self.fn = fn
        self.fgraph = fgraph
        self.maker = self  # ``f.maker.fgraph``, as in the JAX package
        self.n_inputs = n_inputs
        self.single_output = single_output
        self.borrow = list(borrow)
        self.update_targets = list(update_targets)
        self.shared_inputs = fgraph.inputs[n_inputs:]

    def __call__(self, *args):
        if len(args) != self.n_inputs:
            raise TypeError(f"expected {self.n_inputs} arguments, got {len(args)}")
        # read before the call: an updated shared variable holds another
        # tensor afterwards
        held = [v.value for v in self.shared_inputs] + list(args)
        results = self.fn(*args)
        n_out = len(self.borrow)
        outs, new_values = list(results[:n_out]), results[n_out:]
        for target, new in zip(self.update_targets, new_values):
            if new.device != target.value.device:
                raise ValueError(f"update of {target} computed on {new.device}; "
                                 f"the variable lives on {target.value.device}")
            target.type.check_shape(tuple(new.shape))
        for target, new in zip(self.update_targets, new_values):
            target._value = new
        if not all(self.borrow):
            taken = {_storage_ptr(v) for v in held + list(new_values)} - {0}
            outs = [o.clone() if not b and _storage_ptr(o) in taken else o
                    for o, b in zip(outs, self.borrow)]
        if self.single_output:
            return outs[0]
        return outs if outs else None


def _update_pairs(updates):
    """``updates`` as a list of (shared variable, new value variable)."""
    from aesara_tpu_torch.tensor.basic import as_tensor_variable

    if updates is None:
        return []
    pairs = list(updates.items()) if isinstance(updates, dict) else list(updates)
    targets = [t for t, _ in pairs]
    if len({id(t) for t in targets}) != len(targets):
        raise ValueError(f"duplicate update targets: {[t for t in targets if targets.count(t) > 1][:2]}")
    out = []
    for target, value in pairs:
        if not isinstance(target, SharedVariable):
            raise TypeError(f"update target {target} is not a shared variable")
        value = as_tensor_variable(value)
        tt, vt = target.type, value.type
        # the value may know less of its static shape than the target;
        # the call checks the runtime shape
        if (vt.dtype != tt.dtype or vt.ndim != tt.ndim
                or any(a is not None and b is not None and a != b
                       for a, b in zip(tt.shape, vt.shape))):
            raise TypeError(f"update of {target} ({tt}) has type {vt}")
        out.append((target, value))
    return out


def function(inputs: Sequence[Variable], outputs=None, mode=None, updates=None) -> Function:
    """Compile ``outputs`` (a variable, an ``Out``, a list of them, or
    None) as a function of ``inputs``, applying ``updates`` (pairs or a
    dict of shared variable → new value) after each call."""
    if isinstance(inputs, Variable):
        raise TypeError("inputs must be a list/tuple")
    inputs = list(inputs)
    single = isinstance(outputs, (Variable, Out))
    specs = [] if outputs is None else [outputs] if single else list(outputs)
    specs = [o if isinstance(o, Out) else Out(o) for o in specs]
    pairs = _update_pairs(updates)
    out_vars = [o.variable for o in specs] + [v for _, v in pairs]
    sources = graph_inputs(out_vars)
    shared = [v for v in sources if isinstance(v, SharedVariable) and v not in inputs]
    missing = [v for v in sources
               if v.owner is None and not isinstance(v, (Constant, SharedVariable))
               and v not in inputs]
    if missing:
        raise TypeError(f"graph depends on inputs not given to function(): {missing}")
    mode = get_mode(mode)
    fgraph = FunctionGraph(inputs + shared, out_vars, clone=True)
    mode.optimizer.rewrite(fgraph)
    fn = mode.linker.make_function(fgraph, n_user_inputs=len(inputs))
    return Function(fn, fgraph, len(inputs), single, [o.borrow for o in specs],
                    [t for t, _ in pairs])
