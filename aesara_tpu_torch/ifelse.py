"""``ifelse``: the branching conditional (the counterpart of
``aesara_tpu/ifelse.py``: ``IfElse``, ``ifelse``, ``cond_remove_identical``,
``cond_merge_ifs_true`` and ``CondMerge``).

The op takes both branches' values as inputs, so both are computed before
it selects, as under the JAX package's ``lax.cond``.  Its lowering
(``link/torch/control_dispatch.py``) picks the branch on the host when
the condition is a host value of the linker, and otherwise selects on the
device with ``torch.where`` over the 0-d condition, which needs no host
read and so can be captured.  The JAX package's lazy thunk, which
computes only the taken branch, belongs to its PY linker; the port has no
such linker, so it has no thunk.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply, Variable, ancestors
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, in2out, node_rewriter
from aesara_tpu_torch.tensor.basic import as_tensor_variable
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["IfElse", "ifelse", "cond_remove_identical", "cond_merge_ifs_true", "CondMerge",
           "register_ifelse_rewrites"]


class IfElse(Op):
    """``n_outs`` outputs; inputs are ``[cond] + true_branch + false_branch``."""

    __props__ = ("n_outs", "as_view")

    def __init__(self, n_outs: int, as_view: bool = False, name=None):
        self.n_outs = int(n_outs)
        self.as_view = bool(as_view)
        self.name = name
        # view_map cannot say "one of two inputs": it declares the true
        # branch, and perform copies the false one
        self.view_map = {k: [1 + k] for k in range(self.n_outs)}

    def make_node(self, condition, *args):
        if len(args) != 2 * self.n_outs:
            raise ValueError(f"IfElse({self.n_outs}) needs {2 * self.n_outs} branch args")
        condition = as_tensor_variable(condition)
        if condition.type.ndim != 0:
            raise TypeError("ifelse condition must be a scalar")
        trues = [as_tensor_variable(a) for a in args[:self.n_outs]]
        falses = [as_tensor_variable(a) for a in args[self.n_outs:]]
        outs = []
        for t, f in zip(trues, falses):
            if t.type.dtype != f.type.dtype:
                raise TypeError(f"ifelse branches must have equal dtypes: {t.type.dtype} vs {f.type.dtype}")
            if t.type.ndim != f.type.ndim:
                raise TypeError("ifelse branches must have equal ndim")
            shape = tuple(ts if ts is not None and ts == fs else None for ts, fs in zip(t.type.shape, f.type.shape))
            outs.append(TensorType(t.type.dtype, shape)())
        return Apply(self, [condition] + trues + falses, outs)

    def perform(self, node, inputs, output_storage):
        cond, *rest = inputs
        branch = rest[:self.n_outs] if bool(cond) else [np.array(v, copy=True) for v in rest[self.n_outs:]]
        for storage, val in zip(output_storage, branch):
            storage[0] = val

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.basic import switch

        cond = node.inputs[0]
        true_shapes = input_shapes[1:1 + self.n_outs]
        false_shapes = input_shapes[1 + self.n_outs:]
        return [tuple(switch(cond, t, f) for t, f in zip(ts, fs)) for ts, fs in zip(true_shapes, false_shapes)]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type
        from aesara_tpu_torch.tensor.basic import zeros_like

        cond, *rest = inputs
        trues, falses = rest[:self.n_outs], rest[self.n_outs:]
        # each branch's gradient is gated by the condition: zero where untaken
        zeros_t = [zeros_like(t) for t in trues]
        zeros_f = [zeros_like(f) for f in falses]
        g_trues = ifelse(cond, list(output_grads), zeros_t, n_outs=self.n_outs)
        g_falses = ifelse(cond, zeros_f, list(output_grads), n_outs=self.n_outs)
        return [disconnected_type()] + list(g_trues) + list(g_falses)

    def connection_pattern(self, node):
        return [[False] * self.n_outs] + [[True] * self.n_outs for _ in range(2 * self.n_outs)]

    def __str__(self):
        return f"if{{{self.n_outs}}}" if not self.as_view else f"if{{view,{self.n_outs}}}"


def ifelse(condition, then_branch, else_branch, n_outs=None, name=None):
    """The branch ``then_branch`` where ``condition`` holds, else
    ``else_branch`` (each a variable or a list of them); branches of
    different dtypes are upcast to a common one."""
    from aesara_tpu_torch.scalar.ops import upcast
    from aesara_tpu_torch.tensor.basic import cast

    single = not isinstance(then_branch, (list, tuple))
    trues = [then_branch] if single else list(then_branch)
    falses = [else_branch] if single else list(else_branch)
    if len(trues) != len(falses):
        raise ValueError("branches must have the same number of outputs")
    if n_outs is None:
        n_outs = len(trues)
    coerced_t, coerced_f = [], []
    for t, f in zip(trues, falses):
        t, f = as_tensor_variable(t), as_tensor_variable(f)
        if t.type.dtype != f.type.dtype:
            dt = upcast(t.type.dtype, f.type.dtype)
            t, f = cast(t, dt), cast(f, dt)
        coerced_t.append(t)
        coerced_f.append(f)
    res = IfElse(n_outs, name=name)(condition, *coerced_t, *coerced_f)
    if single:
        return res if isinstance(res, Variable) else res[0]
    return res if isinstance(res, list) else [res]


@node_rewriter([IfElse])
def cond_remove_identical(fgraph, node):
    """``IfElse(c, x, x)`` is ``x``."""
    n = node.op.n_outs
    trues, falses = node.inputs[1:1 + n], node.inputs[1 + n:1 + 2 * n]
    if all(t is f for t, f in zip(trues, falses)):
        for old, new in zip(node.outputs, trues):
            copy_stack_trace(old, new)
        return dict(zip(node.outputs, trues))
    return False


@node_rewriter([IfElse])
def cond_merge_ifs_true(fgraph, node):
    """Two IfElse nodes on the same condition, neither reading the other's
    outputs, become one."""
    cond = node.inputs[0]
    for other, _ in list(fgraph.clients.get(cond, [])):
        if other == "output" or other is node:
            continue
        if not (isinstance(getattr(other, "op", None), IfElse) and other.inputs[0] is cond):
            continue
        # merging nodes that depend on each other would make a cycle
        if (set(node.outputs) & set(ancestors(list(other.inputs)))
                or set(other.outputs) & set(ancestors(list(node.inputs)))):
            continue
        n1, n2 = node.op.n_outs, other.op.n_outs
        new_ins = ([cond] + node.inputs[1:1 + n1] + other.inputs[1:1 + n2]
                   + node.inputs[1 + n1:] + other.inputs[1 + n2:])
        new_outs = IfElse(n1 + n2)(*new_ins, return_list=True)
        repl = dict(zip(node.outputs, new_outs[:n1]))
        repl.update(zip(other.outputs, new_outs[n1:]))
        for old, new in repl.items():
            copy_stack_trace(old, new)
        return repl
    return False


class CondMerge:
    """The whole-graph form of ``cond_merge_ifs_true``."""

    def rewrite(self, fgraph):
        return in2out(cond_merge_ifs_true).rewrite(fgraph)

    __call__ = rewrite


def register_ifelse_rewrites():
    """Register ``cond_remove_identical`` in specialize, as the JAX
    package's ``_register_ifelse_rewrites`` does (called once the optdb
    exists: the mode module imports the linker)."""
    from aesara_tpu_torch.compile.mode import register_specialize

    register_specialize(cond_remove_identical, name="cond_remove_identical")
