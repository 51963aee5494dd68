"""``OpFromGraph``: a subgraph packaged as one op, and ``remat``, its
rematerialising form (reference ``aesara_tpu/compile/builders.py``).

An ``OpFromGraph`` holds a copy of its subgraph (``fgraph``), with every
other leaf (shared variables, closure captures) lifted into hidden inputs
after the explicit ones.  Its gradient (``L_op``) is the subgraph's
gradient, built symbolically and re-embedded over the outer inputs.  With
``inline=True`` the specialize rewrite ``inline_ofg_expansion`` replaces
the node by its subgraph.  On the card the node runs its subgraph as an
inner program of the step (``link/torch/control_dispatch.py``).

``remat(inputs, outputs)`` makes a :class:`Remat`: in the forward it is an
``OpFromGraph``, so the subgraph's intermediates live only inside the
node; its gradient recomputes the subgraph from inputs fenced by
:class:`RematBarrier` nodes (an identity whose ``nonce`` keeps the merge
pass from folding the recompute back into the forward) and differentiates
with respect to the fenced inputs.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.ir import Apply, Constant, Variable, ancestors, clone_replace, graph_inputs
from aesara_tpu_torch.graph.op import Op


__all__ = ["OpFromGraph", "construct_nominal_fgraph", "inline_ofg_expansion", "RematBarrier", "Remat",
           "remat"]


def construct_nominal_fgraph(inputs, outputs):
    """(inputs, outputs) cloned into an isolated inner graph whose extra
    leaves (shared variables, closure captures) become hidden inputs after
    ``inputs`` (reference ``builders.py:21-37``); returns the graph, the
    count of hidden inputs and the outer variables they stand for."""
    extra = [v for v in graph_inputs(outputs) if v not in inputs and not isinstance(v, Constant)]
    all_inputs = list(inputs) + extra
    replace = {v: v.type() for v in all_inputs}
    for old, new in replace.items():
        new.name = getattr(old, "name", None)
    new_outputs = clone_replace(outputs, replace=replace)
    fgraph = FunctionGraph([replace[v] for v in all_inputs], new_outputs, clone=False)
    return fgraph, len(extra), extra


class OpFromGraph(Op):
    """A subgraph packaged as an op (reference ``builders.py:39-216``):
    ``lop_overrides`` (or ``grad_overrides``) may be a callable
    ``(inputs, output_grads) -> input grads`` that replaces the subgraph's
    own gradient; ``connection_pattern`` may be given, else it is read
    from the subgraph."""

    def __init__(self, inputs: Sequence[Variable], outputs: Sequence[Variable], inline: bool = False,
                 lop_overrides="default", grad_overrides="default", connection_pattern=None,
                 name: Optional[str] = None, **kwargs):
        if not isinstance(inputs, (list, tuple)) or not isinstance(outputs, (list, tuple)):
            raise TypeError("inputs and outputs must be lists")
        if any(isinstance(i, Constant) for i in inputs):
            raise TypeError("OpFromGraph inputs cannot be constants")
        self.fgraph, self.n_extra, self.extra_outer = construct_nominal_fgraph(list(inputs), list(outputs))
        self.is_inline = bool(inline)
        self.lop_overrides = lop_overrides if lop_overrides != "default" else grad_overrides
        self._connection_pattern = connection_pattern
        self.name = name or "OpFromGraph"
        self.n_explicit = len(inputs)

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def make_node(self, *inputs) -> Apply:
        if len(inputs) == self.n_explicit:
            inputs = list(inputs) + list(self.extra_outer)
        if len(inputs) != len(self.fgraph.inputs):
            raise ValueError(f"{self.name} expected {self.n_explicit} inputs, got {len(inputs)}")
        coerced = [iv.type.filter_variable(v, allow_convert=True) for iv, v in zip(self.fgraph.inputs, inputs)]
        return Apply(self, coerced, [o.type() for o in self.fgraph.outputs])

    def perform(self, node, inputs, output_storage):
        """The subgraph node by node, each by its own ``perform``."""
        env = dict(zip(self.fgraph.inputs, inputs))
        for inner in self.fgraph.toposort():
            storage = [[None] for _ in inner.outputs]
            inner.op.perform(inner, [env[i] if i in env else i.data for i in inner.inputs], storage)
            env.update((o, s[0]) for o, s in zip(inner.outputs, storage))
        for storage, o in zip(output_storage, self.fgraph.outputs):
            storage[0] = env[o] if o in env else o.data

    def infer_shape(self, fgraph, node, input_shapes):
        """Each output's shape, computed through the subgraph from the outer
        inputs (the port has no ShapeFeature to run the ops' shape rules
        over it, as the reference's ``infer_shape`` at ``builders.py:107``
        does)."""
        from aesara_tpu_torch.tensor.shape import shape as tshape

        inner = [tshape(o)[d] for o in self.fgraph.outputs for d in range(o.type.ndim)]
        flat = iter(clone_replace(inner, replace=dict(zip(self.fgraph.inputs, node.inputs))) if inner else [])
        return [tuple(next(flat) for _ in range(o.type.ndim)) for o in self.fgraph.outputs]

    def connection_pattern(self, node):
        """[input][output]: whether the output depends on the input."""
        if self._connection_pattern is not None:
            return self._connection_pattern
        reach = [set(ancestors([o])) for o in self.fgraph.outputs]
        return [[i in r for r in reach] for i in self.fgraph.inputs]

    def L_op(self, inputs, outputs, output_grads):
        from aesara_tpu_torch.gradient import DisconnectedType, NullType, grad as sym_grad

        if callable(self.lop_overrides):
            return self.lop_overrides(inputs, output_grads)
        if isinstance(self.lop_overrides, (list, tuple)):
            raise NotImplementedError("per-input lop overrides are not ported")

        def unknown(g):
            return isinstance(getattr(g, "type", None), (DisconnectedType, NullType))

        known, placeholders = {}, []
        for o, g in zip(self.fgraph.outputs, output_grads):
            ph = None if unknown(g) else o.type()
            if ph is not None:
                known[o] = ph
            placeholders.append(ph)
        inner_grads = sym_grad(None, list(self.fgraph.inputs), known_grads=known,
                               disconnected_inputs="ignore", return_disconnected="zero")
        if not isinstance(inner_grads, list):
            inner_grads = [inner_grads]
        replace = dict(zip(self.fgraph.inputs, inputs))
        replace.update((ph, g) for ph, g in zip(placeholders, output_grads) if ph is not None)
        cloned = iter(clone_replace([g for g in inner_grads if not unknown(g)], replace=replace))
        return [g if unknown(g) else next(cloned) for g in inner_grads]

    def __str__(self):
        return self.name


def inline_ofg_expansion(fgraph, node):
    """An ``OpFromGraph(inline=True)`` node replaced by its subgraph over
    the node's inputs (reference ``builders.py:223-247``)."""
    op = node.op
    if not isinstance(op, OpFromGraph) or not op.is_inline:
        return False
    return clone_replace(list(op.fgraph.outputs), replace=dict(zip(op.fgraph.inputs, node.inputs)))


def register_inline_ofg():
    """Register ``inline_ofg_expansion`` with the specialize rewrites, as
    the JAX package does once its optdb exists (``aesara_tpu_torch``'s
    ``__init__`` calls this: importing the mode here would be circular)."""
    from aesara_tpu_torch.compile.mode import register_specialize
    from aesara_tpu_torch.graph.rewriting.basic import node_rewriter

    rewrite = node_rewriter([OpFromGraph])(inline_ofg_expansion)
    rewrite.name = "inline_ofg_expansion"
    register_specialize(rewrite, name="inline_ofg_expansion")


class RematBarrier(Op):
    """The identity, as a node no rewrite merges with another: its
    ``nonce`` makes two barriers unequal (reference ``builders.py:314-345``,
    where XLA lowers it to ``lax.optimization_barrier``)."""

    __props__ = ("nonce",)
    view_map = {0: [0]}

    def __init__(self, nonce: int):
        self.nonce = int(nonce)

    def make_node(self, x):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def grad(self, inputs, output_grads):
        return [output_grads[0]]

    def __str__(self):
        return f"RematBarrier{{{self.nonce}}}"


_remat_nonce = itertools.count()


class Remat(OpFromGraph):
    """An ``OpFromGraph`` whose gradient recomputes its subgraph instead of
    keeping its intermediates (reference ``builders.py:348-387``): memory
    for work.  Built by :func:`remat`."""

    def L_op(self, inputs, outputs, output_grads):
        from aesara_tpu_torch.gradient import DisconnectedType, Lop

        nonce = next(_remat_nonce)
        fenced = [RematBarrier(nonce)(i) for i in inputs]
        recomputed = clone_replace(list(self.fgraph.outputs), replace=dict(zip(self.fgraph.inputs, fenced)))
        live = [(r, g) for r, g in zip(recomputed, output_grads)
                if not isinstance(getattr(g, "type", None), DisconnectedType)]
        if not live:
            return [DisconnectedType()() for _ in inputs]
        outs, grads = zip(*live)
        # with respect to the fenced inputs, independent roots: with respect
        # to the node's inputs, an input that is an ancestor of another (a
        # shared variable under an explicit input) would be reached twice
        res = Lop(list(outs), fenced, list(grads), disconnected_inputs="ignore")
        return list(res) if isinstance(res, (list, tuple)) else [res]


def remat(inputs, outputs, name=None) -> Remat:
    """``outputs = f(inputs)`` as a rematerialising op (reference
    ``builders.py:390-407``): the backward rebuilds the subgraph behind
    barriers instead of keeping its intermediates alive::

        h_out = remat([h] + layer.params, [layer(h)])(h, *layer.params)
    """
    outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    return Remat(list(inputs), outs, inline=False, name=name or "remat")
