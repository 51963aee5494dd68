"""``FunctionGraph``: the mutable subgraph that rewrites operate on
(reference ``graph/fg.py``).  It keeps a ``clients`` index
(variable → [(Apply, input index)]) and fires Feature callbacks on every
import, prune and input change; ``validate`` runs its features' checks
and ``toposort`` honours their ``orderings`` (the destroy handler's)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from aesara_tpu_torch.graph.features import AlreadyThere, Feature
from aesara_tpu_torch.graph.ir import (
    Apply, AtomicVariable, Constant, Variable, clone_get_equiv, graph_inputs,
    io_toposort,
)


__all__ = ["FunctionGraph", "MissingInputError", "OUTPUT"]


class MissingInputError(Exception):
    """A needed graph input is not among fgraph.inputs."""


OUTPUT = "output"  # client marker for a graph output


class FunctionGraph:
    """A subgraph with explicit inputs and outputs plus rewrite bookkeeping."""

    def __init__(self, inputs: Optional[Sequence[Variable]] = None,
                 outputs: Optional[Sequence[Variable]] = None, clone: bool = True,
                 update_mapping: Optional[dict] = None):
        if outputs is None:
            raise ValueError("outputs must be provided")
        if inputs is None:
            inputs = [i for i in graph_inputs(outputs) if not isinstance(i, Constant)]
        inputs, outputs = list(inputs), list(outputs)
        if clone:
            memo = clone_get_equiv(inputs, outputs)
            inputs = [memo[i] for i in inputs]
            outputs = [memo[o] for o in outputs]
        self.inputs: List[Variable] = []
        self.outputs: List[Variable] = outputs
        #: output index -> the index of the input whose new value it is
        #: (``function``'s shared updates)
        self.update_mapping: dict = dict(update_mapping or {})
        self.clients: dict = {}
        self.apply_nodes: set = set()
        self.variables: set = set()
        self._features: List[Feature] = []
        for inp in inputs:
            if inp.owner is not None:
                raise ValueError(f"input {inp} has an owner; not a graph input")
            self.inputs.append(inp)
            self.variables.add(inp)
            self.clients.setdefault(inp, [])
        for output in self.outputs:
            self.import_var(output, reason="init")
        for i, output in enumerate(self.outputs):
            self.clients[output].append((OUTPUT, i))

    # --- structure -------------------------------------------------------

    def _check_input(self, var: Variable) -> None:
        if var.owner is None and not isinstance(var, AtomicVariable) and var not in self.inputs:
            raise MissingInputError(f"Input {var} is not an input of the FunctionGraph; "
                                    f"trace: {getattr(var.tag, 'trace', None)}")

    def remove_client(self, var: Variable, client: Tuple, reason=None) -> None:
        """Remove a client edge; prune the producing node once it is dead."""
        stack = [(var, client)]
        while stack:
            v, c = stack.pop()
            clients = self.clients.get(v, [])
            if c in clients:
                clients.remove(c)
            if clients:
                continue
            owner = v.owner
            if owner is not None and owner in self.apply_nodes:
                if not any(self.clients.get(o) for o in owner.outputs):
                    self.apply_nodes.remove(owner)
                    for o in owner.outputs:
                        self.variables.discard(o)
                        self.clients.pop(o, None)
                    self.execute_callbacks("on_prune", owner, reason)
                    for i, inp in enumerate(owner.inputs):
                        stack.append((inp, (owner, i)))
            elif owner is None and v not in self.inputs and v not in self.outputs:
                self.variables.discard(v)
                self.clients.pop(v, None)

    def import_var(self, var: Variable, reason=None) -> None:
        if var.owner is not None and var.owner not in self.apply_nodes:
            self.import_node(var.owner, reason=reason)
        elif var.owner is None:
            self._check_input(var)
        self.variables.add(var)
        self.clients.setdefault(var, [])

    def import_node(self, node: Apply, reason=None) -> None:
        """Add an Apply node and its missing ancestors, inputs first."""
        for var in graph_inputs(node.outputs, blockers=self.variables):
            self._check_input(var)
        for n in io_toposort([v for v in self.variables], node.outputs):
            if n in self.apply_nodes:
                continue
            self.apply_nodes.add(n)
            for out in n.outputs:
                self.variables.add(out)
                self.clients.setdefault(out, [])
            for i, inp in enumerate(n.inputs):
                self.variables.add(inp)
                self.clients.setdefault(inp, []).append((n, i))
            self.execute_callbacks("on_import", n, reason)

    # --- mutation ----------------------------------------------------------

    def change_node_input(self, node, i: int, new_var: Variable, reason=None,
                          check: bool = True) -> None:
        """Set ``node.inputs[i] = new_var`` (``outputs[i]`` for OUTPUT)."""
        old_var = self.outputs[i] if node == OUTPUT else node.inputs[i]
        if check and not old_var.type.is_super(new_var.type):
            raise TypeError(f"Cannot change input {i} of {node} from {old_var.type} "
                            f"to {new_var.type}")
        if old_var is new_var:
            return
        self.import_var(new_var, reason=reason)
        if node == OUTPUT:
            self.outputs[i] = new_var
        else:
            node.inputs[i] = new_var
        self.clients[new_var].append((node, i))
        self.remove_client(old_var, (node, i), reason=reason)
        self.execute_callbacks("on_change_input", node, i, old_var, new_var, reason=reason)

    def replace(self, var: Variable, new_var: Variable, reason=None) -> None:
        """Replace every use of ``var`` by ``new_var``."""
        new_var = var.type.filter_variable(new_var, allow_convert=True)
        if var not in self.variables:
            return
        for client, idx in list(self.clients.get(var, [])):
            self.change_node_input(client, idx, new_var, reason=reason)

    def attach_feature(self, feature: Feature) -> None:
        if feature in self._features:
            return
        try:
            feature.on_attach(self)
        except AlreadyThere:
            return
        self._features.append(feature)

    def remove_feature(self, feature: Feature) -> None:
        if feature in self._features:
            self._features.remove(feature)
            feature.on_detach(self)

    def execute_callbacks(self, name: str, *args, **kwargs) -> None:
        for feature in self._features:
            getattr(feature, name)(self, *args, **kwargs)

    # --- queries -------------------------------------------------------------

    def toposort(self) -> List[Apply]:
        """Apply nodes in dependency order, honouring the features'
        orderings (reference ``fg.py:766``)."""
        return io_toposort(self.inputs, self.outputs, orderings=self.orderings() or None)

    def orderings(self) -> dict:
        """The features' extra dependencies, node -> nodes before it
        (reference ``fg.py:782``)."""
        merged: dict = {}
        for feature in self._features:
            fn = getattr(feature, "orderings", None)
            if fn is not None:
                for node, before in fn(self).items():
                    merged.setdefault(node, []).extend(before)
        return merged

    def validate(self) -> None:
        """Run every feature's ``validate`` (the destroy handler's and the
        Supervisor's raise ``InconsistencyError``)."""
        for feature in self._features:
            fn = getattr(feature, "validate", None)
            if fn is not None:
                fn(self)

    def clone(self) -> "FunctionGraph":
        """A copy with fresh variables and nodes (and no features)."""
        return FunctionGraph(self.inputs, self.outputs, clone=True, update_mapping=self.update_mapping)
