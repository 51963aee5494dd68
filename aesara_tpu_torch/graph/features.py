"""Feature plugins: event hooks on FunctionGraph mutation
(reference ``graph/features.py``: Feature, History, ReplaceValidate,
NoOutputFromInplace)."""

from __future__ import annotations

from functools import partial


class AlreadyThere(Exception):
    """Raised by on_attach when an equivalent feature is already attached."""


class BadOptimization(Exception):
    """A rewrite broke a guarantee the graph must keep."""


class Feature:
    """Hook interface; every method is optional."""

    def on_attach(self, fgraph) -> None:
        ...

    def on_detach(self, fgraph) -> None:
        ...

    def on_import(self, fgraph, node, reason) -> None:
        ...

    def on_change_input(self, fgraph, node, i, old_var, new_var, reason=None) -> None:
        ...

    def on_prune(self, fgraph, node, reason) -> None:
        ...


class ReplaceValidate(Feature):
    """Transactional replace: a replacement that raises part-way, or after
    which ``fgraph.validate()`` raises (an in-place node the destroy
    handler refuses), is undone (reference History + ReplaceValidate).
    Adds ``fgraph.replace_all_validate``."""

    def on_attach(self, fgraph):
        if hasattr(fgraph, "replace_all_validate"):
            raise AlreadyThere("ReplaceValidate feature already present")
        self.history = []
        self.recording = True
        fgraph.replace_all_validate = partial(self.replace_all_validate, fgraph)
        fgraph.replace_validate = partial(self.replace_validate, fgraph)

    def on_detach(self, fgraph):
        del fgraph.replace_all_validate
        del fgraph.replace_validate

    def on_change_input(self, fgraph, node, i, old_var, new_var, reason=None):
        if self.recording:
            self.history.append(partial(fgraph.change_node_input, node, i, old_var,
                                        reason="Revert", check=False))

    def replace_validate(self, fgraph, var, new_var, reason=None):
        self.replace_all_validate(fgraph, [(var, new_var)], reason=reason)

    def replace_all_validate(self, fgraph, replacements, reason=None):
        checkpoint = len(self.history)
        try:
            for var, new_var in replacements:
                fgraph.replace(var, new_var, reason=reason)
            fgraph.validate()
        except Exception:
            self.recording = False
            try:
                while len(self.history) > checkpoint:
                    self.history.pop()()
            finally:
                self.recording = True
            raise
        del self.history[checkpoint:]


class NoOutputFromInplace(Feature):
    """Validation: the outputs at ``protected_out_ids`` are not computed by
    a node that destroys an input to give them (reference
    ``aesara_tpu/graph/features.py:225-237``)."""

    def __init__(self, protected_out_ids):
        self.protected_out_ids = tuple(protected_out_ids)

    def validate(self, fgraph):
        for i in self.protected_out_ids:
            node = fgraph.outputs[i].owner
            if node is not None and node.op.destroy_map and fgraph.outputs[i].index in node.op.destroy_map:
                raise BadOptimization(f"protected output {fgraph.outputs[i]} produced in place")
