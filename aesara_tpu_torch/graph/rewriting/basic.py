"""Rewriter framework: graph rewriters, node rewriters, the equilibrium
driver and merge (CSE).  The counterpart of
``aesara_tpu/graph/rewriting/basic.py``, cut to what the port's
pipeline runs."""

from __future__ import annotations

import warnings
from collections import Counter, deque
from typing import Optional, Sequence

from aesara_tpu_torch.graph.features import Feature, ReplaceValidate
from aesara_tpu_torch.graph.fg import FunctionGraph
from aesara_tpu_torch.graph.ir import Constant, io_toposort


__all__ = [
    "Rewriter", "GraphRewriter", "NodeRewriter", "node_rewriter",
    "SequentialGraphRewriter", "EquilibriumGraphRewriter", "MergeOptimizer",
    "copy_stack_trace", "in2out",
]


def _require_replace_validate(fgraph: FunctionGraph) -> None:
    if not hasattr(fgraph, "replace_all_validate"):
        fgraph.attach_feature(ReplaceValidate())


class Rewriter:
    name: Optional[str] = None

    def add_requirements(self, fgraph: FunctionGraph) -> None:
        _require_replace_validate(fgraph)


class GraphRewriter(Rewriter):
    """Whole-graph rewriter."""

    def apply(self, fgraph: FunctionGraph):
        raise NotImplementedError

    def rewrite(self, fgraph: FunctionGraph):
        self.add_requirements(fgraph)
        return self.apply(fgraph)


class NodeRewriter(Rewriter):
    """Node-local rewriter: ``transform`` returns False/None (no match), a
    list of replacement outputs, or an {old: new} dict."""

    def tracks(self) -> Optional[Sequence]:
        return None

    def transform(self, fgraph: FunctionGraph, node):
        raise NotImplementedError


class FromFunctionNodeRewriter(NodeRewriter):
    def __init__(self, fn, tracks):
        self.fn = fn
        self._tracks = tracks
        self.name = fn.__name__

    def tracks(self):
        return self._tracks

    def transform(self, fgraph, node):
        return self.fn(fgraph, node)

    def __str__(self):
        return self.name


def node_rewriter(tracks):
    """Decorator declaring a node rewriter and the ops it tracks."""

    def deco(fn):
        return FromFunctionNodeRewriter(fn, tracks)

    return deco


def copy_stack_trace(from_var, to_var):
    """Carry the user's creation trace across a rewrite."""
    tr = getattr(from_var.tag, "trace", [])
    to_var.tag.trace = list(getattr(to_var.tag, "trace", [])) + tr
    return to_var


class SequentialGraphRewriter(GraphRewriter):
    """Apply a list of rewriters in order.  A failing rewriter fails the
    compile: skipping one (fusion above all) would silently take the
    card's kernels off the path."""

    def __init__(self, *rewrites):
        self.rewrites = list(rewrites)

    def apply(self, fgraph):
        for rewriter in self.rewrites:
            rewriter.rewrite(fgraph)

    def __str__(self):
        return f"SeqRewriter({self.rewrites})"


def _process_node(fgraph, node, rewriter) -> bool:
    """Run one node rewriter on one node and commit its replacements."""
    replacements = rewriter.transform(fgraph, node)
    if replacements is False or replacements is None:
        return False
    if isinstance(replacements, dict):
        old_vars, replacements = list(replacements), list(replacements.values())
    else:
        old_vars = node.outputs
    if len(old_vars) != len(replacements):
        raise ValueError(f"{rewriter} gave wrong number of replacements")
    pairs = [(o, n) for o, n in zip(old_vars, replacements) if n is not o and n is not None]
    if not pairs:
        return False
    fgraph.replace_all_validate(pairs, reason=rewriter)
    return True


def _tracked(rewriter, op) -> bool:
    """Whether ``rewriter`` tracks ``op`` (an op type it names, an equal op,
    or every op)."""
    tracks = rewriter.tracks()
    return tracks is None or any((isinstance(t, type) and isinstance(op, t)) or (not isinstance(t, type) and op == t)
                                 for t in tracks)


class EquilibriumGraphRewriter(GraphRewriter):
    """Apply node rewriters over the graph until none fires, with a
    max-use guard against ping-pong loops (reference ``:2232``)."""

    def __init__(self, rewriters: Sequence[NodeRewriter], max_use_ratio: float = 10.0):
        self.rewriters = list(rewriters)
        self.max_use_ratio = max_use_ratio

    def _trackers(self, op):
        return [rw for rw in self.rewriters if _tracked(rw, op)]

    def apply(self, fgraph):
        max_use = max(1, int(self.max_use_ratio * (len(fgraph.apply_nodes) + 10)))
        uses: Counter = Counter()
        changed = True
        while changed:
            changed = False
            q = deque(io_toposort(fgraph.inputs, fgraph.outputs))
            importer = _Importer(q)
            fgraph.attach_feature(importer)
            try:
                while q:
                    node = q.pop()
                    if node not in fgraph.apply_nodes:
                        continue
                    importer.current = node
                    for rw in self._trackers(node.op):
                        if uses[rw] >= max_use:
                            continue
                        if _process_node(fgraph, node, rw):
                            uses[rw] += 1
                            changed = True
                            if uses[rw] == max_use:
                                warnings.warn(f"EquilibriumGraphRewriter: max-use ratio exceeded for {rw}")
                            break
            finally:
                fgraph.remove_feature(importer)

    def __str__(self):
        return f"EquilibriumGraphRewriter({self.rewriters})"


class SequentialNodeRewriter(NodeRewriter):
    """Its member node rewriters tried in order on one node; the first that
    fires gives the replacements (reference ``:1208``)."""

    def __init__(self, *rewriters):
        self.rewriters = list(rewriters)

    def transform(self, fgraph, node):
        for rw in self.rewriters:
            if _tracked(rw, node.op):
                result = rw.transform(fgraph, node)
                if result:
                    return result
        return False

    def __str__(self):
        return f"SequentialNodeRewriter({self.rewriters})"


class WalkingGraphRewriter(GraphRewriter):
    """One pass of a node rewriter over the graph, inputs to outputs; the
    nodes a replacement brings in are visited next (reference ``:2002``)."""

    def __init__(self, rewriter: NodeRewriter):
        self.rewriter = rewriter

    def apply(self, fgraph):
        q = deque(io_toposort(fgraph.inputs, fgraph.outputs))
        importer = _Importer(q, left=True)
        fgraph.attach_feature(importer)
        try:
            while q:
                node = q.popleft()
                if node in fgraph.apply_nodes:
                    importer.current = node
                    _process_node(fgraph, node, self.rewriter)
        finally:
            fgraph.remove_feature(importer)

    def __str__(self):
        return f"WalkingGraphRewriter({self.rewriter})"


def in2out(*rewriters, name=None) -> WalkingGraphRewriter:
    """One inputs-to-outputs pass of ``rewriters``, each tried on the nodes
    of the ops it tracks, the first that fires on a node winning
    (reference ``in2out``)."""
    rw = WalkingGraphRewriter(SequentialNodeRewriter(*rewriters))
    rw.name = name
    return rw


class _Importer(Feature):
    """Queues nodes that a rewrite imports, so they are visited too."""

    def __init__(self, q: deque, left: bool = False):
        self.q = q
        self.left = left
        self.current = None

    def on_import(self, fgraph, node, reason):
        if node is not self.current:
            (self.q.appendleft if self.left else self.q.append)(node)


def _covers(olds, news) -> bool:
    """Whether each of ``news`` may stand for the one of ``olds`` at its
    position: the same type, or one whose values are all of the old's."""
    return all(o.type == n.type or getattr(o.type, "is_super", lambda t: False)(n.type)
               for o, n in zip(olds, news))


class MergeOptimizer(GraphRewriter):
    """CSE: merge equal constants, then equal Apply nodes, to a fixed point."""

    def apply(self, fgraph):
        # by identity: equal TensorConstants are one key in fgraph.variables
        constants = {id(i): i for node in fgraph.toposort() for i in node.inputs
                     if isinstance(i, Constant)}
        sig_map: dict = {}
        for var in constants.values():
            first = sig_map.setdefault(var.merge_signature(), var)
            if first is not var:
                fgraph.replace_all_validate([(var, first)], reason="MergeOptimizer")
        changed = True
        while changed:
            changed = False
            by_key: dict = {}
            for node in fgraph.toposort():
                if node not in fgraph.apply_nodes:
                    continue
                key = (node.op, tuple(map(id, node.inputs)))
                first = by_key.setdefault(key, node)
                if first is node:
                    continue
                # keep the node whose outputs know more of their static
                # shape (a Reshape to a folded shape and one to the same
                # constant differ only there); skip a pair neither covers
                if not _covers(node.outputs, first.outputs):
                    if not _covers(first.outputs, node.outputs):
                        continue
                    by_key[key], first, node = node, node, first
                fgraph.replace_all_validate(list(zip(node.outputs, first.outputs)), reason="MergeOptimizer")
                changed = True

    def __str__(self):
        return "MergeOptimizer"
