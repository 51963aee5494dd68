"""``DestroyHandler``: which nodes may overwrite their inputs (the
counterpart of ``aesara_tpu/graph/destroyhandler.py``).

A node destroys an input when its op's ``destroy_map`` says its output is
written into that input's storage (``Gemm{inplace}`` after
``blas_inplace``).  The handler tracks those nodes and, through the ops'
``view_map``, the variables that alias one storage (a ``DimShuffle`` of a
matrix is a view of it).  ``validate`` refuses a graph in which a
storage is destroyed twice, a constant or a protected variable (a
``Supervisor``'s: a function input that is not mutable, a shared variable
that is not updated) is destroyed, a destroyer reads another alias of what
it destroys, or the readers of a destroyed storage cannot all run before
its destroyer; ``orderings`` puts them before it, and
``FunctionGraph.toposort`` follows.

The linker asks the same questions of the nodes that compute the shared
variables' updates (``donations``): where the handler finds it legal, the
node writes the new value into the variable's own storage (the
counterpart of the JAX package's buffer donation), as though its op
destroyed the variable.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

from aesara_tpu_torch.graph.features import AlreadyThere, Feature


__all__ = ["InconsistencyError", "ProtocolError", "DestroyHandler", "Supervisor", "droot", "fast_inplace_check",
           "add_destroy_handler"]


class InconsistencyError(Exception):
    """A graph's destroyers break a rule of the handler."""


class ProtocolError(Exception):
    """The in-place protocol was broken (reference name)."""


def _view_parent(var):
    """The variable ``var`` aliases through its owner's ``view_map``, or
    None."""
    node = var.owner
    if node is None:
        return None
    vmap = getattr(node.op, "view_map", None)
    if vmap and var.index in vmap:
        return node.inputs[vmap[var.index][0]]
    return None


def droot(var):
    """The root of ``var``'s chain of views: ``view_map`` edges are followed
    up to a variable that is no view.  ``destroy_map`` edges are not: a
    chain of destroyers over successive outputs is ordered by its data."""
    seen = set()
    while True:
        parent = _view_parent(var)
        if parent is None or id(parent) in seen:
            return var
        seen.add(id(var))
        var = parent


def _contains_cycle(fgraph, orderings) -> bool:
    """Whether the data dependencies and ``orderings`` make a cycle (Kahn's
    count)."""
    nodes = fgraph.apply_nodes
    indeg = {n: 0 for n in nodes}
    children: Dict = defaultdict(list)
    for node in nodes:
        deps = [inp.owner for inp in node.inputs if inp.owner is not None]
        deps.extend(d for d in orderings.get(node, ()) if d in nodes)
        for d in deps:
            if d in indeg:
                children[d].append(node)
                indeg[node] += 1
    stack = [n for n, k in indeg.items() if k == 0]
    visited = 0
    while stack:
        n = stack.pop()
        visited += 1
        for c in children[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                stack.append(c)
    return visited != len(nodes)


def _protected(fgraph) -> set:
    protected = set()
    for feature in fgraph._features:
        protected |= set(getattr(feature, "protected", ()))
    return protected


def fast_inplace_check(fgraph, inputs):
    """The ``inputs`` that may be overwritten: not protected, not an output,
    and computed in the graph."""
    protected = _protected(fgraph)
    return [i for i in inputs if i not in protected and i not in fgraph.outputs and i.owner is not None]


def _destroyed_indices(node) -> set:
    return {i for idxs in node.op.destroy_map.values() for i in idxs}


class DestroyHandler(Feature):
    """Tracks the graph's destroyers and checks them (see the module)."""

    def __init__(self, do_imports_on_attach: bool = True):
        self.do_imports_on_attach = do_imports_on_attach
        self.destroyers_map: Dict = {}
        self.fgraph = None
        # bumped by every import, prune and input change: the roots and
        # aliases below are computed once per state of the graph
        self._epoch = 0
        self._roots_key = self._members_key = None
        self._roots: Dict = {}
        self._members: Dict = {}

    def clone(self):
        return DestroyHandler(do_imports_on_attach=self.do_imports_on_attach)

    def on_attach(self, fgraph):
        if hasattr(fgraph, "destroyers"):
            raise AlreadyThere("DestroyHandler already attached")
        self.destroyers_map = {}
        self.fgraph = fgraph
        fgraph.destroyers = self.destroyers
        fgraph.has_destroyers = self.has_destroyers
        fgraph.destroy_handler = self
        if self.do_imports_on_attach:
            for node in fgraph.toposort():
                self.on_import(fgraph, node, "on_attach")

    def on_detach(self, fgraph):
        del fgraph.destroyers
        del fgraph.has_destroyers
        del fgraph.destroy_handler
        self.destroyers_map = {}
        self.fgraph = None

    def on_import(self, fgraph, node, reason):
        self._epoch += 1
        for i in _destroyed_indices(node):
            self.destroyers_map.setdefault(node.inputs[i], []).append(node)

    def on_prune(self, fgraph, node, reason):
        self._epoch += 1
        for i in _destroyed_indices(node):
            nodes = self.destroyers_map.get(node.inputs[i], [])
            if node in nodes:
                nodes.remove(node)

    def on_change_input(self, fgraph, node, i, old_var, new_var, reason=None):
        self._epoch += 1
        if node == "output" or not getattr(node, "op", None):
            return
        if i in _destroyed_indices(node):
            nodes = self.destroyers_map.get(old_var, [])
            if node in nodes:
                nodes.remove(node)
            self.destroyers_map.setdefault(new_var, []).append(node)

    # -- the graph's state ---------------------------------------------------

    def _live_destroyed_roots(self, fgraph) -> dict:
        """{root of a view chain: [its live destroyers]}."""
        key = (id(fgraph), self._epoch)
        if self._roots_key != key:
            roots: Dict = {}
            for var, nodes in self.destroyers_map.items():
                for n in nodes:
                    if n in fgraph.apply_nodes:
                        live = roots.setdefault(droot(var), [])
                        if n not in live:
                            live.append(n)
            self._roots, self._roots_key = roots, key
        return self._roots

    def _alias_members(self, fgraph) -> dict:
        """{root: the live variables whose view chain ends at it}, computed
        only where some storage is destroyed."""
        key = (id(fgraph), self._epoch)
        if self._members_key != key:
            members: Dict = defaultdict(set)
            for var in fgraph.variables:
                members[droot(var)].add(var)
            self._members, self._members_key = members, key
        return self._members

    def destroyers(self, var) -> list:
        """The nodes that destroy ``var`` or any alias of its storage."""
        if self.fgraph is None:
            return list(self.destroyers_map.get(var, []))
        if not any(self.destroyers_map.values()):
            return []
        return list(self._live_destroyed_roots(self.fgraph).get(droot(var), []))

    def has_destroyers(self, vars) -> bool:
        return any(self.destroyers(v) for v in vars)

    # -- checks and orderings ----------------------------------------------------

    def validate(self, fgraph):
        roots = self._live_destroyed_roots(fgraph)
        if roots:
            self._check(fgraph, {root: [(n, _destroyed_indices(n), ()) for n in nodes]
                                 for root, nodes in roots.items()})

    def _check(self, fgraph, roots) -> dict:
        """Raise InconsistencyError where the destroyers break a rule, else
        return their orderings.  ``roots`` maps a destroyed root to its
        destroyers, each as (node, the input positions it destroys, the
        positions that may hold the destroyed variable itself: its op's
        ``destroyhandler_tolerate_same`` and, for a donation, the positions
        an elementwise kernel reads where it writes)."""
        from aesara_tpu_torch.graph.ir import Constant

        members = self._alias_members(fgraph)
        protected = _protected(fgraph)
        for root, entries in roots.items():
            nodes = {n for n, _, _ in entries}
            # 1. one destroyer a storage, whichever view each went through
            if len(nodes) > 1:
                raise InconsistencyError(f"multiple in-place destroyers of {root}: {sorted(map(str, nodes))}")
            # 2. constants are immutable storage
            if isinstance(root, Constant):
                raise InconsistencyError(f"in-place op destroys constant {root} (through a view)")
            impact = members[root] | {root}
            # 3. a destroyer reading another alias of what it destroys
            # would read a storage it overwrites
            for node, destroyed, same in entries:
                for d in destroyed:
                    dv = node.inputs[d]
                    if droot(dv) is not root:
                        continue
                    tolerated = {j for i0, j in getattr(node.op, "destroyhandler_tolerate_same", []) if i0 == d}
                    tolerated |= {d, *same}
                    ignored = {j for i0, j in getattr(node.op, "destroyhandler_tolerate_aliased", []) if i0 == d}
                    for i, inp in enumerate(node.inputs):
                        if i not in ignored and inp in impact and (i not in tolerated or inp is not dv):
                            raise InconsistencyError(f"Input aliasing: {node} ({d}, {i})")
            # 4. destroying any alias of a protected variable destroys it
            hit = impact & protected
            if hit:
                raise InconsistencyError(f"in-place op destroys protected {next(iter(hit))}")
        # 5. every reader of a destroyed storage can run before its destroyer
        order = self._orderings_of(fgraph, {root: [n for n, _, _ in entries] for root, entries in roots.items()})
        if order and _contains_cycle(fgraph, order):
            raise InconsistencyError("in-place ordering constraints create a dependency cycle")
        return order

    def orderings(self, fgraph) -> dict:
        """Every reader of any alias of a destroyed storage runs before its
        destroyer."""
        roots = self._live_destroyed_roots(fgraph)
        return self._orderings_of(fgraph, roots) if roots else {}

    def _orderings_of(self, fgraph, roots) -> dict:
        members = self._alias_members(fgraph)
        order: Dict = {}
        for root, destroyers in roots.items():
            for destroyer in {getattr(d, "node", d) for d in destroyers}:
                readers = []
                for alias in members[root] | {root}:
                    for client, _ in fgraph.clients.get(alias, []):
                        if (client != "output" and client is not destroyer and client in fgraph.apply_nodes
                                and client not in readers):
                            readers.append(client)
                if readers:
                    before = order.setdefault(destroyer, [])
                    before.extend(r for r in readers if r not in before)
        return order

    def donations(self, fgraph, candidates: Sequence[Tuple]) -> Tuple[List, dict]:
        """The legal ones of ``candidates``, each (node, target, same): the
        node writes its output into the storage of ``target`` (a graph
        input the node need not read), ``same`` the positions at which it
        may read ``target`` itself (an elementwise kernel reads each value
        where it writes it).  Taken in order, each is kept where the graph's
        destroyers and the ones kept before it, with it, still pass every
        check of ``validate`` and where no alias of ``target`` is an output
        (the caller would get the overwritten value).  Returns (the kept
        candidates, the orderings that put every reader of a target before
        its writer, the graph's own with them)."""
        base = {root: [(n, _destroyed_indices(n), ()) for n in nodes]
                for root, nodes in self._live_destroyed_roots(fgraph).items()}
        members = self._alias_members(fgraph)
        outputs = set(fgraph.outputs)
        candidates = [c for c in candidates if not (members[droot(c[1])] | {droot(c[1])}) & outputs]

        def adding(roots, chosen):
            trial = {r: list(e) for r, e in roots.items()}
            for node, target, same in chosen:
                trial.setdefault(droot(target), []).append(
                    (_Donating(node, target), {len(node.inputs)}, tuple(same)))
            return trial

        # every rule holds for a subset of a consistent set, so where all of
        # them pass together (the common case) one check decides
        try:
            return list(candidates), self._check(fgraph, adding(base, candidates))
        except InconsistencyError:
            pass
        kept, order = [], self._orderings_of(fgraph, {r: [n for n, _, _ in e] for r, e in base.items()})
        for candidate in candidates:
            trial = adding(base, [candidate])
            try:
                trial_order = self._check(fgraph, trial)
            except InconsistencyError:
                continue
            base, order = trial, trial_order
            kept.append(candidate)
        return kept, order


class _Donating:
    """A node seen as destroying ``target``, a variable it may not read: its
    inputs and one more, the target, at the position past them."""

    def __init__(self, node, target):
        self.node = node
        self.op = node.op
        self.inputs = list(node.inputs) + [target]
        self.outputs = node.outputs

    def __eq__(self, other):
        return getattr(other, "node", other) is self.node

    def __hash__(self):
        return hash(self.node)

    def __str__(self):
        return f"{self.node} (writing into {self.inputs[-1]})"


class Supervisor(Feature):
    """Protects the variables in ``protected`` from being destroyed (the
    function's inputs that are not mutable and its shared variables that
    are not updated)."""

    def __init__(self, protected: Iterable):
        self.protected = list(protected)

    def validate(self, fgraph):
        if not hasattr(fgraph, "destroyers"):
            return
        for var in self.protected:
            if fgraph.destroyers(var):
                raise InconsistencyError(f"in-place op would destroy protected input {var}")

    def clone(self):
        return Supervisor(self.protected)


def add_destroy_handler(fgraph):
    """Attach a DestroyHandler unless one is there (the optdb entry at 49.5)."""
    if not hasattr(fgraph, "destroyers"):
        fgraph.attach_feature(DestroyHandler())
    return fgraph
