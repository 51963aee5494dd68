"""Core graph IR: ``Type``, ``Variable``, ``Apply``, ``Constant`` and the
traversal, clone and toposort helpers.

The counterpart of ``aesara_tpu/graph/ir.py``, cut to what the port's
compile path uses.  The IR is a bipartite DAG of ``Apply`` nodes (an
``Op`` applied to input Variables) and ``Variable`` nodes.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np

from aesara_tpu_torch.graph.utils import Scratchpad, add_tag_trace


__all__ = [
    "Type", "Variable", "AtomicVariable", "Constant", "Apply", "walk",
    "ancestors", "graph_inputs", "clone", "clone_get_equiv", "clone_replace", "io_toposort",
    "equal_computations",
]


class Type:
    """The contract a value must satisfy to inhabit a :class:`Variable`."""

    variable_type: type = None  # set after Variable is defined
    constant_type: type = None  # set after Constant is defined

    def filter(self, data: Any, strict: bool = False, allow_downcast=None) -> Any:
        raise NotImplementedError(f"{type(self).__name__}.filter")

    def filter_variable(self, other: Any, allow_convert: bool = True) -> "Variable":
        if not isinstance(other, Variable):
            other = self.constant_type(type=self, data=other)
        if other.type == self or self.is_super(other.type):
            return other
        if allow_convert:
            converted = self.convert_variable(other)
            if converted is not None:
                return converted
        raise TypeError(f"Cannot convert Variable of type {other.type} into type {self}.")

    def convert_variable(self, var: "Variable") -> Optional["Variable"]:
        return var if self.is_super(var.type) else None

    def is_super(self, otype: "Type") -> bool:
        return self == otype

    def make_variable(self, name: Optional[str] = None) -> "Variable":
        return self.variable_type(self, None, None, name=name)

    def __call__(self, name: Optional[str] = None) -> "Variable":
        return add_tag_trace(self.make_variable(name))

    def clone(self, **kwargs) -> "Type":
        return self


#: a process-wide creation stamp of Apply nodes (``Apply.epoch``)
_apply_epoch = itertools.count()


class Apply:
    """One application of an :class:`Op` to input Variables.

    ``epoch`` is a process-wide monotone creation stamp; ``scan`` uses it
    to find the nodes its step function built (reference
    ``aesara_tpu/graph/ir.py:149-169``)."""

    __slots__ = ("op", "inputs", "outputs", "tag", "epoch")

    def __init__(self, op, inputs: Sequence["Variable"], outputs: Sequence["Variable"]):
        self.op = op
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.tag = Scratchpad()
        self.epoch = next(_apply_epoch)
        for v in self.inputs:
            if not isinstance(v, Variable):
                raise TypeError(f"Apply inputs must be Variables, got {type(v)}")
        for i, v in enumerate(self.outputs):
            if not isinstance(v, Variable):
                raise TypeError(f"Apply outputs must be Variables, got {type(v)}")
            if v.owner is not None and v.owner is not self:
                raise ValueError("Variable already owned by another Apply")
            v.owner = self
            v.index = i

    def clone_with_new_inputs(self, inputs: Sequence["Variable"], strict: bool = True) -> "Apply":
        """Rebuild this node over new inputs.  With ``strict`` the new
        inputs' types must be compatible; otherwise ``make_node`` re-runs."""
        if len(inputs) != len(self.inputs):
            raise ValueError("wrong number of inputs")
        remake = False
        coerced = list(inputs)
        for i, (cur, new) in enumerate(zip(self.inputs, inputs)):
            if not cur.type.is_super(new.type):
                if strict:
                    conv = cur.type.convert_variable(new)
                    if conv is None:
                        raise TypeError(f"Cannot convert {new} of type {new.type} to {cur.type}")
                    coerced[i] = conv
                else:
                    remake = True
        if remake:
            return self.op.make_node(*coerced)
        new_node = Apply(self.op, coerced, [o.clone() for o in self.outputs])
        new_node.tag = Scratchpad().__update__(self.tag)
        return new_node

    def __str__(self) -> str:
        return f"{self.op}({', '.join(map(str, self.inputs))})"

    __repr__ = __str__


class Variable:
    """A typed node of the graph.  ``owner`` is the Apply that computes it
    (None for graph inputs); ``index`` its position in ``owner.outputs``."""

    def __init__(self, type: Type, owner: Optional[Apply] = None,
                 index: Optional[int] = None, name: Optional[str] = None):
        self.type = type
        self.owner = owner
        self.index = index
        self.name = name
        self.tag = Scratchpad()

    def clone(self, **kwargs) -> "Variable":
        cp = self.__class__(type=kwargs.pop("type", self.type), owner=None,
                            index=None, name=kwargs.pop("name", self.name))
        cp.tag = Scratchpad().__update__(self.tag)
        return cp

    def __str__(self) -> str:
        if self.name is not None:
            return self.name
        if self.owner is not None:
            if len(self.owner.outputs) == 1:
                return f"{self.owner.op}.out"
            return f"{self.owner.op}.{self.index}"
        return f"<{self.type}>"

    __repr__ = __str__


class AtomicVariable(Variable):
    """A Variable with no owner by construction."""

    def __init__(self, type: Type, name: Optional[str] = None, **kwargs):
        super().__init__(type=type, owner=None, index=None, name=name, **kwargs)

    @property
    def owner(self):
        return None

    @owner.setter
    def owner(self, value):
        if value is not None:
            raise ValueError("AtomicVariable cannot have an owner")

    @property
    def index(self):
        return None

    @index.setter
    def index(self, value):
        if value is not None:
            raise ValueError("AtomicVariable cannot have an index")

    def signature(self):
        raise NotImplementedError

    def merge_signature(self):
        return self.signature()


class Constant(AtomicVariable):
    """A Variable with a fixed value."""

    def __init__(self, type: Type, data: Any, name: Optional[str] = None):
        super().__init__(type, name=name)
        self.data = type.filter(data)

    def signature(self):
        data = self.data
        if isinstance(data, np.ndarray):
            return (self.type, data.shape, str(data.dtype), data.tobytes())
        return (self.type, data)

    def __str__(self) -> str:
        if self.name is not None:
            return self.name
        s = repr(self.data)
        return s if len(s) <= 20 else s[:17] + "..."

    def clone(self, **kwargs) -> "Constant":
        return self


Type.variable_type = Variable
Type.constant_type = Constant


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def walk(nodes: Iterable, expand: Callable, bfs: bool = True):
    """Generic graph walk from ``nodes`` through ``expand``."""
    q: deque = deque(nodes)
    seen: set = set()
    pop = q.popleft if bfs else q.pop
    while q:
        node = pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        children = expand(node)
        if children:
            q.extend(children)
        yield node


def ancestors(graphs: Iterable[Variable], blockers=None) -> list:
    """All Variables reachable backwards from ``graphs``."""
    blockers = set(map(id, blockers)) if blockers else set()

    def expand(v):
        if v.owner is not None and id(v) not in blockers:
            return reversed(v.owner.inputs)
        return None

    return list(walk(graphs, expand, bfs=False))


def graph_inputs(graphs: Iterable[Variable], blockers=None) -> list:
    """Ownerless Variables the graphs depend on."""
    return [v for v in ancestors(graphs, blockers) if v.owner is None]


def clone_get_equiv(inputs: Sequence[Variable], outputs: Sequence[Variable],
                    copy_inputs: bool = True, copy_orphans: bool = True,
                    memo: Optional[dict] = None) -> dict:
    """Clone the subgraph between inputs and outputs; return old→new."""
    if memo is None:
        memo = {}
    for inp in inputs:
        if inp not in memo:
            memo[inp] = inp.clone() if copy_inputs else inp
    for node in io_toposort(inputs, outputs):
        for inp in node.inputs:
            if inp not in memo:
                memo[inp] = inp.clone() if copy_orphans else inp
        if node not in memo:
            new_node = node.clone_with_new_inputs([memo[i] for i in node.inputs], strict=False)
            memo[node] = new_node
            for old_o, new_o in zip(node.outputs, new_node.outputs):
                memo.setdefault(old_o, new_o)
    for out in outputs:
        if out not in memo:
            memo[out] = out.clone() if copy_orphans else out
    return memo


def clone(inputs: Sequence[Variable], outputs: Sequence[Variable], copy_inputs: bool = True):
    """Copy a subgraph; returns (new_inputs, new_outputs)."""
    equiv = clone_get_equiv(inputs, outputs, copy_inputs, copy_inputs)
    return [equiv[i] for i in inputs], [equiv[o] for o in outputs]


def clone_replace(output, replace=None):
    """A copy of the graph of ``output`` (a variable or a list of them) in
    which each key of ``replace`` (a dict or pairs) is the variable given
    for it; the graph's other inputs are kept, not copied."""
    single = isinstance(output, Variable)
    outputs = [output] if single else list(output)
    items = list(replace.items()) if isinstance(replace, dict) else list(replace or [])
    memo = {old: old.type.filter_variable(new, allow_convert=True) for old, new in items}
    inputs = graph_inputs(outputs, blockers=list(memo))
    equiv = clone_get_equiv(inputs, outputs, copy_inputs=False, copy_orphans=False, memo=memo)
    result = [equiv[o] for o in outputs]
    return result[0] if single else result


def io_toposort(inputs: Iterable[Variable], outputs: Iterable[Variable]) -> list:
    """Topologically sorted Apply nodes between inputs and outputs
    (iterative DFS post-order)."""
    seen_vars = set(map(id, inputs))
    visited: set = set()
    result: list = []
    work = [(o.owner, False) for o in outputs
            if o.owner is not None and id(o) not in seen_vars]
    while work:
        node, processed = work.pop()
        if processed:
            result.append(node)
            continue
        if id(node) in visited:
            continue
        visited.add(id(node))
        work.append((node, True))
        for inp in reversed(node.inputs):
            if id(inp) not in seen_vars and inp.owner is not None:
                if id(inp.owner) not in visited:
                    work.append((inp.owner, False))
    return result


def equal_computations(xs: Sequence[Variable], ys: Sequence[Variable],
                       in_xs: Sequence[Variable] = (), in_ys: Sequence[Variable] = ()) -> bool:
    """Structural equality of two graphs."""
    if len(xs) != len(ys) or len(in_xs) != len(in_ys):
        raise ValueError("xs/ys and in_xs/in_ys must have equal lengths")
    if any(ix.type != iy.type for ix, iy in zip(in_xs, in_ys)):
        return False
    common = set(zip(in_xs, in_ys))
    memo: dict = {}

    def eq(x, y) -> bool:
        # one variable computes the same as itself when no inputs are
        # renamed (else only a root does): the walk stops there instead of
        # going down the whole shared graph
        if (x, y) in common or (x is y and (x.owner is None or not common)):
            return True
        if isinstance(x, Constant) or isinstance(y, Constant):
            return (isinstance(x, Constant) and isinstance(y, Constant)
                    and x.type == y.type
                    and bool(np.array_equal(np.asarray(x.data), np.asarray(y.data))))
        if x.owner is None or y.owner is None or x.index != y.index:
            return False
        key = (x.owner, y.owner)
        if key not in memo:
            nx, ny = key
            memo[key] = (nx.op == ny.op and len(nx.inputs) == len(ny.inputs)
                         and all(eq(a, b) for a, b in zip(nx.inputs, ny.inputs)))
        return memo[key]

    return all(eq(x, y) for x, y in zip(xs, ys))
