"""Rewrite databases: name/tag registries queried into rewriters
(reference ``graph/rewriting/db.py``)."""

from __future__ import annotations

import math
from typing import Iterable, Union


class RewriteDatabaseQuery:
    """Tag selector: include any of ``include``, minus any of ``exclude``."""

    def __init__(self, include: Iterable[str] = (), exclude: Iterable[str] = ()):
        self.include = frozenset(include)
        self.exclude = frozenset(exclude)

    def including(self, *tags: str) -> "RewriteDatabaseQuery":
        return RewriteDatabaseQuery(self.include | set(tags), self.exclude)

    def excluding(self, *tags: str) -> "RewriteDatabaseQuery":
        return RewriteDatabaseQuery(self.include, self.exclude | set(tags))

    def __str__(self):
        return f"RewriteDatabaseQuery(inc={sorted(self.include)}, exc={sorted(self.exclude)})"


class RewriteDatabase:
    """Name/tag registry of rewriters."""

    def __init__(self):
        self._by_tag: dict = {}
        self._names: dict = {}

    def register(self, name: str, rewriter, *tags: str) -> None:
        if name in self._names:
            raise ValueError(f"rewrite name {name!r} already registered")
        rewriter.name = name
        self._names[name] = rewriter
        for tag in (name,) + tags:
            self._by_tag.setdefault(tag, []).append(rewriter)

    def _selected(self, q: RewriteDatabaseQuery) -> list:
        """Registered entries matching ``q``, in registration order."""
        excluded = {id(rw) for tag in q.exclude for rw in self._by_tag.get(tag, [])}
        included = {id(rw) for tag in q.include for rw in self._by_tag.get(tag, [])}
        return [rw for rw in self._names.values()
                if id(rw) in included and id(rw) not in excluded]

    @staticmethod
    def _compiled(rw, q: RewriteDatabaseQuery):
        """A sub-database compiles under the same query."""
        return rw.query(q) if isinstance(rw, RewriteDatabase) else rw

    def __getitem__(self, name: str):
        return self._names[name]


class EquilibriumDB(RewriteDatabase):
    """Its query runs all selected node rewriters to a fixed point."""

    def query(self, q: RewriteDatabaseQuery):
        from aesara_tpu_torch.graph.rewriting.basic import EquilibriumGraphRewriter

        return EquilibriumGraphRewriter([self._compiled(rw, q) for rw in self._selected(q)])


class SequenceDB(RewriteDatabase):
    """Ordered by float positions; its query runs the selected rewriters
    in position order (by name within a position)."""

    def __init__(self):
        super().__init__()
        self._position: dict = {}

    def register(self, name, rewriter, *tags, position: Union[float, str] = "last"):
        super().register(name, rewriter, *tags)
        if position == "last":
            position = max(self._position.values(), default=0.0) + 1.0
        self._position[name] = float(position)

    def query(self, q: RewriteDatabaseQuery):
        from aesara_tpu_torch.graph.rewriting.basic import SequentialGraphRewriter

        # ties in position run by name, as in the JAX package
        picked = sorted(self._selected(q), key=lambda rw: (self._position.get(rw.name, math.inf), rw.name))
        return SequentialGraphRewriter(*[self._compiled(rw, q) for rw in picked])


class LocalGroupDB(SequenceDB):
    """Node rewriters applied as one local pass: its query is a
    ``SequentialNodeRewriter`` of the selected ones in position order
    (reference ``aesara_tpu/graph/rewriting/db.py:251``)."""

    def query(self, q: RewriteDatabaseQuery):
        from aesara_tpu_torch.graph.rewriting.basic import SequentialNodeRewriter

        picked = sorted(self._selected(q), key=lambda rw: (self._position.get(rw.name, math.inf), rw.name))
        return SequentialNodeRewriter(*picked)
