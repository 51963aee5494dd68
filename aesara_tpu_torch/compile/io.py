"""``In`` and ``Out``: the input and output specs of a compiled function
(reference ``aesara_tpu/compile/io.py``)."""

from __future__ import annotations

from typing import Any, Optional

from aesara_tpu_torch.graph.ir import Variable


__all__ = ["SymbolicInput", "In", "Out"]


class SymbolicInput:
    """One input slot of a compiled function.

    - ``name``: the keyword the function takes it by (default: the
      variable's name, with ``autoname``).
    - ``value``: its default when a call does not give it.
    - ``update``: an expression of the function's inputs; after each call
      its value becomes this input's default (the input's own state).
    - ``mutable``: the function may write to the value given (default:
      whether there is an ``update``); the port never does.
    - ``strict``: the value must have the variable's dtype exactly;
      ``allow_downcast``: a value may be cast to a narrower dtype.
    """

    def __init__(self, variable: Variable, name: Optional[str] = None, update: Optional[Variable] = None,
                 mutable: Optional[bool] = None, strict: bool = False, allow_downcast=None,
                 autoname: bool = True, value: Any = None):
        if not isinstance(variable, Variable):
            raise TypeError(f"In takes a Variable, got {type(variable)}")
        self.variable = variable
        self.name = name if name is not None else (variable.name if autoname else None)
        self.update = None if update is None else variable.type.filter_variable(update, allow_convert=True)
        self.mutable = mutable if mutable is not None else update is not None
        self.strict = strict
        self.allow_downcast = allow_downcast
        self.value = value

    def __str__(self):
        if self.update is not None:
            return f"In({self.variable} -> {self.update})"
        return f"In({self.variable})"

    __repr__ = __str__


class In(SymbolicInput):
    """The user's input spec.  ``borrow`` (default: ``mutable``) lets the
    function keep the caller's value without a copy.  ``batched`` and
    ``seq_bucketed`` belong to shape bucketing (``compile/bucketing.py``):
    ``batched=True`` makes only the marked inputs pad their leading dim,
    ``batched=False`` keeps an input out; ``seq_bucketed=axis`` zero-pads
    that axis."""

    def __init__(self, variable: Variable, name: Optional[str] = None, value: Any = None,
                 update: Optional[Variable] = None, mutable: Optional[bool] = None, strict: bool = False,
                 allow_downcast=None, autoname: bool = True, borrow: Optional[bool] = None,
                 batched: Optional[bool] = None,
                 seq_bucketed: Optional[int] = None):
        if borrow is None:
            borrow = mutable if mutable is not None else False
        super().__init__(variable, name=name, update=update, mutable=mutable, strict=strict,
                         allow_downcast=allow_downcast, autoname=autoname, value=value)
        self.borrow = bool(borrow)
        self.batched = batched
        self.seq_bucketed = seq_bucketed


class Out:
    """One output of ``function()``.

    With ``borrow=False`` (the default) the returned tensor shares no
    storage with a shared variable or an argument of the call, so the
    caller may write to it.  With ``borrow=True`` it is returned as the
    graph computed it, which may be a shared variable's own storage or a
    view of it: a train loop that only keeps the loss on the card, as
    ``Out(loss, borrow=True)``, skips that check and that copy.
    """

    def __init__(self, variable: Variable, borrow: bool = False):
        if not isinstance(variable, Variable):
            raise TypeError(f"Out takes a Variable, got {type(variable)}")
        self.variable = variable
        self.borrow = bool(borrow)

    def __repr__(self):
        return f"Out({self.variable}, borrow={self.borrow})"
