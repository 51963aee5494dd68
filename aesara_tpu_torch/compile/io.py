"""``Out``: an output spec of a compiled function (reference
``aesara_tpu/compile/io.py``).  ``In`` is not ported yet."""

from __future__ import annotations

from aesara_tpu_torch.graph.ir import Variable


__all__ = ["Out"]


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
