"""Symbolic reverse-mode differentiation (reference ``aesara_tpu/gradient.py:172-340``).

``grad(cost, wrt)`` walks the graph from the cost back to ``wrt`` in
reverse topological order, calls each node's ``Op.L_op`` with the
gradients of its outputs, and sums the terms that reach each variable.
The result is a graph like any other: ``function()`` rewrites and links
it, so the train step runs ``FusedAttentionGrad`` and the elemwise
gradients on the card as nodes of one compiled step.

Two marker types stand for gradients that are not tensors: a
``DisconnectedType`` variable is a structural zero (a shape input, say),
a ``NullType`` variable an undefined gradient (asking for one raises).
``Rop``, ``jacobian``, ``hessian``, ``verify_grad`` and the
gradient-manipulating ops are not ported.
"""

from __future__ import annotations

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Type, Variable, io_toposort
from aesara_tpu_torch.scalar.ops import discrete_dtypes


__all__ = ["grad", "DisconnectedType", "NullType", "disconnected_type", "grad_undefined",
           "NullTypeGradError"]


class DisconnectedType(Type):
    """The type of a gradient that is structurally zero."""

    def filter(self, data, strict=False, allow_downcast=None):
        return data

    def __eq__(self, other):
        return type(other) is DisconnectedType

    def __hash__(self):
        return hash(DisconnectedType)

    def __str__(self):
        return "DisconnectedType"


class NullType(Type):
    """The type of an undefined gradient; ``why_null`` says why."""

    def __init__(self, why_null: str = "(no explanation)"):
        self.why_null = why_null

    def filter(self, data, strict=False, allow_downcast=None):
        raise ValueError("NullType has no values")

    def __eq__(self, other):
        return type(other) is NullType

    def __hash__(self):
        return hash(NullType)

    def __str__(self):
        return "NullType"


def disconnected_type() -> Variable:
    return DisconnectedType()()


def grad_undefined(op, x_pos: int, x, comment: str = "") -> Variable:
    """The gradient of input ``x_pos`` of ``op`` does not exist."""
    return NullType(f"grad undefined for input {x_pos} of {op}: {comment}")()


class NullTypeGradError(TypeError):
    """An undefined gradient was asked for."""


def _is_disconnected(v) -> bool:
    return isinstance(getattr(v, "type", None), DisconnectedType)


def _is_null(v) -> bool:
    return isinstance(getattr(v, "type", None), NullType)


def _add_grads(a, b):
    """The sum of two gradient terms, either of which may be missing
    (None), a structural zero or undefined (which wins)."""
    if a is None or _is_disconnected(a):
        return b
    if b is None or _is_disconnected(b):
        return a
    if _is_null(a):
        return a
    if _is_null(b):
        return b
    from aesara_tpu_torch.scalar.ops import ScalarType, add as s_add
    from aesara_tpu_torch.tensor.math import add as t_add

    return s_add(a, b) if isinstance(a.type, ScalarType) else t_add(a, b)


def _float_dtype(dtype: str) -> str:
    return config.floatX if dtype in discrete_dtypes else dtype


def _ones_like_cost(cost):
    """d cost / d cost: ones shaped like the cost, in a float dtype."""
    from aesara_tpu_torch.tensor.basic import ones_like

    return ones_like(cost, dtype=_float_dtype(cost.type.dtype))


def _zeros_like_var(w):
    """The gradient of a variable the cost does not depend on."""
    from aesara_tpu_torch.tensor.basic import zeros_like

    return zeros_like(w, dtype=_float_dtype(w.type.dtype))


def grad(cost: Variable, wrt, disconnected_inputs: str = "raise"):
    """d cost / d wrt for a 0-d ``cost``; ``wrt`` is one variable or a
    list of them, and the result has the same form, each gradient named
    ``(dcost/dw)`` after its variable.

    A ``wrt`` the cost does not depend on raises
    (``disconnected_inputs="raise"``) or is given a zero gradient
    (``"ignore"``).  An undefined gradient raises ``NullTypeGradError``.
    ``consider_constant``, ``known_grads`` and the other options of the
    JAX package's ``grad`` are not ported.
    """
    if disconnected_inputs not in ("raise", "ignore"):
        raise ValueError(f"disconnected_inputs must be 'raise' or 'ignore', got {disconnected_inputs!r}")
    if cost is None:
        raise ValueError("grad needs a cost")
    if isinstance(cost.type, NullType):
        raise ValueError(f"cost is undefined: {cost.type.why_null}")
    if cost.type.ndim != 0:
        raise TypeError("cost must be a scalar (0-d) variable")
    single = not isinstance(wrt, (list, tuple))
    wrt_list = [wrt] if single else list(wrt)
    for w in wrt_list:
        if not isinstance(w, Variable):
            raise TypeError(f"wrt elements must be Variables, got {type(w)}")

    grad_dict = {cost: _ones_like_cost(cost)}
    nodes = io_toposort([], [cost])
    # the variables through which some wrt reaches the cost
    influences = set(wrt_list)
    for node in nodes:
        if any(i in influences for i in node.inputs):
            influences.update(node.outputs)

    for node in reversed(nodes):
        if not any(o in grad_dict for o in node.outputs):
            continue
        if not any(i in influences for i in node.inputs):
            continue
        ograds = []
        for o in node.outputs:
            if o in grad_dict:
                ograds.append(grad_dict[o])
            elif o.type.dtype in discrete_dtypes:
                ograds.append(disconnected_type())
            else:
                ograds.append(_zeros_like_var(o))
        if all(_is_disconnected(g) for g in ograds):
            continue
        null = next((g for g in ograds if _is_null(g)), None)
        if null is not None:
            for inp in node.inputs:
                if inp in influences:
                    grad_dict[inp] = _add_grads(grad_dict.get(inp), null)
            continue
        igrads = node.op.L_op(node.inputs, node.outputs, ograds)
        if len(igrads) != len(node.inputs):
            raise ValueError(f"{node.op}.L_op returned {len(igrads)} gradients for "
                             f"{len(node.inputs)} inputs")
        # an input takes a gradient only through the outputs it is
        # connected to that carry one
        pattern = node.op.connection_pattern(node)
        live = [o in grad_dict and not _is_disconnected(grad_dict[o]) for o in node.outputs]
        for slot, (inp, ig) in enumerate(zip(node.inputs, igrads)):
            if ig is None or _is_disconnected(ig):
                continue
            if not any(pattern[slot][j] for j in range(len(live)) if live[j]):
                continue
            if inp not in influences:
                continue
            if inp.type.dtype in discrete_dtypes:
                # a discrete variable stays connected, with a zero gradient
                if not _is_null(ig) and inp not in grad_dict:
                    grad_dict[inp] = _zeros_like_var(inp)
                continue
            grad_dict[inp] = _add_grads(grad_dict.get(inp), ig)

    results = []
    for w in wrt_list:
        g = grad_dict.get(w)
        if g is None and disconnected_inputs == "raise":
            raise ValueError(f"grad: input {w} is disconnected from the cost")
        if g is None or _is_disconnected(g):
            g = _zeros_like_var(w)
        elif _is_null(g):
            raise NullTypeGradError(f"grad is undefined: {g.type.why_null}")
        if w.name:
            g.name = f"(d{cost.name or 'cost'}/d{w.name})"
        results.append(g)
    return results[0] if single else results
