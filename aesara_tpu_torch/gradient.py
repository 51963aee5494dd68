"""Symbolic reverse-mode differentiation (reference ``aesara_tpu/gradient.py``).

``grad(cost, wrt)`` walks the graph from the cost (and from the
variables of ``known_grads``) back to ``wrt`` in reverse topological
order, calls each node's ``Op.L_op`` with the gradients of its outputs,
and sums the terms that reach each variable.  The result is a graph like
any other: ``function()`` rewrites and links it, so the train step runs
``FusedAttentionGrad`` and the elemwise gradients on the card as nodes of
one compiled step.  ``Lop`` and ``subgraph_grad`` are ``grad`` with
given output gradients; ``numeric_grad``/``verify_grad`` check a
gradient against central differences.

Two marker types stand for gradients that are not tensors: a
``DisconnectedType`` variable is a structural zero (a shape input, say),
a ``NullType`` variable an undefined gradient (asking for one raises,
unless ``null_gradients="return"``).

The gradient manipulators (``zero_grad``, ``disconnected_grad``,
``undefined_grad``, ``grad_clip``, ``grad_scale``, ``consider_constant``)
are identities in the forward graph with their own gradient.

``jacobian`` and ``hessian`` are scans over the rows of a gradient, as
in the JAX package.  ``Rop`` waits for ``R_op`` on the rest of the op
table (``Scan.R_op`` with it).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Apply, Type, Variable, io_toposort
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import discrete_dtypes


__all__ = ["grad", "Lop", "subgraph_grad", "numeric_grad", "verify_grad", "GradientError",
           "DisconnectedType", "NullType", "disconnected_type", "grad_undefined", "grad_not_implemented",
           "NullTypeGradError",
           "GradManipulatorOp", "ZeroGrad", "DisconnectedGrad", "UndefinedGrad", "GradClip", "GradScale",
           "zero_grad", "disconnected_grad", "undefined_grad", "grad_clip", "grad_scale",
           "consider_constant", "jacobian", "hessian", "Rop"]


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


def grad_not_implemented(op, x_pos: int, x, comment: str = "") -> Variable:
    """The gradient of input ``x_pos`` of ``op`` exists but is not built."""
    return NullType(f"grad not implemented for input {x_pos} of {op}: {comment}")()


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


def grad(cost: Optional[Variable], wrt, consider_constant: Optional[Sequence[Variable]] = None,
         disconnected_inputs: str = "raise", add_names: bool = True,
         known_grads: Optional[dict] = None, return_disconnected: str = "zero",
         null_gradients: str = "raise"):
    """d cost / d wrt for a 0-d ``cost``; ``wrt`` is one variable or a
    list of them, and the result has the same form.

    - ``consider_constant``: variables that take a gradient themselves but
      pass none on to their inputs.
    - ``known_grads``: {variable: its gradient}, added to what the walk
      gives it; with ``cost=None`` they are the only sources.
    - ``disconnected_inputs``: a ``wrt`` the cost does not depend on
      raises (``"raise"``), warns (``"warn"``) or passes (``"ignore"``).
    - ``return_disconnected``: such a ``wrt`` gets a zero (``"zero"``),
      None (``"none"``) or a ``DisconnectedType`` marker
      (``"disconnected"``).
    - ``null_gradients``: an undefined gradient raises
      ``NullTypeGradError`` (``"raise"``) or is returned as its
      ``NullType`` marker (``"return"``).
    - ``add_names``: name each gradient ``(dcost/dw)`` after its variable.
    """
    if disconnected_inputs not in ("raise", "warn", "ignore"):
        raise ValueError(f"disconnected_inputs must be 'raise', 'warn' or 'ignore', got {disconnected_inputs!r}")
    if return_disconnected.lower() not in ("zero", "none", "disconnected"):
        raise ValueError(f"return_disconnected must be 'zero', 'none' or 'disconnected', "
                         f"got {return_disconnected!r}")
    if null_gradients not in ("raise", "return"):
        raise ValueError(f"null_gradients must be 'raise' or 'return', got {null_gradients!r}")
    if cost is None and not known_grads:
        raise ValueError("grad needs a cost or known_grads")
    if cost is not None and isinstance(cost.type, NullType):
        raise ValueError(f"cost is undefined: {cost.type.why_null}")
    if cost is not None and cost.type.ndim != 0:
        raise TypeError("cost must be a scalar (0-d) variable")
    single = not isinstance(wrt, (list, tuple))
    wrt_list = [wrt] if single else list(wrt)
    for w in wrt_list:
        if not isinstance(w, Variable):
            raise TypeError(f"wrt elements must be Variables, got {type(w)}")

    grad_dict: dict = {}
    end_points = []
    if cost is not None:
        grad_dict[cost] = _ones_like_cost(cost)
        end_points.append(cost)
    for var, g in (known_grads or {}).items():
        if not _is_disconnected(g):
            g = var.type.filter_variable(g, allow_convert=True)
        grad_dict[var] = _add_grads(grad_dict.get(var), g)
        end_points.append(var)

    cc = set(consider_constant or [])
    nodes = io_toposort([], end_points)
    # the variables through which some wrt reaches an end point; nothing
    # passes through a node whose outputs are all constant to the walk
    influences = set(wrt_list)
    for node in nodes:
        if any(i in influences for i in node.inputs) and not all(o in cc for o in node.outputs):
            influences.update(node.outputs)

    for node in reversed(nodes):
        if not any(o in grad_dict for o in node.outputs):
            continue
        if not any(i in influences for i in node.inputs):
            continue
        ograds = []
        for o in node.outputs:
            if o in cc:
                ograds.append(disconnected_type())
            elif o in grad_dict:
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
        live = [o in grad_dict and o not in cc and not _is_disconnected(grad_dict[o])
                for o in node.outputs]
        for slot, (inp, ig) in enumerate(zip(node.inputs, igrads)):
            if ig is None or _is_disconnected(ig):
                continue
            if not any(pattern[slot][j] for j in range(len(live)) if live[j]):
                continue
            if inp not in influences and inp not in cc:
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
        if g is None or _is_disconnected(g):
            if g is None and disconnected_inputs == "raise":
                raise ValueError(f"grad: input {w} is disconnected from the cost")
            if g is None and disconnected_inputs == "warn":
                warnings.warn(f"grad: input {w} is disconnected from the cost")
            how = return_disconnected.lower()
            g = _zeros_like_var(w) if how == "zero" else None if how == "none" else disconnected_type()
        elif _is_null(g) and null_gradients == "raise":
            raise NullTypeGradError(f"grad is undefined: {g.type.why_null}")
        if add_names and g is not None and cost is not None and w.name:
            g.name = f"(d{cost.name or 'cost'}/d{w.name})"
        results.append(g)
    return results[0] if single else results


def Lop(f, wrt, eval_points, consider_constant=None, disconnected_inputs="raise"):
    """v^T (df / dwrt): ``grad`` with the output gradients ``eval_points``
    given for the outputs ``f``."""
    if not isinstance(f, (list, tuple)):
        f, eval_points = [f], [eval_points]
    return grad(None, wrt, known_grads=dict(zip(f, eval_points)), consider_constant=consider_constant,
                disconnected_inputs=disconnected_inputs)


def _as_type(v, t):
    """``v`` as a variable of type ``t``: a value as a constant, a variable
    of a less static shape behind a ``SpecifyShape`` (the JAX package's
    ``convert_variable``)."""
    from aesara_tpu_torch.tensor.shape import specify_shape
    from aesara_tpu_torch.tensor.type import TensorType

    if not isinstance(v, Variable):
        return t.filter_variable(v, allow_convert=True)
    if v.type == t or t.is_super(v.type):
        return v
    if (isinstance(t, TensorType) and isinstance(v.type, TensorType) and v.type.dtype == t.dtype
            and v.type.ndim == t.ndim
            and all(a is None or b is None or a == b for a, b in zip(t.shape, v.type.shape))):
        return specify_shape(v, t.shape)
    return t.filter_variable(v, allow_convert=True)


def _rop_via_op_rop(fs, wrts, evs):
    """Forward mode through each op's ``R_op``: tangents walk from the
    inputs to the outputs; a node that no tangent reaches is skipped."""
    from aesara_tpu_torch.graph.ir import graph_inputs

    tangents: dict = {}
    for w, ev in zip(wrts, evs):
        tangents[w] = _as_type(ev, w.type)
    for node in io_toposort(graph_inputs(fs), fs):
        if not any(i in tangents for i in node.inputs):
            continue
        eval_points = [tangents.get(i) for i in node.inputs]
        try:
            rops = node.op.R_op(node.inputs, eval_points)
        except NotImplementedError as e:
            raise NotImplementedError(f"{node.op} has no R_op rule (forward mode); use the default "
                                      "double-backward Rop (use_op_rop=False)") from e
        for out, r in zip(node.outputs, rops):
            if r is not None:
                tangents[out] = _as_type(r, out.type)
    return [tangents.get(f) for f in fs]  # None: disconnected


def _apply_disconnected_output_policy(results, fs, policy, zeros_fn):
    """The raise/warn/zeros policy for the Rop outputs that no tangent
    reaches, shared by both constructions."""
    for i, (fi, r) in enumerate(zip(fs, results)):
        if r is None or _is_disconnected(r):
            if policy == "raise":
                raise DisconnectedInputError(f"Rop: output {fi} is not connected to any wrt")
            if policy == "warn":
                warnings.warn(f"Rop: output {fi} is not connected to any wrt")
            results[i] = zeros_fn(fi)
    return results


def Rop(f, wrt, eval_points, disconnected_outputs="raise", use_op_rop=False):
    """The R-operator (df/dwrt) v.

    By default the Lop-of-Lop ("double-backward") construction: ``grad``
    of the inner product of ``grad`` with dummy cotangents and ``v``, with
    respect to those cotangents; it needs no rule of its own per op.
    ``use_op_rop=True`` walks the graph forward through each op's
    ``R_op`` instead, a Scan through ``Scan.R_op``."""
    from aesara_tpu_torch.graph.ir import clone_replace
    from aesara_tpu_torch.tensor.math import add as tadd, mul as tmul, sum as tsum

    single = not isinstance(f, (list, tuple))
    fs = [f] if single else list(f)
    wrts = [wrt] if not isinstance(wrt, (list, tuple)) else list(wrt)
    evs = [eval_points] if not isinstance(eval_points, (list, tuple)) else list(eval_points)
    if len(evs) != len(wrts):
        raise ValueError(f"Rop: {len(wrts)} wrt variables but {len(evs)} eval points")
    if use_op_rop:
        from aesara_tpu_torch.tensor.basic import zeros_like

        results = _apply_disconnected_output_policy(_rop_via_op_rop(fs, wrts, evs), fs, disconnected_outputs,
                                                    zeros_like)
        return results[0] if single else results
    us = []
    for fi in fs:
        u = fi.type()
        u.name = "rop_dummy_u"
        us.append(u)
    gs = grad(cost=None, wrt=wrts, known_grads=dict(zip(fs, us)), disconnected_inputs="ignore",
              return_disconnected="zero")
    if not isinstance(gs, (list, tuple)):
        gs = [gs]
    inner = None
    for g, v in zip(gs, evs):
        v = _as_type(v, g.type)
        term = tsum(tmul(g, v)) if g.type.ndim else tmul(g, v)
        inner = term if inner is None else tadd(inner, term)
    rops = grad(cost=None, wrt=us, known_grads={inner: _ones_like_cost(inner)}, disconnected_inputs="ignore",
                return_disconnected="disconnected")
    if not isinstance(rops, (list, tuple)):
        rops = [rops]
    rops = _apply_disconnected_output_policy(rops, fs, disconnected_outputs, _zeros_like_var)
    # the result is linear in u and does not depend on its value, but a
    # broadcast template (fill) may still name it: put in a zero of its shape
    rops = clone_replace(rops, replace={u: _zeros_like_var(fi) for u, fi in zip(us, fs)})
    return rops[0] if single else rops


def jacobian(expression, wrt, consider_constant=None, disconnected_inputs="raise"):
    """The Jacobian of a 0-d or 1-d ``expression``: its rows are the
    gradients of its entries, computed by a scan over them (as the JAX
    package builds it, ``aesara_tpu/gradient.py:535``)."""
    from aesara_tpu_torch.scan.basic import scan
    from aesara_tpu_torch.tensor.basic import arange
    from aesara_tpu_torch.tensor.shape import shape

    if expression.type.ndim > 1:
        raise ValueError("jacobian expects a 0/1-d expression")
    single = not isinstance(wrt, (list, tuple))
    wrts = [wrt] if single else list(wrt)
    if expression.type.ndim == 0:
        res = grad(expression, wrts, consider_constant=consider_constant, disconnected_inputs=disconnected_inputs)
        return res[0] if single else res

    def inner(i, expr, *args):
        return grad(expr[i], wrts, consider_constant=consider_constant, disconnected_inputs=disconnected_inputs)

    rows, _ = scan(inner, sequences=[arange(shape(expression)[0])], non_sequences=[expression] + wrts)
    if single:
        return rows if not isinstance(rows, (list, tuple)) else rows[0]
    return rows


def hessian(cost, wrt, consider_constant=None, disconnected_inputs="raise"):
    """The Hessian of a 0-d ``cost`` with respect to vectors: a scan over
    the rows of the gradient (``aesara_tpu/gradient.py:569``)."""
    from aesara_tpu_torch.scan.basic import scan
    from aesara_tpu_torch.tensor.basic import arange
    from aesara_tpu_torch.tensor.shape import shape

    if cost.type.ndim != 0:
        raise TypeError("hessian cost must be scalar")
    single = not isinstance(wrt, (list, tuple))
    wrts = [wrt] if single else list(wrt)
    out = []
    for w in wrts:
        if w.type.ndim != 1:
            raise ValueError("hessian wrt must be vectors")
        g = grad(cost, w, consider_constant=consider_constant, disconnected_inputs=disconnected_inputs)
        rows, _ = scan(lambda i, gy, x: grad(gy[i], x, disconnected_inputs="ignore"),
                       sequences=[arange(shape(g)[0])], non_sequences=[g, w])
        out.append(rows)
    return out[0] if single else out


def subgraph_grad(wrt, end, start=None, cost=None, details=False):
    """The gradients of ``wrt`` and ``end`` through the graph between
    them, seeded by ``start`` ({variable: gradient}) and/or by ``cost``;
    both walks stop at ``end``, so a path through it is counted once.
    Returns (wrt grads, end grads), and the start and cost parts too
    with ``details``."""
    if cost is None and start is None:
        raise ValueError("need cost and/or start")
    if not isinstance(end, list):
        raise TypeError("`end` must be a list")
    if not isinstance(wrt, list):
        raise TypeError("`wrt` must be a list")
    if start is not None and not isinstance(start, dict):
        raise TypeError("`start` must be a dictionary")
    params = list(dict.fromkeys(list(wrt) + list(end)))
    start_grads = cost_grads = None
    if start is not None:
        start_grads = list(grad(None, params, known_grads=start, consider_constant=end,
                                disconnected_inputs="ignore"))
    if cost is not None:
        cost_grads = list(grad(cost, params, consider_constant=end, disconnected_inputs="ignore"))
    if start is None:
        grads = cost_grads
    elif cost_grads is None:
        grads = start_grads
    else:
        grads = [g + cg for g, cg in zip(start_grads, cost_grads)]
    by_var = dict(zip(params, grads))
    wrt_grads, end_grads = [by_var[k] for k in wrt], [by_var[k] for k in end]
    if details:
        return wrt_grads, end_grads, start_grads, cost_grads
    return wrt_grads, end_grads


# ---------------------------------------------------------------------------
# numeric checking
# ---------------------------------------------------------------------------

class DisconnectedInputError(ValueError):
    """An output or input that ``Rop`` was asked about is disconnected, with
    the policy ``"raise"``."""


class GradientError(Exception):
    """The symbolic and the numeric gradient disagree."""

    def __init__(self, arg, err_pos, shape, val1, val2, abs_err, rel_err, abs_tol, rel_tol):
        super().__init__()
        self.args_ = (arg, err_pos, shape, val1, val2, abs_err, rel_err, abs_tol, rel_tol)

    def __str__(self):
        arg, err_pos, shape, val1, val2, abs_err, rel_err, abs_tol, rel_tol = self.args_
        return (f"GradientError: numeric gradient and symbolic gradient disagree for argument {arg} "
                f"at position {err_pos} (shape {shape}): analytic={val1}, numeric={val2}, "
                f"abs err={abs_err} (tol {abs_tol}), rel err={rel_err} (tol {rel_tol})")


def _host(value) -> np.ndarray:
    """A function's result (a torch tensor on any device) as NumPy."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class numeric_grad:
    """Central differences of a scalar function ``f`` at the point ``pt``
    (a list of arrays): ``self.gf`` holds one float64 gradient per array
    (zeros for a discrete one)."""

    def __init__(self, f, pt, eps=None):
        self.f = f
        # owned C-ordered copies: the loop writes through flat views
        self.pt = [np.array(p, order="C") for p in pt]
        dtypes = {p.dtype for p in self.pt if p.dtype.kind == "f"}
        smallest = min((np.finfo(dt).eps for dt in dtypes), default=np.finfo(np.float64).eps)
        if eps is None:
            eps = max(smallest * 1e4, 1e-7)
        self.eps = eps
        self.gf = [np.zeros_like(p, dtype=np.float64) for p in self.pt]
        for argi, p in enumerate(self.pt):
            if p.dtype.kind != "f":
                continue
            flat, gflat = p.reshape(-1), self.gf[argi].reshape(-1)
            for i in range(flat.size):
                orig = flat[i]
                flat[i] = orig + eps
                fp = _host(f(*self.pt)).astype(np.float64)
                flat[i] = orig - eps
                fm = _host(f(*self.pt)).astype(np.float64)
                flat[i] = orig
                gflat[i] = (fp - fm) / (2 * eps)

    @staticmethod
    def abs_rel_err(a, b):
        return abs(a - b), abs(a - b) / (abs(a) + abs(b) + 1e-8)

    def max_err(self, g_pt, abs_tol, rel_tol):
        """(argument, flat position, abs err, rel err) of the worst entry,
        each error scaled by its tolerance (> 1: both are exceeded)."""
        if len(g_pt) != len(self.gf):
            raise ValueError("argument count mismatch", len(g_pt), len(self.gf))
        pos, errs, abs_errs, rel_errs = [], [], [], []
        for a, b in zip(g_pt, self.gf):
            abs_err, rel_err = self.abs_rel_err(np.asarray(a, dtype=np.float64), b)
            if abs_err.size == 0:
                pos.append(0)
                errs.append(0.0)
                abs_errs.append(0.0)
                rel_errs.append(0.0)
                continue
            scaled = np.minimum(abs_err / abs_tol, rel_err / rel_tol)
            i = int(scaled.argmax())
            pos.append(i)
            errs.append(float(scaled.reshape(-1)[i]))
            abs_errs.append(float(np.asarray(abs_err).reshape(-1)[i]))
            rel_errs.append(float(np.asarray(rel_err).reshape(-1)[i]))
        worst = int(np.argmax(errs))
        return worst, pos[worst], abs_errs[worst], rel_errs[worst]


def verify_grad(fun: Callable, pt: Sequence, n_tests: int = 2, rng=None, eps: Optional[float] = None,
                out_type=None, abs_tol: Optional[float] = None, rel_tol: Optional[float] = None, mode=None,
                cast_to_output_type: bool = False, no_debug_ref: bool = True):
    """Check ``fun``'s symbolic gradient against central differences of a
    random projection of its output, at the point ``pt``; raises
    ``GradientError`` where both tolerances are exceeded.  The projection
    takes the output's dtype, so ``out_type`` and ``cast_to_output_type``
    change nothing, and there is no debug mode for ``no_debug_ref`` to
    leave out: all three are accepted as the JAX package accepts them."""
    from aesara_tpu_torch.compile.function import function
    from aesara_tpu_torch.tensor.math import mul, sum as tsum
    from aesara_tpu_torch.tensor.type import TensorType

    if rng is None:
        rng = np.random.default_rng(42)
    pt = [np.asarray(p) for p in pt]
    for p in pt:
        if p.dtype.kind == "f" and p.dtype.itemsize < 4:
            raise TypeError("verify_grad needs float32/float64 points")
    in_vars = [TensorType(str(p.dtype), p.shape)(f"input{i}") for i, p in enumerate(pt)]
    out = fun(*in_vars)
    if isinstance(out, (list, tuple)):
        raise TypeError("verify_grad works on single-output functions")
    f32 = any(p.dtype == np.float32 for p in pt)
    abs_tol = abs_tol if abs_tol is not None else 1e-5 if f32 else 1e-7
    rel_tol = rel_tol if rel_tol is not None else 1e-4 if f32 else 1e-6
    proj_dtype = out.type.dtype if out.type.dtype.startswith("float") else config.floatX
    t_r = TensorType(proj_dtype, out.type.shape)("random_projection")
    cost = tsum(mul(t_r, out)) if out.type.ndim else mul(t_r, out)
    cost_fn = function(in_vars + [t_r], cost, mode=mode, on_unused_input="ignore")
    sym_grads = grad(cost, in_vars, disconnected_inputs="ignore")
    grad_fn = function(in_vars + [t_r], sym_grads, mode=mode, on_unused_input="ignore")
    out_shape = _host(function(in_vars, out, mode=mode, on_unused_input="ignore")(*pt)).shape
    for _ in range(n_tests):
        r = rng.uniform(0.5, 1.0, size=out_shape).astype(proj_dtype)
        analytic = [_host(a).astype(np.float64) for a in grad_fn(*pt, r)]
        num = numeric_grad(lambda *args: cost_fn(*args, r), [p.copy() for p in pt], eps=eps)
        for argi, (a, n) in enumerate(zip(analytic, num.gf)):
            abs_err = np.abs(a - n)
            rel_err = abs_err / (np.abs(a) + np.abs(n) + 1e-8)
            bad = (abs_err > abs_tol) & (rel_err > rel_tol)
            if bad.any():
                idx = np.unravel_index(np.argmax(abs_err * bad), abs_err.shape)
                raise GradientError(argi, idx, pt[argi].shape, a[idx], n[idx], abs_err[idx],
                                    rel_err[idx], abs_tol, rel_tol)
    return True


# ---------------------------------------------------------------------------
# gradient manipulators
# ---------------------------------------------------------------------------

class GradManipulatorOp(Op):
    """An identity in the forward graph whose gradient is its own; the
    linker runs it as the identity."""

    __props__ = ()
    view_map = {0: [0]}

    def make_node(self, x):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]

    def R_op(self, inputs, eval_points):
        return [eval_points[0]]

    def infer_shape(self, fgraph, node, input_shapes):
        return input_shapes


class ZeroGrad(GradManipulatorOp):
    """The gradient through it is zero."""

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.basic import zeros_like

        return [zeros_like(inputs[0], dtype=config.floatX)]


class DisconnectedGrad(GradManipulatorOp):
    """No gradient passes; ``wrt`` behind it is disconnected."""

    def grad(self, inputs, output_grads):
        return [disconnected_type()]

    def connection_pattern(self, node):
        return [[False]]


class UndefinedGrad(GradManipulatorOp):
    """The gradient through it is undefined."""

    def grad(self, inputs, output_grads):
        return [grad_undefined(self, 0, inputs[0], "undefined_grad applied")]


class GradClip(GradManipulatorOp):
    """The gradient through it is clipped to [lower, upper]."""

    __props__ = ("clip_lower_bound", "clip_upper_bound")

    def __init__(self, clip_lower_bound, clip_upper_bound):
        self.clip_lower_bound = clip_lower_bound
        self.clip_upper_bound = clip_upper_bound

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.math import clip

        return [clip(output_grads[0], self.clip_lower_bound, self.clip_upper_bound)]


class GradScale(GradManipulatorOp):
    """The gradient through it is multiplied by ``multiplier``."""

    __props__ = ("multiplier",)

    def __init__(self, multiplier):
        self.multiplier = multiplier

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.tensor.math import mul

        return [mul(output_grads[0], self.multiplier)]


def zero_grad(x):
    return ZeroGrad()(x)


def disconnected_grad(x):
    return DisconnectedGrad()(x)


def undefined_grad(x):
    return UndefinedGrad()(x)


def grad_clip(x, lower_bound, upper_bound):
    return GradClip(lower_bound, upper_bound)(x)


def grad_scale(x, multiplier):
    return GradScale(multiplier)(x)


def consider_constant(x):
    """The older name of ``zero_grad``, kept by the JAX package."""
    return zero_grad(x)
