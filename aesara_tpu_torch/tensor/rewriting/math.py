"""Algebraic rewrites of the optimizers' graphs (the counterparts of
``local_pow_canonicalize``, ``local_pow_specialize`` and
``local_useless_switch`` in ``aesara_tpu/tensor/rewriting/math.py:667,692,1059``):

- ``local_pow_canonicalize`` (canonicalize): ``pow`` by the constant 0 is
  ones, by 1 the base (the gradient of ``x ** 2`` builds ``x ** (2 - 1)``).
- ``local_pow_specialize`` (specialize): ``pow`` by the constant 2, 0.5,
  -1, -0.5 or -2 becomes ``sqr``, ``sqrt`` or a division, one cheap
  op in place of libdevice's ``pow``.
- ``local_useless_switch`` (canonicalize): ``switch(c, x, x)`` is x
  broadcast against c, and a switch on a constant condition is the
  branch it takes.
- ``local_sumsqr2dot`` (specialize, ``math.py:1286``): the full sum of a
  square, ``sum(sqr(x))``, is ``dot(x.flatten(), x.flatten())``, one
  product in place of a square and a reduction (the AdamW clip's global
  norm).

And the stability family of the special functions (stabilize, but
``local_erf_neg``, canonicalize, and ``local_func_inv``, specialize):
log(1 + x) → log1p, exp(x) - 1 → expm1, the sigmoid forms of
1 / (1 + exp(-x)), log(sigmoid) and log1p(exp) → softplus, logaddexp,
logsumexp, 1 - sigmoid(x) → sigmoid(-x), the erf/erfc complements,
log(erfc) and the erfc gradient's core through erfcx, sigmoid(u) *
exp(-u) → sigmoid(-u) and functional inverse pairs.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import register_canonicalize, register_specialize, register_stabilize
from aesara_tpu_torch.graph.ir import Constant, equal_computations
from aesara_tpu_torch.graph.rewriting.basic import NodeRewriter, copy_stack_trace, node_rewriter
from aesara_tpu_torch.scalar import math as aesm, ops as aes
from aesara_tpu_torch.scalar.ops import discrete_dtypes, itemsize
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import cast, constant, switch, zeros_like
from aesara_tpu_torch.tensor.elemwise import Elemwise
from aesara_tpu_torch.tensor.rewriting.basic import _const_val, _keep_type


def _is_elemwise(node, scalar_cls) -> bool:
    return isinstance(node.op, Elemwise) and isinstance(node.op.scalar_op, scalar_cls)


@node_rewriter([Elemwise])
def local_pow_canonicalize(fgraph, node):
    """pow(x, 0) → ones_like(x); pow(x, 1) → x"""
    if not _is_elemwise(node, aes.Pow):
        return False
    x, p = node.inputs
    v = _const_val(p)
    if v is None or float(v) not in (0.0, 1.0):
        return False
    out = node.outputs[0]
    res = _keep_type(out, zeros_like(x) + 1 if float(v) == 0.0 else x)
    return False if res is None else [copy_stack_trace(out, res)]


@node_rewriter([Elemwise])
def local_pow_specialize(fgraph, node):
    """pow(x, 2) → sqr(x); pow(x, 0.5) → sqrt(x); pow(x, -1) → 1 / x;
    pow(x, -0.5) → 1 / sqrt(x); pow(x, -2) → 1 / sqr(x)"""
    if not _is_elemwise(node, aes.Pow):
        return False
    x, p = node.inputs
    v = _const_val(p)
    out = node.outputs[0]
    if v is None or (out.type.dtype in discrete_dtypes and float(v) < 0):
        return False
    v = float(v)
    one = constant(1, dtype="int8")
    table = {2.0: lambda: tm.sqr(x), 0.5: lambda: tm.sqrt(x), -1.0: lambda: tm.true_div(one, x),
             -0.5: lambda: tm.true_div(one, tm.sqrt(x)), -2.0: lambda: tm.true_div(one, tm.sqr(x))}
    if v not in table:
        return False
    res = _keep_type(out, table[v]())
    return False if res is None else [copy_stack_trace(out, res)]


@node_rewriter([Elemwise])
def local_useless_switch(fgraph, node):
    """switch(c, x, x) → x (broadcast against c); switch(constant, a, b)
    → the branch the constant picks"""
    if not _is_elemwise(node, aes.Switch):
        return False
    cond, ift, iff = node.inputs
    out = node.outputs[0]
    if ift is iff:
        res = ift + zeros_like(cond, dtype=ift.type.dtype)
    else:
        v = _const_val(cond)
        if v is None:
            return False
        res = ift if np.all(v) else iff
    res = _keep_type(out, res)
    return False if res is None else [copy_stack_trace(out, res)]


register_canonicalize(local_pow_canonicalize)
register_specialize(local_pow_specialize)
register_canonicalize(local_useless_switch)


@node_rewriter([tm.Sum])
def local_sumsqr2dot(fgraph, node):
    """sum(sqr(x)) over every axis → dot(x.flatten(), x.flatten()), where
    the square has no other reader and the sum accumulates in no wider a
    type than x's (bf16 and f16 products accumulate in f32)."""
    inner = node.inputs[0].owner
    if (node.op.axis is not None or inner is None or not _is_elemwise(inner, aes.Sqr)
            or len(fgraph.clients.get(node.inputs[0], ())) != 1):
        return False
    x = inner.inputs[0]
    if x.type.dtype in discrete_dtypes or x.type.ndim == 0:
        return False
    out = node.outputs[0]
    out_size = itemsize(out.type.dtype)
    acc_size = itemsize(node.op.acc_dtype) if node.op.acc_dtype else out_size
    x_size = itemsize(x.type.dtype)
    eff_acc = 4 if x.type.dtype in ("float16", "bfloat16") else x_size
    if out_size > x_size or acc_size > eff_acc:
        return False
    flat = x.flatten()
    res = tm.dot(flat, flat)
    if res.type.dtype != out.type.dtype:
        res = cast(res, out.type.dtype)
    conv = out.type.convert_variable(res)
    return False if conv is None else [copy_stack_trace(out, conv)]


register_specialize(local_sumsqr2dot)


# ---------------------------------------------------------------------------
# the stability family of the special functions (``aesara_tpu/tensor/
# rewriting/math.py:229-1011,1456-1700``), at the JAX package's stages
# ---------------------------------------------------------------------------

def _is_one(var, value=1) -> bool:
    v = _const_val(var)
    return v is not None and bool(np.all(v == value))


def _replaced(out, res):
    res = _keep_type(out, res)
    return False if res is None else [copy_stack_trace(out, res)]


@node_rewriter([Elemwise])
def local_log1p(fgraph, node):
    """log(1 + x) → log1p(x)"""
    if not _is_elemwise(node, aes.Log):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_elemwise(inner, aes.Add):
        return False
    ones = [i for i in inner.inputs if _is_one(i)]
    others = [i for i in inner.inputs if i not in ones]
    if not ones or not others:
        return False
    return _replaced(node.outputs[0], tm.log1p(others[0] if len(others) == 1 else tm.add(*others)))


@node_rewriter([Elemwise])
def local_expm1(fgraph, node):
    """exp(x) - 1 → expm1(x), and its add form exp(x) + -1"""
    if _is_elemwise(node, aes.Sub):
        a, b = node.inputs
        if _is_one(b) and a.owner is not None and _is_elemwise(a.owner, aes.Exp):
            return _replaced(node.outputs[0], tm.expm1(a.owner.inputs[0]))
        return False
    if _is_elemwise(node, aes.Add) and len(node.inputs) == 2:
        for i, j in ((0, 1), (1, 0)):
            expn = node.inputs[j].owner
            if _is_one(node.inputs[i], -1) and expn is not None and _is_elemwise(expn, aes.Exp):
                return _replaced(node.outputs[0], tm.expm1(expn.inputs[0]))
    return False


@node_rewriter([Elemwise])
def local_exp_over_1_plus_exp(fgraph, node):
    """1 / (1 + exp(-x)) → sigmoid(x); exp(x) / (1 + exp(x)) → sigmoid(x)"""
    if not _is_elemwise(node, aes.TrueDiv):
        return False
    num, den = node.inputs
    if den.owner is None or not _is_elemwise(den.owner, aes.Add):
        return False
    terms = den.owner.inputs
    ones = [i for i in terms if _is_one(i)]
    exps = [i for i in terms if i.owner is not None and _is_elemwise(i.owner, aes.Exp)]
    if len(terms) != 2 or not ones or not exps:
        return False
    u = exps[0].owner.inputs[0]
    if _is_one(num):
        # 1 / (1 + exp(u)) = sigmoid(-u); -(-v) folds to v
        v = u.owner.inputs[0] if u.owner is not None and _is_elemwise(u.owner, aes.Neg) else tm.neg(u)
        return _replaced(node.outputs[0], tm.sigmoid(v))
    if num.owner is not None and _is_elemwise(num.owner, aes.Exp) and num.owner.inputs[0] is u:
        return _replaced(node.outputs[0], tm.sigmoid(u))
    return False


@node_rewriter([Elemwise])
def local_log_sigmoid_to_softplus(fgraph, node):
    """log(sigmoid(x)) → -softplus(-x)"""
    if not _is_elemwise(node, aes.Log):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_elemwise(inner, aesm.Sigmoid):
        return False
    return _replaced(node.outputs[0], tm.neg(tm.softplus(tm.neg(inner.inputs[0]))))


@node_rewriter([Elemwise])
def local_log1p_exp_to_softplus(fgraph, node):
    """log1p(exp(x)) → softplus(x)"""
    if not _is_elemwise(node, aes.Log1p):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_elemwise(inner, aes.Exp):
        return False
    return _replaced(node.outputs[0], tm.softplus(inner.inputs[0]))


@node_rewriter([Elemwise])
def local_log_add_exp(fgraph, node):
    """log(exp(a) + exp(b)) → logaddexp(a, b)"""
    if not _is_elemwise(node, aes.Log):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_elemwise(inner, aes.Add) or len(inner.inputs) != 2:
        return False
    a, b = inner.inputs
    if not all(i.owner is not None and _is_elemwise(i.owner, aes.Exp) for i in (a, b)):
        return False
    return _replaced(node.outputs[0], tm.logaddexp(a.owner.inputs[0], b.owner.inputs[0]))


@node_rewriter([Elemwise])
def local_logsumexp(fgraph, node):
    """log(sum(exp(x), axis)) → logsumexp(x, axis), shifted by the max"""
    if not _is_elemwise(node, aes.Log):
        return False
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, tm.Sum):
        return False
    exp_node = inner.inputs[0].owner
    if exp_node is None or not _is_elemwise(exp_node, aes.Exp):
        return False
    return _replaced(node.outputs[0], tm.logsumexp(exp_node.inputs[0], axis=inner.op.axis))


@node_rewriter([Elemwise])
def local_1msigmoid(fgraph, node):
    """1 - sigmoid(x) → sigmoid(-x)"""
    if not _is_elemwise(node, aes.Sub):
        return False
    a, b = node.inputs
    if not _is_one(a) or b.owner is None or not _is_elemwise(b.owner, aesm.Sigmoid):
        return False
    return _replaced(node.outputs[0], tm.sigmoid(tm.neg(b.owner.inputs[0])))


@node_rewriter([Elemwise])
def local_erf_complement(fgraph, node):
    """1 - erf(x) → erfc(x); 1 - erfc(x) → erf(x)"""
    if not _is_elemwise(node, aes.Sub):
        return False
    a, b = node.inputs
    if not _is_one(a) or b.owner is None:
        return False
    if _is_elemwise(b.owner, aesm.Erf):
        return _replaced(node.outputs[0], tm.erfc(b.owner.inputs[0]))
    if _is_elemwise(b.owner, aesm.Erfc):
        return _replaced(node.outputs[0], tm.erf(b.owner.inputs[0]))
    return False


@node_rewriter([Elemwise])
def local_erf_neg(fgraph, node):
    """erf(-x) → -erf(x)"""
    if not _is_elemwise(node, aesm.Erf):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_elemwise(inner, aes.Neg):
        return False
    return _replaced(node.outputs[0], tm.neg(tm.erf(inner.inputs[0])))


@node_rewriter([Elemwise])
def local_reciprocal_1_plus_exp(fgraph, node):
    """1 / (1 + exp(x)) as ``reciprocal`` → sigmoid(-x)"""
    if not _is_elemwise(node, aes.Reciprocal):
        return False
    inner = node.inputs[0].owner
    if (inner is None or not _is_elemwise(inner, aes.Add) or len(fgraph.clients.get(node.inputs[0], ())) > 1
            or len(inner.inputs) != 2):
        return False
    for i, j in ((0, 1), (1, 0)):
        expn = inner.inputs[j].owner
        if _is_one(inner.inputs[i]) and expn is not None and _is_elemwise(expn, aes.Exp):
            u = expn.inputs[0]
            res = tm.sigmoid(u.owner.inputs[0] if u.owner is not None and _is_elemwise(u.owner, aes.Neg)
                             else tm.neg(u))
            conv = node.outputs[0].type.convert_variable(res)
            return False if conv is None else [copy_stack_trace(node.outputs[0], conv)]
    return False


@node_rewriter([Elemwise])
def local_log_erfc(fgraph, node):
    """log(erfc(x)) → switch(x < 1, log1p(-erf(x)), -x**2 + log(erfcx(x)))"""
    if not _is_elemwise(node, aes.Log):
        return False
    inner = node.inputs[0].owner
    if inner is None or not _is_elemwise(inner, aesm.Erfc):
        return False
    (x,) = inner.inputs
    if x.type.dtype in discrete_dtypes:
        return False
    res = switch(tm.lt(x, constant(1.0)), tm.log1p(tm.neg(tm.erf(x))),
                 tm.add(tm.neg(tm.sqr(x)), tm.log(tm.erfcx(x))))
    return _replaced(node.outputs[0], res)


def _is_sqr_of(v, x) -> bool:
    """v is x**2 (Sqr, a Pow by 2, or x * x)."""
    s = v.owner
    if s is None:
        return False
    return ((_is_elemwise(s, aes.Sqr) and s.inputs[0] is x)
            or (_is_elemwise(s, aes.Pow) and s.inputs[0] is x and _is_one(s.inputs[1], 2))
            or (_is_elemwise(s, aes.Mul) and list(s.inputs) == [x, x]))


def _is_exp_neg_sqr_of(v, x) -> bool:
    """v is exp(-x**2)."""
    o = v.owner
    if o is None or not _is_elemwise(o, aes.Exp):
        return False
    a = o.inputs[0].owner
    if a is None:
        return False
    if _is_elemwise(a, aes.Neg):
        return _is_sqr_of(a.inputs[0], x)
    if _is_elemwise(a, aes.Mul) and len(a.inputs) == 2:
        return any(_is_one(c, -1) and _is_sqr_of(other, x) for c, other in (a.inputs, reversed(a.inputs)))
    return False


@node_rewriter([Elemwise])
def local_grad_log_erfc_neg(fgraph, node):
    """exp(-x**2) / erfc(x) → 1 / erfcx(x), also with a leading factor"""
    if not _is_elemwise(node, aes.TrueDiv):
        return False
    num, den = node.inputs
    if den.owner is None or not _is_elemwise(den.owner, aesm.Erfc):
        return False
    (x,) = den.owner.inputs
    if _is_exp_neg_sqr_of(num, x):
        return _replaced(node.outputs[0], tm.true_div(constant(1.0), tm.erfcx(x)))
    if num.owner is None or not _is_elemwise(num.owner, aes.Mul):
        return False
    factors = list(num.owner.inputs)
    hit = next((i for i, f in enumerate(factors) if _is_exp_neg_sqr_of(f, x)), None)
    if hit is None:
        return False
    rest = factors[:hit] + factors[hit + 1:]
    return _replaced(node.outputs[0], tm.true_div(rest[0] if len(rest) == 1 else tm.mul(*rest), tm.erfcx(x)))


@node_rewriter([Elemwise])
def local_sigm_times_exp(fgraph, node):
    """sigmoid(u) * exp(-u) → sigmoid(-u)"""
    if not _is_elemwise(node, aes.Mul):
        return False
    factors = list(node.inputs)

    def neg_of(a, b):
        bo, ao = b.owner, a.owner
        return ((bo is not None and _is_elemwise(bo, aes.Neg) and bo.inputs[0] is a)
                or (ao is not None and _is_elemwise(ao, aes.Neg) and ao.inputs[0] is b))

    for i, fi in enumerate(factors):
        if fi.owner is None or not _is_elemwise(fi.owner, aesm.Sigmoid):
            continue
        (u,) = fi.owner.inputs
        for j, fj in enumerate(factors):
            if j == i or fj.owner is None or not _is_elemwise(fj.owner, aes.Exp):
                continue
            (v,) = fj.owner.inputs
            if not neg_of(u, v):
                continue
            rest = [f for k, f in enumerate(factors) if k not in (i, j)]
            merged = tm.sigmoid(v)
            return _replaced(node.outputs[0], tm.mul(merged, *rest) if rest else merged)
    return False


#: functional inverse pairs (f, g): f(g(x)) is x
_INV_PAIRS = ((aes.Deg2Rad, aes.Rad2Deg), (aes.Rad2Deg, aes.Deg2Rad), (aes.Cosh, aes.ArcCosh),
              (aes.Tanh, aes.ArcTanh), (aes.ArcTanh, aes.Tanh), (aes.Sinh, aes.ArcSinh),
              (aes.ArcSinh, aes.Sinh), (aes.Neg, aes.Neg), (aes.Reciprocal, aes.Reciprocal))


@node_rewriter([Elemwise])
def local_func_inv(fgraph, node):
    """f(g(x)) → x for the inverse pairs; on floats only, but Neg(Neg)"""
    inner = node.inputs[0].owner if node.inputs else None
    if inner is None or not isinstance(inner.op, Elemwise):
        return False
    outer_s, inner_s = node.op.scalar_op, inner.op.scalar_op
    for f_cls, g_cls in _INV_PAIRS:
        if isinstance(outer_s, f_cls) and isinstance(inner_s, g_cls):
            x = inner.inputs[0]
            if x.type.dtype in discrete_dtypes and not isinstance(outer_s, aes.Neg):
                return False
            return _replaced(node.outputs[0], x)
    return False


for _rw in (local_log1p, local_expm1, local_exp_over_1_plus_exp, local_log_sigmoid_to_softplus,
            local_log1p_exp_to_softplus, local_log_add_exp, local_logsumexp, local_1msigmoid, local_erf_complement,
            local_reciprocal_1_plus_exp, local_log_erfc, local_grad_log_erfc_neg, local_sigm_times_exp):
    register_stabilize(_rw)
register_canonicalize(local_erf_neg)
register_specialize(local_func_inv)


# ---------------------------------------------------------------------------
# the algebraic canonizers (``aesara_tpu/tensor/rewriting/math.py:483-659``)
# and ``local_add_neg_to_sub`` (``:855``)
# ---------------------------------------------------------------------------

class AlgebraicCanonizer(NodeRewriter):
    """One canonical ``main(*num) inverse main(*denum)`` form of an
    algebra (main, inverse, reciprocal): factors on both sides cancel and
    constants fold across the inverse.  ``mul_canonizer`` (Mul, TrueDiv,
    Reciprocal) and ``add_canonizer`` (Add, Sub, Neg), both at
    canonicalize, as in the JAX package."""

    def __init__(self, main_cls, inverse_cls, reciprocal_cls, build_main, build_inverse, build_reciprocal,
                 calculate, neutral):
        self.main_cls, self.inverse_cls, self.reciprocal_cls = main_cls, inverse_cls, reciprocal_cls
        self.build_main, self.build_inverse, self.build_reciprocal = build_main, build_inverse, build_reciprocal
        self.calculate = calculate
        self.neutral = neutral

    def tracks(self):
        return [Elemwise]

    def _classify(self, var):
        node = var.owner
        if node is None or not isinstance(node.op, Elemwise):
            return None
        sop = node.op.scalar_op
        for kind, cls in (("main", self.main_cls), ("inverse", self.inverse_cls),
                          ("reciprocal", self.reciprocal_cls)):
            if isinstance(sop, cls):
                return kind
        return None

    def get_num_denum(self, var, fgraph, depth=0):
        """(numerator factors, denominator factors) of ``var``; a value
        that another node reads too is not taken apart."""
        kind = self._classify(var)
        if kind is None or (depth > 0 and len(fgraph.clients.get(var, [])) > 1):
            return [var], []
        node = var.owner
        num, denum = [], []
        if kind == "main":
            for inp in node.inputs:
                n, d = self.get_num_denum(inp, fgraph, depth + 1)
                num.extend(n)
                denum.extend(d)
        else:
            if kind == "inverse":
                n, d = self.get_num_denum(node.inputs[0], fgraph, depth + 1)
                num.extend(n)
                denum.extend(d)
            n, d = self.get_num_denum(node.inputs[-1], fgraph, depth + 1)
            denum.extend(n)
            num.extend(d)
        return num, denum

    def simplify(self, num, denum, out):
        """Cancel identical factors and fold the constants; (num, denum,
        changed)."""
        changed = False
        new_denum, out_num = list(denum), []
        for v in num:
            if v in new_denum:
                new_denum.remove(v)
                changed = True
            else:
                out_num.append(v)
        num, denum = out_num, new_denum
        n_consts = [v for v in num if _const_val(v) is not None]
        d_consts = [v for v in denum if _const_val(v) is not None]
        if (len(n_consts) + len(d_consts) >= 2 or (n_consts and np.all(_const_val(n_consts[0]) == self.neutral))
                or (d_consts and np.all(_const_val(d_consts[0]) == self.neutral))):
            num = [v for v in num if v not in n_consts]
            denum = [v for v in denum if v not in d_consts]
            ct = self.calculate([_const_val(v) for v in n_consts], [_const_val(v) for v in d_consts])
            if not np.all(ct == self.neutral):
                num.insert(0, constant(np.asarray(ct)[()], dtype=out.type.dtype))
            changed = True
        return num, denum, changed

    def _is_own_form(self, node, num, denum) -> bool:
        """Whether ``merge(num, denum)`` gives back ``node`` itself: its
        inputs were not taken apart."""
        def same(xs, ys):
            return len(xs) == len(ys) and all(a is b for a, b in zip(xs, ys))

        kind = self._classify(node.outputs[0])
        ins = list(node.inputs)
        return ((kind == "main" and not denum and len(ins) > 1 and same(num, ins))
                or (kind == "inverse" and same(num, ins[:1]) and same(denum, ins[1:]))
                or (kind == "reciprocal" and not num and same(denum, ins)))

    def merge(self, num, denum, out):
        if not num and not denum:
            return constant(self.neutral, dtype=out.type.dtype)
        if not denum:
            return num[0] if len(num) == 1 else self.build_main(*num)
        d = denum[0] if len(denum) == 1 else self.build_main(*denum)
        if not num:
            return self.build_reciprocal(d)
        return self.build_inverse(num[0] if len(num) == 1 else self.build_main(*num), d)

    def transform(self, fgraph, node):
        out = node.outputs[0]
        if self._classify(out) is None:
            return False
        if out.type.dtype in discrete_dtypes and self.reciprocal_cls is aes.Reciprocal:
            return False    # true_div changes an integer's dtype
        if all(isinstance(i, Constant) for i in node.inputs):
            return False    # constant folding's
        num, denum = self.get_num_denum(out, fgraph)
        num, denum, changed = self.simplify(num, denum, out)
        if not changed and self._is_own_form(node, num, denum):
            return False    # merge would rebuild the node as it is
        res = self.merge(num, denum, out)
        kept = _keep_type(out, res)
        if kept is None and getattr(res.type, "ndim", 99) <= out.type.ndim:
            # a cancellation dropped the factors that carried the shape
            # (x/x → 1): zeros of the node's inputs restore it
            full = res
            for inp in node.inputs:
                if inp.type.ndim:
                    full = full + zeros_like(inp, dtype=res.type.dtype)
            kept = _keep_type(out, full)
        if kept is None or kept is out or equal_computations([kept], [out]):
            return False
        return [copy_stack_trace(out, kept)]

    def __str__(self):
        return self.name


def _calc_mul(num_consts, denum_consts):
    v = np.asarray(1.0 if not num_consts else num_consts[0])
    for c in num_consts[1:]:
        v = v * c
    for c in denum_consts:
        v = v / c
    return v


def _calc_add(num_consts, denum_consts):
    v = np.asarray(0.0 if not num_consts else num_consts[0])
    for c in num_consts[1:]:
        v = v + c
    for c in denum_consts:
        v = v - c
    return v


mul_canonizer = AlgebraicCanonizer(aes.Mul, aes.TrueDiv, aes.Reciprocal, tm.mul, tm.true_div, tm.reciprocal,
                                   _calc_mul, 1)
add_canonizer = AlgebraicCanonizer(aes.Add, aes.Sub, aes.Neg, tm.add, tm.sub, tm.neg, _calc_add, 0)
register_canonicalize(mul_canonizer, name="mul_canonizer")
register_canonicalize(add_canonizer, name="add_canonizer")


@node_rewriter([Elemwise])
def local_add_neg_to_sub(fgraph, node):
    """a + (-b) → a - b"""
    if not _is_elemwise(node, aes.Add) or len(node.inputs) != 2:
        return False
    a, b = node.inputs
    if b.owner is not None and _is_elemwise(b.owner, aes.Neg):
        return _replaced(node.outputs[0], tm.sub(a, b.owner.inputs[0]))
    if a.owner is not None and _is_elemwise(a.owner, aes.Neg):
        return _replaced(node.outputs[0], tm.sub(b, a.owner.inputs[0]))
    return False


register_specialize(local_add_neg_to_sub)
