"""K1: one fused ``Elemwise(Composite)`` as one kernel.

Replaces ``composite_pallas_fn`` (``aesara_tpu/link/jax/pallas_kernels.py:38``),
which evaluated the fused scalar chain over (256, 128) VMEM row tiles of
inputs that its caller had broadcast and flattened first.

On the H100 this work is bound by device memory bandwidth: it does about
one flop per byte moved, and the card does some 20 fp32 flops in the time
it moves one byte of HBM.  So the design is about bytes: every input is read once,
broadcast inputs are read through zero strides (nothing is
materialised), intermediates stay in registers and
one output is written.  Dimensions that all operands traverse
contiguously are merged on the host, so a (8, 1024, 1024) add against a
(1, 1, 1024) bias indexes in 2-d.

Each distinct Composite gets its own ``@triton.jit`` source, generated
from its scalar graph by :class:`ElemwiseKernel` when the function is
compiled; Triton compiles it on first launch.  ``fused_elemwise`` is
the wrapper: CPU tensors take the plain PyTorch version
(:func:`composite_plain`), CUDA tensors launch the kernel.

fp32 division and square root use ``tl.math.div_rn`` and ``tl.sqrt_rn``
(Triton's ``/`` and ``tl.sqrt`` are approximate in fp32; the ``_rn`` forms
take fp32 only, and fp64's ``/`` and ``tl.sqrt`` are correctly rounded,
so fp64 uses those); ``exp`` is
``tl.exp``, within a few ulp of the plain version's.  ``pow``, ``log``,
``cos`` and ``sin`` call CUDA's libdevice (``__nv_powf`` and the like,
the accurate forms; a negative base with an integral exponent stays
finite, as in NumPy).  Maximum, minimum and clip propagate NaN from
either side, as ``numpy.maximum``/``minimum``/``clip`` do; ``isnan`` is
``x != x`` and ``isinf`` ``|x| == inf``.  Comparisons compute in their
operands' common dtype and give a bool; ``switch`` reads its condition as
a bool and its branches in its output dtype; ``and``, ``or`` and
``invert`` are bitwise on integers and logical on bools.  A bool output
is stored as one byte per element, as torch keeps ``torch.bool``.
bfloat16 and float16 values are computed in fp32 and rounded after every
op, as PyTorch does.  Integer ``pow`` is square-and-multiply over the
exponent's bits in the output's type (``ipow`` in the generated module),
wrapping as the JAX package's does; a negative exponent gives the exact
integer (1 for base 1, +-1 for base -1, 0 for every other base), and a
constant negative exponent is refused when the function is compiled, as
NumPy refuses it.  Unsigned types keep their own semantics (unsigned
comparisons, wrapping negation, ``abs`` the identity); PyTorch has no
arithmetic on uint16, uint32 and uint64 tensors, so the plain version
computes on int64 carriers of the values (uint64: of their bits) and
wraps each result to the output's width.  A non-finite constant is
written ``float('inf')``, ``float('-inf')`` or ``float('nan')``.

The rest of the real table and the special functions: the transcendental
ones are one libdevice call each (``_LIBDEVICE``: ``tanh``, ``expm1``,
``log1p``, ``atan2``, ``erfinv``, ``lgamma``, ``j0``, ``cyl_bessel_i0``
and the others, never an ``.approx`` form); floor division and modulo
follow NumPy (``ifloordiv``/``ffloordiv`` in the generated module: the
quotient rounds toward -inf, the remainder takes the divisor's sign, an
integer divisor of 0 gives 0); a shift by the width or more gives 0 (-1
for a negative value shifted right), checked before the shift
(``ishift``); an integer is its own rounding; the functions with more
than one call hold to the JAX package's lowerings (``_special_expr``:
sigmoid 1 / (1 + exp(-x)), softplus logaddexp(x, 0), log1mexp switching
at log(1/2), Gamma by reflection through lgamma, Erfcinv erfinv(1 - x),
Erfcx a three-term series from 8 on).  Psi and TriGamma have no form yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from aesara_tpu_torch.scalar import math as aesm, ops as aes
from aesara_tpu_torch.scalar.composite import Composite
from aesara_tpu_torch.scalar.ops import discrete_dtypes


__all__ = ["ElemwiseKernel", "composite_plain", "fused_elemwise", "refuse_negative_int_pow",
           "scalar_torch_impl", "torch_dtype"]

_LOW_PRECISION = ("bfloat16", "float16")
_BLOCK = 1024


def torch_dtype(name: str):
    import torch

    return getattr(torch, "bool" if name == "bool" else name)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def scalar_torch_impl(op):
    """The torch formula of one scalar op, computing in the node's output
    dtype (NumPy semantics for the slice's ops)."""
    import torch

    if isinstance(op, aes.Add):
        def f(*xs):
            s = xs[0]
            for x in xs[1:]:
                s = s + x
            return s
        return f
    if isinstance(op, aes.Mul):
        def f(*xs):
            p = xs[0]
            for x in xs[1:]:
                p = p * x
            return p
        return f
    table = {
        aes.Sub: torch.sub, aes.TrueDiv: torch.true_divide, aes.Neg: torch.neg,
        aes.Sqr: torch.square, aes.Sqrt: torch.sqrt, aes.Exp: torch.exp, aes.Maximum: torch.maximum,
        aes.GE: torch.ge, aes.LT: torch.lt, aes.Pow: torch.pow, aes.Abs: torch.abs,
        aes.Minimum: torch.minimum, aes.GT: torch.gt, aes.LE: torch.le, aes.EQ: torch.eq,
        aes.NEQ: torch.ne, aes.IsNan: torch.isnan, aes.IsInf: torch.isinf,
        aes.And: torch.bitwise_and, aes.Or: torch.bitwise_or, aes.Invert: torch.bitwise_not,
        aes.Switch: torch.where, aes.Log: torch.log, aes.Cos: torch.cos, aes.Sin: torch.sin,
    }
    for cls, fn in table.items():
        if isinstance(op, cls):
            return fn
    table = {
        aes.Xor: torch.bitwise_xor, aes.Exp2: torch.exp2, aes.Expm1: torch.expm1, aes.Log2: torch.log2,
        aes.Log10: torch.log10, aes.Log1p: torch.log1p, aes.Deg2Rad: torch.deg2rad, aes.Rad2Deg: torch.rad2deg,
        aes.Tan: torch.tan, aes.ArcCos: torch.acos, aes.ArcSin: torch.asin, aes.ArcTan: torch.atan,
        aes.ArcTan2: torch.atan2, aes.Cosh: torch.cosh, aes.Sinh: torch.sinh, aes.Tanh: torch.tanh,
        aes.ArcCosh: torch.acosh, aes.ArcSinh: torch.asinh, aes.ArcTanh: torch.atanh,
        aes.Reciprocal: torch.reciprocal, aesm.Erf: torch.special.erf, aesm.Erfc: torch.special.erfc,
        aesm.Erfinv: torch.special.erfinv, aesm.GammaLn: torch.lgamma, aesm.Psi: torch.special.digamma,
        aesm.J0: _in_fp32(torch.special.bessel_j0), aesm.J1: _in_fp32(torch.special.bessel_j1),
        aesm.I0: torch.special.i0,
        aesm.I1: torch.special.i1, aesm.Sigmoid: torch.sigmoid,
    }
    for cls, fn in table.items():
        if isinstance(op, cls):
            return fn
    roundings = {aes.Ceil: torch.ceil, aes.Floor: torch.floor, aes.Trunc: torch.trunc,
                 aes.RoundHalfToEven: torch.round, aes.RoundHalfAwayFromZero: _in_fp32(_round_half_away)}
    for cls, fn in roundings.items():
        if isinstance(op, cls):
            # an integer is its own rounding
            return lambda x, fn=fn: fn(x) if x.is_floating_point() else x
    if isinstance(op, (aes.IntDiv, aes.Mod)):
        return lambda x, y: _floor_div_mod(x, y, isinstance(op, aes.Mod), torch.iinfo(x.dtype).min
                                           if not x.is_floating_point() else None)
    if isinstance(op, (aes.ShiftLeft, aes.ShiftRight)):
        return lambda x, y: _shift(x, y, torch.iinfo(x.dtype).bits, isinstance(op, aes.ShiftLeft))
    if isinstance(op, aes.InRange):
        def in_range(x, lo, hi):
            return (x > lo if op.openlow else x >= lo) & (x < hi if op.openhigh else x <= hi)
        return in_range
    if isinstance(op, aes.Mean):
        def mean(*xs):
            # one op, rounded once, as K1 computes it
            low = xs[0].dtype in (torch.bfloat16, torch.float16)
            s = xs[0].float() if low else xs[0]
            for x in xs[1:]:
                s = s + x
            return (s / len(xs)).to(xs[0].dtype)
        return mean
    special = {aesm.Erfcinv: _in_fp32(_erfcinv), aesm.Erfcx: _in_fp32(_erfcx),
               aesm.Gamma: _in_fp32(_gamma_reflect), aesm.TriGamma: lambda x: torch.special.polygamma(1, x),
               aesm.Softplus: _in_fp32(_softplus), aesm.Log1mexp: _in_fp32(_log1mexp)}
    for cls, fn in special.items():
        if isinstance(op, cls):
            return fn
    if isinstance(op, aes.Sgn):
        # torch.sign gives 0 for NaN; NumPy keeps the NaN
        return lambda x: torch.where(torch.isnan(x), x, torch.sign(x)) if x.is_floating_point() else torch.sign(x)
    if isinstance(op, aes.Clip):
        return lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)
    if isinstance(op, aes.Identity):
        return lambda x: x
    if isinstance(op, aes.Second):
        return lambda x, y: torch.broadcast_to(y, torch.broadcast_shapes(x.shape, y.shape))
    if isinstance(op, aes.Cast):
        return lambda x: x
    raise NotImplementedError(f"no torch lowering for scalar op {op}")


# the plain forms that are more than one torch call.  They hold to the JAX
# package's lowerings (``aesara_tpu/link/jax/dispatch.py:97-127,378-487``),
# not to the scalar ops' SciPy ``impl``; the Triton forms in ``_expr``
# compute the same formulas

def _in_fp32(fn):
    """``fn`` computed in float32 for bfloat16 and float16 operands (as K1
    computes them), for a torch function without those dtypes."""
    import torch

    def f(x):
        return fn(x.float()).to(x.dtype) if x.dtype in (torch.bfloat16, torch.float16) else fn(x)

    return f


def _round_half_away(x):
    import torch

    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))


# each of these plain forms is one op: on bfloat16 and float16 it computes
# in float32 and rounds once, as K1 does (rounding its inner steps instead
# would lose accuracy: exp of a rounded gammaln is off by up to 12%)


def _floor_div_mod(x, y, mod: bool, int_min):
    """NumPy's floor division or modulo.  Integers: a zero divisor gives
    0 (NumPy's result; torch raises), and MIN // -1 wraps to MIN as in
    NumPy instead of trapping; the quotient rounds toward -inf and the
    remainder takes the divisor's sign."""
    import torch

    if x.is_floating_point():
        return torch.remainder(x, y) if mod else torch.floor_divide(x, y)
    if x.dtype == torch.bool:
        raise NotImplementedError("floor division of bools")
    zero = y == 0
    safe = torch.where(zero | ((y == -1) & (x == int_min)), torch.ones_like(y), y)
    res = torch.remainder(x, safe) if mod else torch.floor_divide(x, safe)
    return torch.where(zero, torch.zeros_like(res), res)


def _shift(x, y, bits: int, left: bool, unsigned_carrier: bool = False):
    """x << y or x >> y as NumPy shifts: a count of ``bits`` or more (or a
    negative one) gives 0, or -1 for a negative x shifted right.  With
    ``unsigned_carrier`` x holds the bits of a uint64 in an int64, shifted
    right logically."""
    import torch

    if x.dtype == torch.bool:
        raise NotImplementedError("shifts of bools")
    out = (y < 0) | (y >= bits)
    count = torch.where(out, torch.zeros_like(y), y)
    if left:
        return torch.where(out, torch.zeros_like(x), torch.bitwise_left_shift(x, count))
    res = torch.bitwise_right_shift(x, count)
    if unsigned_carrier:
        # an arithmetic shift of the bits, masked to the low 64 - count
        mask = torch.where(count == 0, torch.full_like(res, -1),
                           torch.bitwise_left_shift(torch.ones_like(res), 64 - count) - 1)
        res = res & mask
        return torch.where(out, torch.zeros_like(x), res)
    return torch.where(out, torch.where(x < 0, torch.full_like(x, -1), torch.zeros_like(x)), res)


def _erfcinv(x):
    import torch

    return torch.special.erfinv(1.0 - x)


def _erfcx(x):
    """exp(x**2) erfc(x) below 8; from 8 on the three-term asymptotic
    series (1 - 1/(2x^2) + 3/(4x^4)) / (x sqrt(pi)), where exp(x**2)
    would overflow."""
    import torch

    lo, hi = torch.clamp_max(x, 8.0), torch.clamp_min(x, 8.0)
    hi2 = hi * hi
    series = (1.0 - 0.5 / hi2 + 0.75 / (hi2 * hi2)) / (hi * math.sqrt(math.pi))
    return torch.where(x < 8.0, torch.exp(lo * lo) * torch.special.erfc(lo), series)


def _gamma_reflect(x):
    """Gamma of every real x through gammaln, which gives log|Gamma|:
    the sign of Gamma(x < 0) is that of sin(pi x)."""
    import torch

    sign = torch.where(x < 0, torch.sign(torch.sin(math.pi * x)), torch.ones_like(x))
    return sign * torch.exp(torch.lgamma(x))


def _softplus(x):
    """logaddexp(x, 0), as ``jax.nn.softplus``: NaN stays NaN."""
    import torch

    return torch.where(x > 0, x, torch.zeros_like(x)) + torch.log1p(torch.exp(-torch.abs(x)))


def _log1mexp(x):
    import torch

    return torch.where(x < math.log(0.5), torch.log1p(-torch.exp(x)), torch.log(-torch.expm1(x)))


def _operand_dtypes(op, args_dtypes, out_dtype: str) -> List[str]:
    """The dtype each operand of a scalar op is read in: a comparison's in
    their common dtype, a one-operand test's in its own, a switch's
    condition as a bool, every other operand in the op's output dtype (a
    Cast's operand is cast by definition; Second's template is only a
    shape)."""
    if isinstance(op, (aes.LogicalComparison, aes.InRange)):
        return [aes.upcast(*args_dtypes)] * len(args_dtypes)
    if isinstance(op, aes.FixedLogicalComparison):
        return list(args_dtypes)
    if isinstance(op, aes.Switch):
        return ["bool", out_dtype, out_dtype]
    return [out_dtype] * len(args_dtypes)


#: the unsigned types PyTorch has no arithmetic for, and the mask that wraps
#: an int64 carrier to each (None: uint64's carrier holds its bits)
_WIDE_UNSIGNED = {"uint16": 0xFFFF, "uint32": 0xFFFFFFFF, "uint64": None}
_INT64_MIN = -(2**63)


def _dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


def _wrap(c, dtype: str):
    """An int64 carrier wrapped to the unsigned ``dtype``'s width."""
    mask = _WIDE_UNSIGNED[dtype]
    return c if mask is None else c & mask


def _carrier_cast(t, src: str, dst: str):
    """``t`` (of dtype ``src``, or its int64 carrier when ``src`` is a wide
    unsigned type) as ``dst`` (its carrier when ``dst`` is one): as NumPy's
    ``astype``, wrapping integers and truncating floats toward zero."""
    import torch

    if src == dst:
        return t
    if dst in _WIDE_UNSIGNED:
        if src not in discrete_dtypes:
            # from a float: values of 2**63 and more wrap onto the sign bit
            t = t.to(torch.float64)
            big = t >= 2.0**63
            t = torch.where(big, (t - 2.0**63).to(torch.int64) + _INT64_MIN, t.to(torch.int64))
        return _wrap(t.to(torch.int64), dst)
    if src == "uint64" and dst == "bool":
        return t != 0
    if src == "uint64" and dst not in discrete_dtypes:
        # the two halves of the bits are exact in float64: one rounding
        hi = ((t >> 32) & 0xFFFFFFFF).to(torch.float64)
        return (hi * 2.0**32 + (t & 0xFFFFFFFF).to(torch.float64)).to(torch_dtype(dst))
    return t.to(torch_dtype(dst))


def _apply_unsigned(op, out_dtype: str, args, wants):
    """``apply_scalar_node`` where an operand or the output is uint16,
    uint32 or uint64: on int64 carriers, which hold the values of the
    narrower two and the bits of uint64 (compared with their sign bit
    flipped)."""
    import torch

    names = [_dtype_name(a) for a in args]
    vals = [(a.view(torch.int64) if n == "uint64" else a.to(torch.int64)) if n in _WIDE_UNSIGNED else a
            for a, n in zip(args, names)]
    vals = [_carrier_cast(v, n, w) for v, n, w in zip(vals, names, wants)]
    unsigned = wants[-1] in _WIDE_UNSIGNED
    if unsigned and isinstance(op, aes.Abs):
        res = vals[0]
    elif unsigned and isinstance(op, aes.Sgn):
        res = (vals[0] != 0).to(torch.int64)
    elif unsigned and isinstance(op, (aes.ShiftLeft, aes.ShiftRight)):
        res = _shift(vals[0], vals[1], 8 * np.dtype(wants[-1]).itemsize, isinstance(op, aes.ShiftLeft),
                     unsigned_carrier=wants[-1] == "uint64")
    elif wants[-1] == "uint64" and isinstance(op, (aes.IntDiv, aes.Mod)):
        raise NotImplementedError("uint64 floor division and modulo are not ported")
    else:
        flip = wants[-1] == "uint64" and isinstance(
            op, (aes.LogicalComparison, aes.Maximum, aes.Minimum, aes.Clip, aes.InRange))
        if flip:
            vals = [v ^ _INT64_MIN for v in vals]
        res = scalar_torch_impl(op)(*vals)
        if flip and res.dtype != torch.bool:
            res = res ^ _INT64_MIN
    if out_dtype in _WIDE_UNSIGNED:
        res = _wrap(res.to(torch.int64), out_dtype)
        return res.view(torch.uint64) if out_dtype == "uint64" else res.to(torch_dtype(out_dtype))
    out = torch_dtype(out_dtype)
    return res.to(out) if res.dtype != out else res


def apply_scalar_node(op, out_dtype: str, args):
    """Run one scalar op on tensors, its operands cast to the dtypes it
    reads them in."""
    names = [_dtype_name(a) for a in args]
    wants = _operand_dtypes(op, names, out_dtype)
    if any(d in _WIDE_UNSIGNED for d in names + wants + [out_dtype]):
        return _apply_unsigned(op, out_dtype, args, wants)
    args = [a.to(torch_dtype(w)) if a.dtype != torch_dtype(w) else a for a, w in zip(args, wants)]
    res = scalar_torch_impl(op)(*args)
    out = torch_dtype(out_dtype)
    return res.to(out) if res.dtype != out else res


def refuse_negative_int_pow(op, outer_inputs=()) -> None:
    """Raise, when the function is compiled, where an integer ``pow`` of
    the scalar op ``op`` (a Composite or one op) has a constant negative
    exponent, as NumPy raises; ``outer_inputs`` are the Elemwise node's
    inputs, of which the Constants count as constant exponents."""
    from aesara_tpu_torch.graph.ir import Constant

    if isinstance(op, Composite):
        outer = {v: i.data for v, i in zip(op.inputs, outer_inputs) if isinstance(i, Constant)}
        pows = [(n.inputs[1], n.outputs[0].type.dtype) for n in op.nodes if isinstance(n.op, aes.Pow)]
    else:
        outer = {}
        pows = [(outer_inputs[1], None)] if isinstance(op, aes.Pow) and len(outer_inputs) == 2 else []
    for exp, out_dtype in pows:
        data = outer.get(exp, getattr(exp, "data", None))
        dtype = out_dtype or exp.type.dtype
        if (data is not None and dtype in discrete_dtypes and exp.type.dtype in discrete_dtypes
                and bool(np.any(np.asarray(data) < 0))):
            raise ValueError("Integers to negative integer powers are not allowed.")


def composite_plain(composite: Composite, out_dtype: str, *args):
    """The plain PyTorch version of K1: evaluate the Composite's scalar
    graph with torch ops over broadcasting tensors."""
    import torch

    device = args[0].device
    env = dict(zip(composite.inputs, args))
    for node in composite.nodes:
        ins = [env[i] if i in env else torch.tensor(np.asarray(i.data), device=device)
               for i in node.inputs]
        env[node.outputs[0]] = apply_scalar_node(node.op, node.outputs[0].type.dtype, ins)
    out = composite.outputs[0]
    res = env[out] if out in env else torch.tensor(np.asarray(out.data), device=device)
    shape = torch.broadcast_shapes(*[a.shape for a in args])
    return torch.broadcast_to(res, shape).to(torch_dtype(out_dtype)).contiguous()


# ---------------------------------------------------------------------------
# the Triton source generator
# ---------------------------------------------------------------------------

_TL = {
    "bool": "tl.int1", "int8": "tl.int8", "int16": "tl.int16", "int32": "tl.int32",
    "int64": "tl.int64", "uint8": "tl.uint8", "uint16": "tl.uint16", "uint32": "tl.uint32",
    "uint64": "tl.uint64", "float16": "tl.float16",
    "bfloat16": "tl.bfloat16", "float32": "tl.float32", "float64": "tl.float64",
}


#: integer pow of the generated module: square-and-multiply over the
#: exponent's BITS bits in the base's type (wrapping); with SIGNED, a
#: negative exponent gives 1 for base 1, +-1 for base -1 and 0 otherwise
_IPOW = [
    "@triton.jit",
    "def ipow(base, exp, BITS: tl.constexpr, SIGNED: tl.constexpr):",
    "    one = base * 0 + 1",
    "    result = one",
    "    b = base",
    "    e = exp",
    "    for _ in tl.static_range(BITS):",
    "        result = tl.where((e & 1) != 0, (result * b).to(base.dtype), result)",
    "        b = (b * b).to(base.dtype)",
    "        e = e >> 1",
    "    if SIGNED:",
    "        odd = (exp & 1) != 0",
    "        small = tl.where(base == 1, one, tl.where(base == -1, tl.where(odd, -one, one), one * 0))",
    "        result = tl.where(exp < 0, small, result)",
    "    return result",
]

#: the other helpers of the generated module: NumPy's floor division and
#: modulo (integers: a zero divisor gives 0 and MIN // -1 wraps to MIN;
#: the correction holds whether ``//`` and ``%`` truncate, as Triton's do,
#: or floor), and shifts whose count is checked against the width (PTX
#: clamps the count, LLVM's shift by the width is poison)
_HELPERS = {
    "ifloordiv": [
        "@triton.jit",
        "def ifloordiv(x, y, MINV: tl.constexpr, SIGNED: tl.constexpr, MOD: tl.constexpr):",
        "    zero = y == 0",
        "    if SIGNED:",
        "        safe = tl.where(zero | ((y == -1) & (x == MINV)), 1, y).to(y.dtype)",
        "    else:",
        "        safe = tl.where(zero, 1, y).to(y.dtype)",
        "    if MOD:",
        "        res = (x % safe).to(x.dtype)",
        "        if SIGNED:",
        "            res = tl.where((res != 0) & ((res < 0) != (safe < 0)), res + safe, res)",
        "    else:",
        "        res = (x // safe).to(x.dtype)",
        "        if SIGNED:",
        "            rem = x - res * safe",
        "            res = tl.where((rem != 0) & ((rem < 0) != (safe < 0)), res - 1, res)",
        "    return tl.where(zero, 0, res).to(x.dtype)",
    ],
    "ffloordiv": [
        "@triton.jit",
        "def ffloordiv(x, y, MOD: tl.constexpr, FP64: tl.constexpr):",
        "    m = libdevice.fmod(x, y)",
        "    fix = (m != 0) & ((y < 0) != (m < 0))",
        "    if MOD:",
        "        return tl.where(fix, m + y, m)",
        "    if FP64:",
        "        div = (x - m) / y",
        "        quotient = x / y",
        "    else:",
        "        div = tl.math.div_rn(x - m, y)",
        "        quotient = tl.math.div_rn(x, y)",
        "    div = tl.where(fix, div - 1, div)",
        "    fl = libdevice.floor(div)",
        "    fl = tl.where(div - fl > 0.5, fl + 1, fl)",
        "    return tl.where(y == 0, quotient, fl)",
    ],
    "ishift": [
        "@triton.jit",
        "def ishift(x, y, BITS: tl.constexpr, LEFT: tl.constexpr, SIGNED: tl.constexpr):",
        "    out = (y < 0) | (y >= BITS)",
        "    count = tl.where(out, 0, y).to(y.dtype)",
        "    if LEFT:",
        "        res = tl.where(out, 0, x << count)",
        "    elif SIGNED:",
        "        res = tl.where(out, tl.where(x < 0, -1, 0), x >> count)",
        "    else:",
        "        res = tl.where(out, 0, x >> count)",
        "    return res.to(x.dtype)",
    ],
    "ipow": _IPOW,
}

#: one-operand float functions that are one libdevice call
_LIBDEVICE = {
    aes.Log: "log", aes.Cos: "cos", aes.Sin: "sin", aes.Exp2: "exp2", aes.Expm1: "expm1", aes.Log2: "log2",
    aes.Log10: "log10", aes.Log1p: "log1p", aes.Tan: "tan", aes.ArcCos: "acos", aes.ArcSin: "asin",
    aes.ArcTan: "atan", aes.Cosh: "cosh", aes.Sinh: "sinh", aes.Tanh: "tanh", aes.ArcCosh: "acosh",
    aes.ArcSinh: "asinh", aes.ArcTanh: "atanh", aesm.Erf: "erf", aesm.Erfc: "erfc", aesm.Erfinv: "erfinv",
    aesm.GammaLn: "lgamma", aesm.I0: "cyl_bessel_i0",
    aesm.I1: "cyl_bessel_i1",
}

#: the scalar ops whose operands must be floats in the kernel
_FLOAT_ONLY = (aes.TrueDiv, aes.Sqrt, aes.Exp, aes.Pow, aes.ArcTan2, aes.Deg2Rad, aes.Rad2Deg, aes.Mean,
               aes.Reciprocal, aesm.Erfcinv, aesm.Erfcx, aesm.Gamma, aesm.J0, aesm.J1, aesm.Sigmoid,
               aesm.Softplus, aesm.Log1mexp) + tuple(_LIBDEVICE)


def _compute_dtype(dtype: str) -> str:
    return "float32" if dtype in _LOW_PRECISION else dtype


def _literal(value, dtype: str) -> str:
    value = np.asarray(value).reshape(())[()]
    if dtype == "bool":
        text = repr(bool(value))
    elif dtype.startswith(("int", "uint")):
        text = repr(int(value))
    else:
        # repr gives a bare inf or nan, names the generated module lacks
        text = repr(float(value)) if np.isfinite(value) else f"float('{float(value)}')"
    return f"tl.full([BLOCK], {text}, {_TL[_compute_dtype(dtype)]})"


def _div(a: str, b: str, dtype: str) -> str:
    """a / b correctly rounded: ``div_rn`` in fp32 (Triton's ``/`` is
    approximate there), ``/`` in fp64 (``div_rn`` takes fp32 only, and
    fp64's ``/`` is IEEE division)."""
    return f"(({a}) / ({b}))" if _compute_dtype(dtype) == "float64" else f"tl.math.div_rn({a}, {b})"


def _expr(op, args: List[str], dtype: str) -> str:
    """One scalar op as a Triton expression over operand names already
    converted to the dtypes they are read in; ``dtype`` is that of its
    non-condition operands."""
    is_float = dtype in ("float32", "float64") or dtype in _LOW_PRECISION
    if isinstance(op, aes.Add):
        return " + ".join(args)
    if isinstance(op, aes.Mul):
        return " * ".join(args)
    if isinstance(op, aes.Sub):
        return f"{args[0]} - {args[1]}"
    if isinstance(op, aes.Pow) and dtype in discrete_dtypes and dtype != "bool":
        bits = 8 * np.dtype(dtype).itemsize
        return f"ipow({args[0]}, {args[1]}, {bits}, {not dtype.startswith('uint')})"
    if isinstance(op, _FLOAT_ONLY) and not is_float:
        raise NotImplementedError(f"{op} into {dtype} has no Triton form")
    if isinstance(op, aes.TrueDiv):
        return _div(args[0], args[1], dtype)
    if isinstance(op, aes.Neg):
        return f"-{args[0]}"   # wraps on unsigned types, as in NumPy
    if isinstance(op, aes.Sqr):
        return f"{args[0]} * {args[0]}"
    if isinstance(op, aes.Sqrt):
        # sqrt_rn takes fp32 only; fp64's sqrt is correctly rounded
        return f"tl.sqrt({args[0]})" if _compute_dtype(dtype) == "float64" else f"tl.sqrt_rn({args[0]})"
    if isinstance(op, aes.Exp):
        return f"tl.exp({args[0]})"
    if isinstance(op, aes.Pow):
        return f"libdevice.pow({args[0]}, {args[1]})"
    for cls, name in _LIBDEVICE.items():
        if isinstance(op, cls):
            return f"libdevice.{name}({args[0]})"
    special = _special_expr(op, args, dtype)
    if special is not None:
        return special
    if isinstance(op, aes.Maximum):
        a, b = args
        return f"tl.where(({a} > {b}) | ({a} != {a}), {a}, {b})"
    if isinstance(op, aes.Minimum):
        a, b = args
        return f"tl.where(({a} < {b}) | ({a} != {a}), {a}, {b})"
    if isinstance(op, aes.Clip):
        x, lo, hi = args
        m = f"tl.where(({x} > {lo}) | ({x} != {x}), {x}, {lo})"
        return f"tl.where(({m} < {hi}) | ({m} != {m}), {m}, {hi})"
    if isinstance(op, aes.Abs):
        return args[0] if dtype == "bool" or dtype.startswith("uint") else f"tl.abs({args[0]})"
    if isinstance(op, aes.Sgn):
        a = args[0]
        sign = f"({a} > 0).to({_TL[_compute_dtype(dtype)]}) - ({a} < 0).to({_TL[_compute_dtype(dtype)]})"
        return f"tl.where({a} != {a}, {a}, {sign})" if is_float else sign
    comparisons = {aes.GE: ">=", aes.LT: "<", aes.GT: ">", aes.LE: "<=", aes.EQ: "==", aes.NEQ: "!="}
    for cls, sym in comparisons.items():
        if isinstance(op, cls):
            return f"{args[0]} {sym} {args[1]}"
    if isinstance(op, aes.IsNan):
        return f"{args[0]} != {args[0]}"
    if isinstance(op, aes.IsInf):
        return f"tl.abs({args[0]}) == float('inf')" if is_float else f"{args[0]} != {args[0]}"
    if isinstance(op, aes.And):
        return f"{args[0]} & {args[1]}"
    if isinstance(op, aes.Or):
        return f"{args[0]} | {args[1]}"
    if isinstance(op, aes.Invert):
        return f"{args[0]} == 0" if dtype == "bool" else f"~{args[0]}"
    if isinstance(op, aes.Switch):
        return f"tl.where({args[0]}, {args[1]}, {args[2]})"
    if isinstance(op, (aes.Identity, aes.Cast)):
        # a Cast's operand was converted to the target dtype already
        return args[0]
    if isinstance(op, aes.Second):
        return args[1]
    raise NotImplementedError(f"the fused-elemwise kernel has no Triton form for scalar op {op}")


def _special_expr(op, args: List[str], dtype: str):
    """The Triton forms of the ops that are more than one call (the
    formulas of the plain forms above), or None."""
    def lit(v):
        return _literal(v, dtype)

    if isinstance(op, (aes.IntDiv, aes.Mod)):
        mod = isinstance(op, aes.Mod)
        if dtype in ("bool", "uint64"):
            raise NotImplementedError(f"{op} of {dtype} has no Triton form")
        if dtype in discrete_dtypes:
            signed = not dtype.startswith("uint")
            return f"ifloordiv({args[0]}, {args[1]}, {int(np.iinfo(dtype).min)}, {signed}, {mod})"
        return f"ffloordiv({args[0]}, {args[1]}, {mod}, {_compute_dtype(dtype) == 'float64'})"
    if isinstance(op, (aes.ShiftLeft, aes.ShiftRight)):
        if dtype == "bool":
            raise NotImplementedError(f"{op} of bool has no Triton form")
        bits = 8 * np.dtype(dtype).itemsize
        return (f"ishift({args[0]}, {args[1]}, {bits}, {isinstance(op, aes.ShiftLeft)}, "
                f"{not dtype.startswith('uint')})")
    roundings = {aes.Ceil: "ceil", aes.Floor: "floor", aes.Trunc: "trunc", aes.RoundHalfToEven: "rint"}
    for cls, name in roundings.items():
        if isinstance(op, cls):
            # an integer is its own rounding
            return args[0] if dtype in discrete_dtypes else f"libdevice.{name}({args[0]})"
    if isinstance(op, aes.RoundHalfAwayFromZero):
        x = args[0]
        return x if dtype in discrete_dtypes else f"libdevice.trunc({x} + libdevice.copysign({lit(0.5)}, {x}))"
    if isinstance(op, aes.Xor):
        return f"{args[0]} ^ {args[1]}"
    if isinstance(op, aes.ArcTan2):
        return f"libdevice.atan2({args[0]}, {args[1]})"
    if isinstance(op, aes.Deg2Rad):
        return f"{args[0]} * {lit(math.pi / 180.0)}"
    if isinstance(op, aes.Rad2Deg):
        return f"{args[0]} * {lit(180.0 / math.pi)}"
    if isinstance(op, aes.InRange):
        x, lo, hi = args
        return f"({x} {'>' if op.openlow else '>='} {lo}) & ({x} {'<' if op.openhigh else '<='} {hi})"
    if isinstance(op, aes.Mean):
        return _div(' + '.join(args), lit(len(args)), dtype)
    if isinstance(op, aes.Reciprocal):
        return _div(lit(1.0), args[0], dtype)
    x = args[0]
    if isinstance(op, aesm.Sigmoid):
        return _div(lit(1.0), f"{lit(1.0)} + libdevice.exp(-{x})", dtype)
    if isinstance(op, aesm.Softplus):
        return f"tl.where({x} > 0, {x}, {lit(0.0)}) + libdevice.log1p(libdevice.exp(-tl.abs({x})))"
    if isinstance(op, aesm.Log1mexp):
        return (f"tl.where({x} < {lit(math.log(0.5))}, libdevice.log1p(-libdevice.exp({x})), "
                f"libdevice.log(-libdevice.expm1({x})))")
    if isinstance(op, (aesm.J0, aesm.J1)):
        # NaN at +-inf, as SciPy and PyTorch give it (libdevice gives 0)
        name = type(op).__name__.lower()
        return f"tl.where(tl.abs({x}) == float('inf'), {lit(float('nan'))}, libdevice.{name}({x}))"
    if isinstance(op, aesm.Erfcinv):
        return f"libdevice.erfinv({lit(1.0)} - {x})"
    if isinstance(op, aesm.Erfcx):
        # NaN stays NaN through both clamps, as in the plain form
        lo = f"tl.where(({x} < 8.0) | ({x} != {x}), {x}, {lit(8.0)})"
        hi = f"tl.where(({x} > 8.0) | ({x} != {x}), {x}, {lit(8.0)})"
        hi2 = f"({hi} * {hi})"
        terms = f"{lit(1.0)} - {_div(lit(0.5), hi2, dtype)} + {_div(lit(0.75), f'{hi2} * {hi2}', dtype)}"
        series = _div(terms, f"{hi} * {lit(math.sqrt(math.pi))}", dtype)
        return f"tl.where({x} < 8.0, libdevice.exp({lo} * {lo}) * libdevice.erfc({lo}), {series})"
    if isinstance(op, aesm.Gamma):
        s, cdt = f"libdevice.sin({lit(math.pi)} * {x})", _TL[_compute_dtype(dtype)]
        sign = f"tl.where({x} < 0, (({s}) > 0).to({cdt}) - (({s}) < 0).to({cdt}), {lit(1.0)})"
        return f"{sign} * libdevice.exp(libdevice.lgamma({x}))"
    return None


class ElemwiseKernel:
    """The Triton kernel of one single-output Composite at fixed input
    and output dtypes.  Building one checks that every scalar op has a
    Triton form; ``source(ndim)`` is the kernel for an ``ndim``-d
    (collapsed) iteration space."""

    def __init__(self, composite: Composite, in_dtypes: Sequence[str], out_dtype: str):
        if composite.nout != 1:
            raise NotImplementedError("fused-elemwise kernel takes single-output Composites")
        self.composite = composite
        self.in_dtypes = tuple(in_dtypes)
        self.out_dtype = out_dtype
        self.body = self._body()
        self._kernels: Dict[Tuple[int, bool], object] = {}

    def _body(self) -> List[str]:
        comp = self.composite
        names = {v: f"x{i}" for i, v in enumerate(comp.inputs)}
        lines = []
        for k, node in enumerate(comp.nodes):
            dtype = node.outputs[0].type.dtype
            cdt = _TL[_compute_dtype(dtype)]
            in_dtypes = _operand_dtypes(node.op, [i.type.dtype for i in node.inputs], dtype)
            args = []
            for inp, in_dtype in zip(node.inputs, in_dtypes):
                in_cdt = _TL[_compute_dtype(in_dtype)]
                if inp in names:
                    args.append(f"{names[inp]}.to({in_cdt})")
                else:
                    args.append(f"{_literal(inp.data, inp.type.dtype)}.to({in_cdt})")
            expr = _expr(node.op, args, in_dtypes[-1])
            name = f"v{k}"
            if dtype in _LOW_PRECISION:
                # round after every op, then compute on in fp32
                lines.append(f"{name} = ({expr}).to({_TL[dtype]}).to(tl.float32)")
            else:
                lines.append(f"{name} = ({expr}).to({cdt})")
            names[node.outputs[0]] = name
        out = comp.outputs[0]
        result = names.get(out) or _literal(out.data, out.type.dtype)
        lines.append(f"result = {result}")
        return lines

    def source(self, ndim: int, wide: bool = False) -> str:
        """``wide`` indexes in int64, for more than 2**31 - 1 elements."""
        n_in = len(self.in_dtypes)
        params = ["out_ptr"] + [f"in{i}_ptr" for i in range(n_in)] + ["N"]
        params += [f"size{d}" for d in range(ndim)]
        params += [f"st{i}_{d}" for i in range(n_in) for d in range(ndim)]
        lines = [
            "import triton",
            "import triton.language as tl",
            "",
            "try:",
            "    from triton.language.extra import libdevice",
            "except ImportError:",
            "    from triton.language.extra.cuda import libdevice",
            "",
            "",
            *[line for name, helper in _HELPERS.items() if any(f"{name}(" in line for line in self.body)
              for line in [*helper, "", ""]],
            "@triton.jit",
            f"def kernel({', '.join(params)}, BLOCK: tl.constexpr):",
            "    pid = tl.program_id(0)",
            "    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)" if wide
            else "    offs = pid * BLOCK + tl.arange(0, BLOCK)",
            "    mask = offs < N",
            "    rem = offs",
        ]
        for d in reversed(range(ndim)):
            if d:
                lines.append(f"    i{d} = rem % size{d}")
                lines.append(f"    rem = rem // size{d}")
            else:
                lines.append("    i0 = rem")
        for i in range(n_in):
            terms = [f"i{d} * st{i}_{d}" for d in range(ndim)] or ["offs * 0"]
            lines.append(f"    x{i} = tl.load(in{i}_ptr + {' + '.join(terms)}, mask=mask)")
        lines += [f"    {line}" for line in self.body]
        lines.append(f"    tl.store(out_ptr + offs, result.to({_TL[self.out_dtype]}), mask=mask)")
        return "\n".join(lines) + "\n"

    def kernel(self, ndim: int, wide: bool = False):
        """The ``@triton.jit`` function for ``ndim``, written to the build
        directory and imported from there (Triton reads the source of
        what it compiles)."""
        if (ndim, wide) not in self._kernels:
            from aesara_tpu_torch.link.torch.kernels.build import triton_module

            self._kernels[(ndim, wide)] = triton_module(self.source(ndim, wide), "fused").kernel
        return self._kernels[(ndim, wide)]


def _collapse(shape: Tuple[int, ...], strides: List[Tuple[int, ...]]):
    """Merge adjacent dims that every operand walks contiguously; drop
    size-1 dims."""
    dims = [(s, [st[d] for st in strides]) for d, s in enumerate(shape) if s != 1]
    merged: List[Tuple[int, List[int]]] = []
    for size, sts in dims:
        if merged:
            psize, psts = merged[-1]
            if all(p == s * size for p, s in zip(psts, sts)):
                merged[-1] = (psize * size, sts)
                continue
        merged.append((size, sts))
    return [m[0] for m in merged], [[m[1][i] for m in merged] for i in range(len(strides))]


def launch_plan(args):
    """(output shape, element count, collapsed sizes, per-operand strides
    over them, whether int64 indices are needed) of one launch over
    broadcasting operands; a broadcast dim is read with stride 0."""
    import torch

    shape = tuple(torch.broadcast_shapes(*[a.shape for a in args]))
    n = math.prod(shape)
    sizes, strides = _collapse(shape, [torch.broadcast_to(a, shape).stride() for a in args])
    # int32 index math is several times cheaper than int64 division
    wide = n + _BLOCK >= 2**31 or any(abs(st) * d >= 2**31
                                      for sts in strides for st, d in zip(sts, sizes))
    return shape, n, sizes, strides, wide


def fused_elemwise(kernel: ElemwiseKernel, *args):
    """Evaluate a Composite over broadcasting tensors.  CPU tensors take
    the plain version; CUDA tensors launch the generated Triton kernel."""
    import torch

    if len(args) != kernel.composite.nin:
        raise TypeError(f"{kernel.composite} takes {kernel.composite.nin} operands, got {len(args)}")
    if all(a.device.type == "cpu" for a in args):
        fused_elemwise.plain_calls += 1
        return composite_plain(kernel.composite, kernel.out_dtype, *args)
    device = args[0].device
    if any(a.device != device for a in args) or device.type != "cuda":
        raise ValueError(f"fused_elemwise: operands on several devices {[a.device for a in args]}")
    for a, dt in zip(args, kernel.in_dtypes):
        if a.dtype != torch_dtype(dt):
            raise TypeError(f"fused_elemwise: got {a.dtype}, the kernel was built for {dt}")
    shape, n, sizes, strides, wide = launch_plan(args)
    out = torch.empty(shape, dtype=torch_dtype(kernel.out_dtype), device=device)
    if n == 0:
        return out
    grid = ((n + _BLOCK - 1) // _BLOCK,)
    # the operands' own pointers: their broadcast dims are read with stride 0
    kernel.kernel(len(sizes), wide)[grid](out, *args, n, *sizes, *[st for sts in strides for st in sts],
                                          BLOCK=_BLOCK, num_warps=4)
    fused_elemwise.launches += 1
    return out


#: launches of the Triton kernel, calls that took the plain version, and the
#: launches replayed from captured graphs (tallied by the linker)
fused_elemwise.launches = 0
fused_elemwise.plain_calls = 0
fused_elemwise.replayed = 0
