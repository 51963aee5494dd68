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
(Triton's ``/`` and ``tl.sqrt`` are approximate in fp32); ``exp`` is
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
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from aesara_tpu_torch.scalar import ops as aes
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


def _operand_dtypes(op, args_dtypes, out_dtype: str) -> List[str]:
    """The dtype each operand of a scalar op is read in: a comparison's in
    their common dtype, a one-operand test's in its own, a switch's
    condition as a bool, every other operand in the op's output dtype (a
    Cast's operand is cast by definition; Second's template is only a
    shape)."""
    if isinstance(op, aes.LogicalComparison):
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
    else:
        flip = wants[-1] == "uint64" and isinstance(
            op, (aes.LogicalComparison, aes.Maximum, aes.Minimum, aes.Clip))
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
    if isinstance(op, (aes.TrueDiv, aes.Sqrt, aes.Exp, aes.Pow, aes.Log, aes.Cos, aes.Sin)) and not is_float:
        raise NotImplementedError(f"{op} into {dtype} has no Triton form")
    if isinstance(op, aes.TrueDiv):
        return f"tl.math.div_rn({args[0]}, {args[1]})"
    if isinstance(op, aes.Neg):
        return f"-{args[0]}"   # wraps on unsigned types, as in NumPy
    if isinstance(op, aes.Sqr):
        return f"{args[0]} * {args[0]}"
    if isinstance(op, aes.Sqrt):
        return f"tl.sqrt_rn({args[0]})"
    if isinstance(op, aes.Exp):
        return f"tl.exp({args[0]})"
    if isinstance(op, aes.Pow):
        return f"libdevice.pow({args[0]}, {args[1]})"
    if isinstance(op, (aes.Log, aes.Cos, aes.Sin)):
        return f"libdevice.{type(op).__name__.lower()}({args[0]})"
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
            *([*_IPOW, "", ""] if any("ipow(" in line for line in self.body) else []),
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
