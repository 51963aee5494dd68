"""Scalar types and the scalar op algebra.

The counterpart of ``aesara_tpu/scalar/ops.py``, cut to the ops the
encoder's train step uses: Add, Sub, Mul, TrueDiv, Neg, Sqr, Sqrt,
Maximum and Cast, the ops their gradients build: GE, LT and Second,
Exp, which the gradient of ``LogSoftmax`` builds, and the ops of the
optimizers and their helpers: Pow, Abs, Minimum, the comparisons GT, LE,
EQ, NEQ, IsNan and IsInf, the logical And, Or and Invert, Switch,
Identity, Log, Cos and Clip; and the rest of the real table: IntDiv and
Mod (floor semantics; an integer division by zero gives 0, as in NumPy),
the roundings, Xor and the shifts, the exponentials, logarithms,
trigonometric and hyperbolic functions and their inverses, InRange, Mean
and Reciprocal.  The special functions are in ``scalar/math.py``; the
complex ops are not ported.
Each op declares its NumPy semantics (``impl``), its output dtype rule
and its gradient (``grad``, over scalar variables; ``Elemwise.L_op`` lifts
it to tensors); the torch and Triton formulas of each live in
``aesara_tpu_torch/link/torch/kernels/elemwise.py``.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Apply, Constant, Type, Variable
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.graph.utils import MethodNotDefined


int_dtypes = ("int8", "int16", "int32", "int64")
uint_dtypes = ("uint8", "uint16", "uint32", "uint64")
float_dtypes = ("float16", "bfloat16", "float32", "float64")
complex_dtypes = ("complex64", "complex128")
discrete_dtypes = ("bool",) + int_dtypes + uint_dtypes
continuous_dtypes = float_dtypes + complex_dtypes
all_dtypes = discrete_dtypes + continuous_dtypes


def _np_dtype(name: str) -> np.dtype:
    """The NumPy dtype of the host form of a value of dtype ``name``
    (``to_host``): NumPy has no bfloat16, so a bfloat16 value's host form
    is a float32 array that holds bfloat16 values only."""
    return np.dtype("float32" if name == "bfloat16" else name)


def itemsize(name: str) -> int:
    """Bytes of one value of dtype ``name``."""
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def is_torch_tensor(x) -> bool:
    """Whether ``x`` is a torch tensor (without importing torch)."""
    return type(x).__module__.startswith("torch") and hasattr(x, "dtype") and hasattr(x, "device")


# A value of dtype ``name`` lives in one of two forms off the device.  Its
# host form, which the graph holds (constants, ``perform`` results, values
# folded from constants), is a NumPy array of ``_np_dtype(name)``.  Its user
# form, which ``shared``, ``get_value`` and ``_asarray`` give and take, is a
# NumPy array too, but for bfloat16 a torch.bfloat16 tensor on the CPU.
# These two functions are the only conversions between them.

def to_host(x, name: str) -> np.ndarray:
    """``x`` (a NumPy value, a Python literal or a torch tensor on any
    device) in the host form of dtype ``name``.  A bfloat16 value is
    rounded by torch, through float32 as torch and ml_dtypes round a
    float64, so the JAX package's ml_dtypes values have the same bits."""
    if is_torch_tensor(x):
        import torch

        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    arr = np.asarray(x).astype(_np_dtype(name), copy=False)
    if name != "bfloat16":
        return arr
    import torch

    return torch.from_numpy(np.array(arr, order="C")).to(torch.bfloat16).float().numpy()


def from_host(x, name: str):
    """``x`` (as ``to_host`` takes it) in the user form of dtype ``name``,
    a copy: a NumPy array, or for bfloat16 a torch.bfloat16 tensor on the
    CPU."""
    if name != "bfloat16":
        return np.array(to_host(x, name))
    import torch

    if is_torch_tensor(x) and x.dtype == torch.bfloat16:
        return x.detach().cpu().clone()
    return torch.from_numpy(to_host(x, name)).to(torch.bfloat16)


def perform_by_torch(fn, node, inputs, output_storage) -> None:
    """An op's ``perform`` through its torch form ``fn``: the host values
    as CPU tensors in, the one result in its output's host form."""
    import torch

    res = fn(*[torch.from_numpy(np.ascontiguousarray(a)) for a in inputs])
    output_storage[0][0] = to_host(res, node.outputs[0].type.dtype)


def upcast(dtype, *dtypes) -> str:
    """NumPy type promotion over dtype names; with bfloat16 present,
    integer operands do not widen the result (the JAX package's rule)."""
    names = [str(d) if str(d) == "bfloat16" else np.dtype(d).name for d in (dtype, *dtypes)]
    if "bfloat16" in names:
        rest = [d for d in names if d != "bfloat16" and d in continuous_dtypes]
        if not rest:
            return "bfloat16"
        promoted = upcast(*rest)
        return "float32" if promoted == "float16" else promoted
    out = np.dtype(names[0])
    for d in names[1:]:
        out = np.promote_types(out, np.dtype(d))
    return out.name


def upcast_out(*types):
    return (ScalarType(upcast(*[t.dtype for t in types])),)


def same_out(*types):
    for t in types[1:]:
        if t.dtype != types[0].dtype:
            raise TypeError(f"mismatched dtypes: {[t.dtype for t in types]}")
    return (types[0],)


def upgrade_to_float(*types):
    """Discrete inputs go to ``config.floatX``."""
    conv = [config.floatX if t.dtype in discrete_dtypes else t.dtype for t in types]
    return (ScalarType(upcast(*conv)),)


def upgrade_to_float_no_complex(*types):
    for t in types:
        if t.dtype in complex_dtypes:
            raise TypeError(f"complex input not supported: {t}")
    return upgrade_to_float(*types)


def same_out_nocomplex(*types):
    for t in types:
        if t.dtype in complex_dtypes:
            raise TypeError(f"complex input not supported: {t}")
    return same_out(*types)


def bool_out(*types):
    return (ScalarType("bool"),)


def discrete_out(*types):
    for t in types:
        if t.dtype not in discrete_dtypes:
            raise TypeError(f"integer/bool input required: {t}")
    return upcast_out(*types)


class ScalarType(Type):
    """A 0-d value of one dtype."""

    ndim = 0
    shape: tuple = ()

    def __init__(self, dtype: str):
        if dtype == "floatX":
            dtype = config.floatX
        self.dtype = "bfloat16" if dtype == "bfloat16" else np.dtype(dtype).name

    def filter(self, data, strict=False, allow_downcast=None):
        arr = to_host(data, self.dtype)
        if arr.ndim != 0:
            raise TypeError(f"scalar expected, got array of ndim {arr.ndim}")
        return arr[()]

    def is_super(self, otype):
        return isinstance(otype, ScalarType) and otype.dtype == self.dtype

    def __eq__(self, other):
        return type(other) is ScalarType and other.dtype == self.dtype

    def __hash__(self):
        return hash((ScalarType, self.dtype))

    def __str__(self):
        return self.dtype

    def __repr__(self):
        return f"ScalarType({self.dtype})"


class ScalarVariable(Variable):
    """Scalar symbolic variable."""

    @property
    def dtype(self):
        return self.type.dtype


class ScalarConstant(ScalarVariable, Constant):
    pass


ScalarType.variable_type = ScalarVariable
ScalarType.constant_type = ScalarConstant


def as_scalar(x) -> ScalarVariable:
    if isinstance(x, Variable):
        if isinstance(x.type, ScalarType):
            return x
        raise TypeError(f"cannot convert {x} to a scalar")
    arr = np.asarray(x)
    if arr.ndim != 0:
        raise TypeError(f"scalar expected, got shape {arr.shape}")
    return ScalarConstant(ScalarType(arr.dtype.name), arr[()])


def constant(x, dtype=None) -> ScalarConstant:
    """A literal scalar: bare ints take int8 (int64 when wider) and bare
    floats ``config.floatX``, so the literals of gradient formulas do not
    upcast the expression around them."""
    if dtype is None:
        if isinstance(x, bool):
            dtype = "bool"
        elif isinstance(x, int):
            dtype = "int8" if -128 <= x < 128 else "int64"
        elif isinstance(x, float):
            dtype = config.floatX
    arr = np.asarray(x) if dtype is None else to_host(x, dtype)
    return ScalarConstant(ScalarType(dtype or arr.dtype.name), arr[()])


class ScalarOp(Op):
    """Base of the scalar algebra: ``nin``/``nout`` arity, ``nfunc`` the
    NumPy function, ``output_types_preference`` the dtype rule."""

    nin = -1
    nout = 1
    nfunc: Any = None
    output_types_preference = staticmethod(upcast_out)

    def __init__(self, name=None):
        if name is not None:
            self.name = name

    def output_types(self, types) -> Tuple[ScalarType, ...]:
        return tuple(self.output_types_preference(*types))

    def make_node(self, *inputs) -> Apply:
        if self.nin >= 0 and len(inputs) != self.nin:
            raise TypeError(f"{self} expected {self.nin} inputs, got {len(inputs)}")
        inputs = [as_scalar(i) for i in inputs]
        outputs = [t() for t in self.output_types([i.type for i in inputs])]
        return Apply(self, inputs, outputs)

    def impl(self, *inputs):
        if self.nfunc is not None:
            return self.nfunc(*inputs)
        raise MethodNotDefined(f"{type(self).__name__}.impl")

    def perform(self, node, inputs, output_storage):
        out = self.impl(*inputs)
        if self.nout == 1:
            out = (out,)
        for storage, o, var in zip(output_storage, out, node.outputs):
            storage[0] = to_host(o, var.type.dtype)[()]

    def __eq__(self, other):
        if self is other:
            return True
        if type(self) is not type(other):
            return False
        if self.__props__:
            return all(getattr(self, p) == getattr(other, p) for p in self.__props__)
        return True

    def __hash__(self):
        if self.__props__:
            return hash((type(self),) + tuple(getattr(self, p) for p in self.__props__))
        return hash(type(self))

    def __str__(self):
        return getattr(self, "name", None) or type(self).__name__.lower()


class UnaryScalarOp(ScalarOp):
    nin = 1


class BinaryScalarOp(ScalarOp):
    nin = 2


def _zeros_like(x):
    """A zero of ``x``'s dtype (floatX for a discrete ``x``) shaped like it."""
    return second(x, constant(0, dtype=x.dtype if x.dtype not in discrete_dtypes else config.floatX))


def _discrete_grads(op, inputs):
    """An op whose output is discrete has no gradient."""
    from aesara_tpu_torch.gradient import grad_undefined

    return [grad_undefined(op, i, inp, "output is discrete") for i, inp in enumerate(inputs)]


class LogicalComparison(BinaryScalarOp):
    """A comparison: a bool output whose gradient is defined and zero."""

    output_types_preference = staticmethod(bool_out)

    def grad(self, inputs, output_grads):
        return [_zeros_like(inp) for inp in inputs]


class FixedLogicalComparison(UnaryScalarOp):
    """A one-operand test (``isnan``, ``isinf``): a bool output whose
    gradient is defined and zero."""

    output_types_preference = staticmethod(bool_out)

    def grad(self, inputs, output_grads):
        return [_zeros_like(inputs[0])]


class Add(ScalarOp):
    def impl(self, *inputs):
        s = inputs[0]
        for x in inputs[1:]:
            s = s + x
        return s

    def grad(self, inputs, output_grads):
        (gz,) = output_grads
        return [_zeros_like(inp) if inp.dtype in discrete_dtypes else gz for inp in inputs]


class Mul(ScalarOp):
    def impl(self, *inputs):
        p = inputs[0]
        for x in inputs[1:]:
            p = p * x
        return p

    def grad(self, inputs, output_grads):
        (gz,) = output_grads
        rval = []
        for i in range(len(inputs)):
            g = gz
            for j, other in enumerate(inputs):
                if j != i:
                    g = mul(g, other)
            rval.append(g)
        return rval


class Sub(BinaryScalarOp):
    nfunc = staticmethod(np.subtract)

    def grad(self, inputs, output_grads):
        (gz,) = output_grads
        return [gz, neg(gz)]


class TrueDiv(BinaryScalarOp):
    nfunc = staticmethod(np.true_divide)

    @staticmethod
    def output_types_preference(*types):
        t = upcast_out(*types)[0]
        if t.dtype in discrete_dtypes:
            return (ScalarType(config.floatX),)
        return (t,)

    def grad(self, inputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        return [true_div(gz, y), neg(true_div(mul(gz, x), mul(y, y)))]


class Neg(UnaryScalarOp):
    nfunc = staticmethod(np.negative)
    output_types_preference = staticmethod(same_out)

    def grad(self, inputs, output_grads):
        return [neg(output_grads[0])]


class Maximum(BinaryScalarOp):
    nfunc = staticmethod(np.maximum)

    def grad(self, inputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        if x.dtype in discrete_dtypes and y.dtype in discrete_dtypes:
            return _discrete_grads(self, inputs)
        # ties go to x, as in the JAX package
        return [mul(gz, cast_to(ge(x, y), gz.dtype)), mul(gz, cast_to(lt(x, y), gz.dtype))]


class GE(LogicalComparison):
    nfunc = staticmethod(np.greater_equal)


class LT(LogicalComparison):
    nfunc = staticmethod(np.less)


class Sqrt(UnaryScalarOp):
    nfunc = staticmethod(np.sqrt)
    output_types_preference = staticmethod(upgrade_to_float)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        return [true_div(output_grads[0], mul(constant(2.0), sqrt(x)))]


class Exp(UnaryScalarOp):
    nfunc = staticmethod(np.exp)
    output_types_preference = staticmethod(upgrade_to_float)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        if x.dtype in discrete_dtypes:
            return _discrete_grads(self, inputs)
        return [mul(output_grads[0], exp(x))]


class Sqr(UnaryScalarOp):
    nfunc = staticmethod(np.square)
    output_types_preference = staticmethod(same_out)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        return [mul(output_grads[0], mul(constant(2.0), x))]


class Minimum(BinaryScalarOp):
    nfunc = staticmethod(np.minimum)

    def grad(self, inputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        if x.dtype in discrete_dtypes and y.dtype in discrete_dtypes:
            return _discrete_grads(self, inputs)
        # ties go to x, as in the JAX package
        return [mul(gz, cast_to(le(x, y), gz.dtype)), mul(gz, cast_to(gt(x, y), gz.dtype))]


class Pow(BinaryScalarOp):
    nfunc = staticmethod(np.power)

    def grad(self, inputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        gx = mul(gz, mul(y, pow(x, sub(y, constant(1, dtype="int8")))))
        gy = mul(gz, mul(log(x), pow(x, y)))
        return [gx, gy]


class Abs(UnaryScalarOp):
    nfunc = staticmethod(np.abs)
    output_types_preference = staticmethod(same_out)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        if x.dtype in discrete_dtypes:
            return _discrete_grads(self, inputs)
        return [mul(output_grads[0], sgn(x))]


class Sgn(UnaryScalarOp):
    """The sign of x (NaN stays NaN); the gradient of ``Abs`` builds it."""

    nfunc = staticmethod(np.sign)
    output_types_preference = staticmethod(same_out)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class GT(LogicalComparison):
    nfunc = staticmethod(np.greater)


class LE(LogicalComparison):
    nfunc = staticmethod(np.less_equal)


class EQ(LogicalComparison):
    nfunc = staticmethod(np.equal)


class NEQ(LogicalComparison):
    nfunc = staticmethod(np.not_equal)


class IsNan(FixedLogicalComparison):
    nfunc = staticmethod(np.isnan)


class IsInf(FixedLogicalComparison):
    nfunc = staticmethod(np.isinf)


class And(BinaryScalarOp):
    """Bitwise and (logical on bool)."""

    nfunc = staticmethod(np.bitwise_and)
    output_types_preference = staticmethod(discrete_out)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class Or(BinaryScalarOp):
    """Bitwise or (logical on bool)."""

    nfunc = staticmethod(np.bitwise_or)
    output_types_preference = staticmethod(discrete_out)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class Invert(UnaryScalarOp):
    """Bitwise not (logical not on bool)."""

    nfunc = staticmethod(np.invert)
    output_types_preference = staticmethod(discrete_out)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class Switch(ScalarOp):
    """switch(cond, ift, iff): ift where cond is nonzero, else iff."""

    nin = 3

    @staticmethod
    def output_types_preference(cond_t, ift_t, iff_t):
        return upcast_out(ift_t, iff_t)

    def impl(self, cond, ift, iff):
        return np.where(cond, ift, iff)[()] if np.ndim(cond) == 0 else np.where(cond, ift, iff)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        cond, ift, iff = inputs
        (gz,) = output_grads
        zero = constant(0, dtype=gz.dtype)
        return [grad_undefined(self, 0, cond, "condition has no gradient"),
                switch(cond, gz, zero), switch(cond, zero, gz)]


class Identity(UnaryScalarOp):
    nfunc = staticmethod(lambda x: x)
    output_types_preference = staticmethod(same_out)

    def grad(self, inputs, output_grads):
        return [output_grads[0]]


class Log(UnaryScalarOp):
    nfunc = staticmethod(np.log)
    output_types_preference = staticmethod(upgrade_to_float)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], inputs[0])]


class Cos(UnaryScalarOp):
    nfunc = staticmethod(np.cos)
    output_types_preference = staticmethod(upgrade_to_float)

    def grad(self, inputs, output_grads):
        return [neg(mul(output_grads[0], sin(inputs[0])))]


class Sin(UnaryScalarOp):
    """The gradient of ``Cos`` builds it."""

    nfunc = staticmethod(np.sin)
    output_types_preference = staticmethod(upgrade_to_float)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], cos(inputs[0]))]


class Clip(ScalarOp):
    """clip(x, min, max) as one scalar op (NaN in x stays NaN)."""

    nin = 3
    nfunc = staticmethod(np.clip)

    def grad(self, inputs, output_grads):
        x, mn, mx = inputs
        (gz,) = output_grads
        inside = and_(ge(x, mn), le(x, mx))
        return [mul(gz, cast_to(inside, gz.dtype)), mul(gz, cast_to(lt(x, mn), gz.dtype)),
                mul(gz, cast_to(gt(x, mx), gz.dtype))]


class Second(BinaryScalarOp):
    """second(x, y) = y broadcast against x: the scalar of ``fill``."""

    @staticmethod
    def output_types_preference(xt, yt):
        return (yt,)

    def impl(self, x, y):
        return np.broadcast_arrays(x, y)[1] if np.ndim(x) or np.ndim(y) else y

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type

        return [disconnected_type(), output_grads[0]]

    def connection_pattern(self, node):
        return [[False], [True]]


class Cast(UnaryScalarOp):
    """dtype conversion."""

    __props__ = ("o_type",)

    def __init__(self, o_type: ScalarType, name=None):
        if not isinstance(o_type, ScalarType):
            raise TypeError("o_type must be a ScalarType")
        super().__init__(name)
        self.o_type = o_type

    def output_types(self, types):
        return (self.o_type,)

    def impl(self, x):
        return to_host(x, self.o_type.dtype)[()]

    def grad(self, inputs, output_grads):
        (x,) = inputs
        if self.o_type.dtype in discrete_dtypes or x.dtype in discrete_dtypes:
            return _discrete_grads(self, inputs)
        return [cast_to(output_grads[0], x.dtype)]

    def __str__(self):
        return f"cast{{{self.o_type.dtype}}}"


class IntDiv(BinaryScalarOp):
    """Floor division (NumPy's sign rules); an integer division by zero
    gives 0, as NumPy gives."""

    nfunc = staticmethod(np.floor_divide)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class Mod(BinaryScalarOp):
    """The remainder of floor division: it takes the divisor's sign; an
    integer modulo by zero gives 0."""

    nfunc = staticmethod(np.mod)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        x, y = inputs
        if x.dtype in discrete_dtypes:
            return _discrete_grads(self, inputs)
        return [output_grads[0], grad_undefined(self, 1, y, "mod grad wrt divisor undefined")]


class _Rounding(UnaryScalarOp):
    """A rounding: an integer is its own rounding, and no gradient flows."""

    output_types_preference = staticmethod(same_out_nocomplex)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class Ceil(_Rounding):
    nfunc = staticmethod(np.ceil)


class Floor(_Rounding):
    nfunc = staticmethod(np.floor)


class Trunc(_Rounding):
    nfunc = staticmethod(np.trunc)


class RoundHalfToEven(_Rounding):
    nfunc = staticmethod(np.round)


class RoundHalfAwayFromZero(_Rounding):
    def impl(self, x):
        return np.trunc(x + np.copysign(np.asarray(0.5, dtype=np.asarray(x).dtype), x))


class Xor(BinaryScalarOp):
    """Bitwise exclusive or (logical on bool)."""

    nfunc = staticmethod(np.bitwise_xor)
    output_types_preference = staticmethod(discrete_out)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class ShiftLeft(BinaryScalarOp):
    """x << y; a shift by the width or more (or by a negative count)
    gives 0, as NumPy gives."""

    nfunc = staticmethod(np.left_shift)
    output_types_preference = staticmethod(discrete_out)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class ShiftRight(BinaryScalarOp):
    """x >> y, arithmetic on signed types; a shift by the width or more
    gives 0, or -1 for a negative x."""

    nfunc = staticmethod(np.right_shift)
    output_types_preference = staticmethod(discrete_out)

    def grad(self, inputs, output_grads):
        return _discrete_grads(self, inputs)


class _Float(UnaryScalarOp):
    """A one-operand function of the reals: discrete inputs go to floatX."""

    output_types_preference = staticmethod(upgrade_to_float)


class Exp2(_Float):
    nfunc = staticmethod(np.exp2)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], mul(exp2(inputs[0]), constant(math.log(2.0))))]


class Expm1(_Float):
    nfunc = staticmethod(np.expm1)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], exp(inputs[0]))]


class Log2(_Float):
    nfunc = staticmethod(np.log2)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], mul(inputs[0], constant(math.log(2.0))))]


class Log10(_Float):
    nfunc = staticmethod(np.log10)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], mul(inputs[0], constant(math.log(10.0))))]


class Log1p(_Float):
    nfunc = staticmethod(np.log1p)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], add(constant(1.0), inputs[0]))]


class Deg2Rad(_Float):
    nfunc = staticmethod(np.deg2rad)
    output_types_preference = staticmethod(upgrade_to_float_no_complex)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], constant(math.pi / 180.0))]


class Rad2Deg(_Float):
    nfunc = staticmethod(np.rad2deg)
    output_types_preference = staticmethod(upgrade_to_float_no_complex)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], constant(180.0 / math.pi))]


class Tan(_Float):
    nfunc = staticmethod(np.tan)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], sqr(cos(inputs[0])))]


class ArcCos(_Float):
    nfunc = staticmethod(np.arccos)

    def grad(self, inputs, output_grads):
        return [neg(true_div(output_grads[0], sqrt(sub(constant(1.0), sqr(inputs[0])))))]


class ArcSin(_Float):
    nfunc = staticmethod(np.arcsin)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], sqrt(sub(constant(1.0), sqr(inputs[0]))))]


class ArcTan(_Float):
    nfunc = staticmethod(np.arctan)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], add(constant(1.0), sqr(inputs[0])))]


class ArcTan2(BinaryScalarOp):
    """arctan2(y, x)."""

    nfunc = staticmethod(np.arctan2)
    output_types_preference = staticmethod(upgrade_to_float)

    def grad(self, inputs, output_grads):
        y, x = inputs
        (gz,) = output_grads
        den = add(sqr(x), sqr(y))
        return [mul(gz, true_div(x, den)), neg(mul(gz, true_div(y, den)))]


class Cosh(_Float):
    nfunc = staticmethod(np.cosh)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], sinh(inputs[0]))]


class Sinh(_Float):
    nfunc = staticmethod(np.sinh)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], cosh(inputs[0]))]


class Tanh(_Float):
    nfunc = staticmethod(np.tanh)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], sub(constant(1.0), sqr(tanh(inputs[0]))))]


class ArcCosh(_Float):
    nfunc = staticmethod(np.arccosh)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        return [true_div(output_grads[0], mul(sqrt(sub(x, constant(1.0))), sqrt(add(x, constant(1.0)))))]


class ArcSinh(_Float):
    nfunc = staticmethod(np.arcsinh)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], sqrt(add(constant(1.0), sqr(inputs[0]))))]


class ArcTanh(_Float):
    nfunc = staticmethod(np.arctanh)

    def grad(self, inputs, output_grads):
        return [true_div(output_grads[0], sub(constant(1.0), sqr(inputs[0])))]


class InRange(ScalarOp):
    """low <= x <= high (``openlow``/``openhigh`` make a side strict): a
    bool whose gradient is zero everywhere, at the bounds too."""

    nin = 3
    __props__ = ("openlow", "openhigh")

    def __init__(self, openlow=False, openhigh=False, name=None):
        super().__init__(name)
        self.openlow = bool(openlow)
        self.openhigh = bool(openhigh)

    def output_types_preference(self, *types):
        return (ScalarType("bool"),)

    def impl(self, x, low, high):
        lo_ok = np.greater(x, low) if self.openlow else np.greater_equal(x, low)
        hi_ok = np.less(x, high) if self.openhigh else np.less_equal(x, high)
        return np.logical_and(lo_ok, hi_ok)

    def grad(self, inputs, output_grads):
        return [_zeros_like(inp) for inp in inputs]


class Mean(ScalarOp):
    """The mean of its operands (variadic); it has no gradient, as in the
    JAX package."""

    output_types_preference = staticmethod(upgrade_to_float)

    def impl(self, *vals):
        return sum(vals) / len(vals)


class Reciprocal(UnaryScalarOp):
    """1 / x; an integer x goes to the float output first."""

    output_types_preference = staticmethod(upgrade_to_float)

    def impl(self, x):
        return 1.0 / x

    def grad(self, inputs, output_grads):
        return [neg(true_div(output_grads[0], sqr(inputs[0])))]



def cast_to(x, dtype: str):
    """``x`` as ``dtype`` (no node when it already is)."""
    x = as_scalar(x)
    return x if x.dtype == dtype else Cast(ScalarType(dtype))(x)


add = Add(name="add")
mul = Mul(name="mul")
sub = Sub(name="sub")
true_div = TrueDiv(name="true_div")
neg = Neg(name="neg")
maximum = Maximum(name="maximum")
ge = GE(name="ge")
lt = LT(name="lt")
sqrt = Sqrt(name="sqrt")
exp = Exp(name="exp")
sqr = Sqr(name="sqr")
second = Second(name="second")
minimum = Minimum(name="minimum")
pow = Pow(name="pow")
abs_ = Abs(name="abs")
sgn = Sgn(name="sgn")
gt = GT(name="gt")
le = LE(name="le")
eq = EQ(name="eq")
neq = NEQ(name="neq")
isnan = IsNan(name="isnan")
isinf = IsInf(name="isinf")
and_ = And(name="and_")
or_ = Or(name="or_")
invert = Invert(name="invert")
switch = Switch(name="switch")
identity = Identity(name="identity")
log = Log(name="log")
cos = Cos(name="cos")
sin = Sin(name="sin")
clip_scalar = Clip(name="clip")
int_div = IntDiv(name="int_div")
mod = Mod(name="mod")
ceil = Ceil(name="ceil")
floor = Floor(name="floor")
trunc = Trunc(name="trunc")
round_half_to_even = RoundHalfToEven(name="round_half_to_even")
round_half_away_from_zero = RoundHalfAwayFromZero(name="round_half_away_from_zero")
xor = Xor(name="xor")
shift_left = ShiftLeft(name="shift_left")
shift_right = ShiftRight(name="shift_right")
exp2 = Exp2(name="exp2")
expm1 = Expm1(name="expm1")
log2 = Log2(name="log2")
log10 = Log10(name="log10")
log1p = Log1p(name="log1p")
deg2rad = Deg2Rad(name="deg2rad")
rad2deg = Rad2Deg(name="rad2deg")
tan = Tan(name="tan")
arccos = ArcCos(name="arccos")
arcsin = ArcSin(name="arcsin")
arctan = ArcTan(name="arctan")
arctan2 = ArcTan2(name="arctan2")
cosh = Cosh(name="cosh")
sinh = Sinh(name="sinh")
tanh = Tanh(name="tanh")
arccosh = ArcCosh(name="arccosh")
arcsinh = ArcSinh(name="arcsinh")
arctanh = ArcTanh(name="arctanh")
mean_scalar = Mean(name="mean")
reciprocal = Reciprocal(name="reciprocal")
