"""Elementwise math, reductions and ``Dot`` with their gradients
(reference ``aesara_tpu/tensor/math.py``): the real scalar table and the
special functions K1 computes, and the reductions the encoder's train
step, the optimizers and the MLP use."""

from __future__ import annotations

import builtins

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar import math as aesm, ops as aes
from aesara_tpu_torch.scalar.ops import discrete_dtypes, to_host, upcast
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast, constant
from aesara_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["add", "sub", "mul", "true_div", "neg", "sqr", "sqrt", "exp", "maximum", "ge", "lt",
           "pow", "abs", "sgn", "minimum", "gt", "le", "eq", "neq", "and_", "or_", "invert", "log",
           "cos", "sin", "clip", "isnan", "isinf", "Sum", "sum", "mean", "var", "std", "Prod", "prod", "Max", "Min", "All", "Any",
           "max", "min", "all", "any", "Argmax", "argmax", "Dot", "dot", "tensordot", "BatchedDot", "batched_dot",
           "int_div", "floor_div", "mod", "ceil", "floor", "trunc", "round_half_to_even", "round_half_away_from_zero",
           "xor", "shift_left", "shift_right", "exp2", "expm1", "log2", "log10", "log1p", "deg2rad",
           "rad2deg", "tan", "arccos", "arcsin", "arctan", "arctan2", "cosh", "sinh", "tanh", "arccosh",
           "arcsinh", "arctanh", "reciprocal", "inv", "erf", "erfc", "erfinv", "erfcinv", "erfcx", "gamma",
           "gammaln", "psi", "tri_gamma", "j0", "j1", "i0", "i1", "sigmoid", "expit", "softplus",
           "log1pexp", "log1mexp", "logaddexp", "logsumexp"]


def _ew(scalar_op):
    op = Elemwise(scalar_op)

    def fn(*args):
        return op(*args)

    fn.__name__ = str(scalar_op)
    return fn


add = _ew(aes.add)
sub = _ew(aes.sub)
mul = _ew(aes.mul)
true_div = _ew(aes.true_div)
neg = _ew(aes.neg)
sqr = _ew(aes.sqr)
sqrt = _ew(aes.sqrt)
exp = _ew(aes.exp)
maximum = _ew(aes.maximum)
ge = _ew(aes.ge)
lt = _ew(aes.lt)
pow = _ew(aes.pow)
abs = _ew(aes.abs_)
sgn = _ew(aes.sgn)
minimum = _ew(aes.minimum)
gt = _ew(aes.gt)
le = _ew(aes.le)
eq = _ew(aes.eq)
neq = _ew(aes.neq)
and_ = _ew(aes.and_)
or_ = _ew(aes.or_)
invert = _ew(aes.invert)
log = _ew(aes.log)
cos = _ew(aes.cos)
sin = _ew(aes.sin)
isnan_ = _ew(aes.isnan)
isinf_ = _ew(aes.isinf)
int_div = _ew(aes.int_div)
floor_div = int_div
mod = _ew(aes.mod)
ceil = _ew(aes.ceil)
floor = _ew(aes.floor)
trunc = _ew(aes.trunc)
round_half_to_even = _ew(aes.round_half_to_even)
round_half_away_from_zero = _ew(aes.round_half_away_from_zero)
xor = _ew(aes.xor)
shift_left = _ew(aes.shift_left)
shift_right = _ew(aes.shift_right)
exp2 = _ew(aes.exp2)
expm1 = _ew(aes.expm1)
log2 = _ew(aes.log2)
log10 = _ew(aes.log10)
log1p = _ew(aes.log1p)
deg2rad = _ew(aes.deg2rad)
rad2deg = _ew(aes.rad2deg)
tan = _ew(aes.tan)
arccos = _ew(aes.arccos)
arcsin = _ew(aes.arcsin)
arctan = _ew(aes.arctan)
arctan2 = _ew(aes.arctan2)
cosh = _ew(aes.cosh)
sinh = _ew(aes.sinh)
tanh = _ew(aes.tanh)
arccosh = _ew(aes.arccosh)
arcsinh = _ew(aes.arcsinh)
arctanh = _ew(aes.arctanh)
reciprocal = _ew(aes.reciprocal)
inv = reciprocal
erf = _ew(aesm.erf)
erfc = _ew(aesm.erfc)
erfinv = _ew(aesm.erfinv)
erfcinv = _ew(aesm.erfcinv)
erfcx = _ew(aesm.erfcx)
gamma = _ew(aesm.gamma)
gammaln = _ew(aesm.gammaln)
psi = _ew(aesm.psi)
tri_gamma = _ew(aesm.tri_gamma)
j0 = _ew(aesm.j0)
j1 = _ew(aesm.j1)
i0 = _ew(aesm.i0)
i1 = _ew(aesm.i1)
sigmoid = _ew(aesm.sigmoid)
expit = sigmoid
softplus = _ew(aesm.softplus)
log1pexp = softplus
log1mexp = _ew(aesm.log1mexp)


def logaddexp(a, b):
    """log(exp(a) + exp(b)) without overflow, as the JAX package builds it."""
    m = maximum(a, b)
    return add(m, log1p(exp(neg(abs(sub(a, b))))))


def logsumexp(x, axis=None, keepdims=False):
    """log(sum(exp(x), axis)) shifted by the max, as the JAX package
    builds it."""
    x = as_tensor_variable(x)
    m = max(x, axis=axis, keepdims=True)
    res = add(log(sum(exp(sub(x, m)), axis=axis, keepdims=True)), m)
    if keepdims:
        return res
    axes = (range(x.type.ndim) if axis is None else [int(axis) % x.type.ndim]
            if isinstance(axis, (int, np.integer)) else [int(a) % x.type.ndim for a in axis])
    return DimShuffle(res.type.ndim, tuple(d for d in range(x.type.ndim) if d not in axes))(res)


def clip(x, min_, max_):
    """minimum(maximum(x, min_), max_), as the JAX package builds it."""
    return minimum(maximum(x, min_), max_)


def isnan(x):
    """A bool tensor; a discrete ``x`` has no NaN, so its result is a
    constant False of its shape."""
    from aesara_tpu_torch.tensor.basic import zeros_like

    x = as_tensor_variable(x)
    return zeros_like(x, dtype="bool") if x.type.dtype in discrete_dtypes else isnan_(x)


def isinf(x):
    """A bool tensor; a discrete ``x`` has no infinity."""
    from aesara_tpu_torch.tensor.basic import zeros_like

    x = as_tensor_variable(x)
    return zeros_like(x, dtype="bool") if x.type.dtype in discrete_dtypes else isinf_(x)


class Sum(CAReduce):
    """Sum reduction with an optional accumulator dtype."""

    def __init__(self, axis=None, dtype=None, acc_dtype=None):
        super().__init__(aes.add, axis=axis, dtype=dtype, acc_dtype=acc_dtype)

    def grad(self, inputs, output_grads):
        """The output gradient broadcast back over the summed axes."""
        from aesara_tpu_torch.tensor.basic import fill, zeros_like

        (x,) = inputs
        (gz,) = output_grads
        if x.type.dtype in discrete_dtypes:
            return [zeros_like(x, dtype=config.floatX)]
        axes = self._normalized_axes(x.type.ndim)
        order, k = [], 0
        for d in range(x.type.ndim):
            if d in axes:
                order.append("x")
            else:
                order.append(k)
                k += 1
        gx = fill(x, DimShuffle(gz.type.ndim, tuple(order))(gz))
        return [cast(gx, x.type.dtype)]

    def __str__(self):
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"Sum{ax}"


def sum(x, axis=None, dtype=None, keepdims=False, acc_dtype=None):
    x = as_tensor_variable(x)
    op = Sum(axis=axis, dtype=dtype, acc_dtype=acc_dtype)
    res = op(x)
    if keepdims:
        axes = op._normalized_axes(x.type.ndim)
        order, k = [], 0
        for d in range(x.type.ndim):
            if d in axes:
                order.append("x")
            else:
                order.append(k)
                k += 1
        res = DimShuffle(res.type.ndim, tuple(order))(res)
    return res


def mean(x, axis=None, dtype=None, keepdims=False, acc_dtype=None):
    """Mean built as sum / size, as the JAX package builds it."""
    from aesara_tpu_torch.tensor.shape import shape_tuple

    x = as_tensor_variable(x)
    s = sum(x, axis=axis, dtype=acc_dtype, keepdims=keepdims, acc_dtype=acc_dtype)
    if axis is None:
        axes = list(range(x.type.ndim))
    elif isinstance(axis, (int, np.integer)):
        axes = [int(axis) % x.type.ndim]
    else:
        axes = [int(a) % x.type.ndim for a in axis]
    shp = shape_tuple(x)
    n = constant(1, dtype="int64")
    for a in axes:
        n = mul(n, shp[a])
    if dtype is None:
        dtype = s.type.dtype if s.type.dtype not in discrete_dtypes else config.floatX
    res = true_div(cast(s, dtype) if s.type.dtype in discrete_dtypes else s, cast(n, dtype))
    return cast(res, dtype) if res.type.dtype != dtype else res


def var(x, axis=None, ddof=0, keepdims=False, corrected=False):
    """Variance built as the mean of squared deviations, as the JAX
    package builds it (``ddof`` rescales by n / (n - ddof))."""
    from aesara_tpu_torch.tensor.shape import shape_tuple

    x = as_tensor_variable(x)
    m = mean(x, axis=axis, keepdims=True)
    sq = mean(sqr(sub(x, m)), axis=axis, keepdims=keepdims)
    if ddof:
        if axis is None:
            axes = list(range(x.type.ndim))
        elif isinstance(axis, (int, np.integer)):
            axes = [int(axis) % x.type.ndim]
        else:
            axes = [int(a) % x.type.ndim for a in axis]
        shp = shape_tuple(x)
        n = constant(1, dtype="int64")
        for a in axes:
            n = mul(n, shp[a])
        nf = cast(n, sq.type.dtype)
        sq = mul(sq, true_div(nf, sub(nf, constant(float(ddof)))))
    return sq


def std(x, axis=None, ddof=0, keepdims=False):
    return sqrt(var(x, axis=axis, ddof=ddof, keepdims=keepdims))


def _kept_order(ndim: int, axes):
    """The DimShuffle order that puts the reduced ``axes`` back as size 1."""
    order, k = [], 0
    for d in range(ndim):
        if d in axes:
            order.append("x")
        else:
            order.append(k)
            k += 1
    return tuple(order)


class Prod(CAReduce):
    """Product over ``axis`` (small integers multiply in int64)."""

    def __init__(self, axis=None, dtype=None, acc_dtype=None):
        super().__init__(aes.mul, axis=axis, dtype=dtype, acc_dtype=acc_dtype)

    def grad(self, inputs, output_grads):
        """d prod / d x_i = the product of the other entries, computed
        without dividing by a zero x_i (as the JAX package's)."""
        from aesara_tpu_torch.tensor.basic import fill, ones_like, switch, zeros_like

        (x,) = inputs
        (gz,) = output_grads
        if x.type.dtype in discrete_dtypes:
            return [zeros_like(x, dtype=config.floatX)]
        order = _kept_order(x.type.ndim, self._normalized_axes(x.type.ndim))
        pad = lambda v: DimShuffle(gz.type.ndim, order)(v)  # noqa: E731
        is_zero = eq(x, constant(0, dtype=x.type.dtype))
        x_safe = switch(is_zero, ones_like(x), x)
        pnzf = fill(x, pad(Prod(axis=self.axis, dtype=self.dtype, acc_dtype=self.acc_dtype)(x_safe)))
        zf = fill(x, pad(Sum(axis=self.axis)(cast(is_zero, "int64"))))
        others = switch(eq(zf, 0), true_div(pnzf, x_safe),
                        switch(and_(eq(zf, 1), is_zero), pnzf, zeros_like(x)))
        gx = mul(fill(x, pad(gz)), others)
        return [cast(gx, x.type.dtype) if gx.type.dtype != x.type.dtype else gx]

    def __str__(self):
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"Prod{ax}"


class Max(CAReduce):
    """Maximum over ``axis``; the gradient goes to every maximal entry."""

    def __init__(self, axis=None):
        super().__init__(aes.maximum, axis=axis)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined
        from aesara_tpu_torch.tensor.basic import fill

        (x,) = inputs
        (gz,) = output_grads
        if x.type.dtype in discrete_dtypes:
            return [grad_undefined(self, 0, x)]
        order = _kept_order(x.type.ndim, self._normalized_axes(x.type.ndim))
        out = self(x)
        out_pad = DimShuffle(out.type.ndim, order)(out)
        gz_pad = DimShuffle(gz.type.ndim, order)(gz)
        mask = cast(eq(x, fill(x, out_pad)), x.type.dtype)
        return [mul(mask, fill(x, gz_pad))]

    def __str__(self):
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"Max{ax}"


class Min(CAReduce):
    """Minimum over ``axis``: min(x) = -max(-x) for the gradient."""

    def __init__(self, axis=None):
        super().__init__(aes.minimum, axis=axis)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        (gz,) = output_grads
        return [neg(Max(axis=self.axis).grad([neg(x)], [neg(gz)])[0])]

    def __str__(self):
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"Min{ax}"


class All(CAReduce):
    """Logical and over ``axis``; a non-bool input is compared with 0 first."""

    def __init__(self, axis=None):
        super().__init__(aes.and_, axis=axis, dtype="bool")

    def make_node(self, inp):
        inp = as_tensor_variable(inp)
        if inp.type.dtype != "bool":
            inp = neq(inp, constant(0, dtype="int8"))
        return super().make_node(inp)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, 0, inputs[0])]

    def __str__(self):
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"All{ax}"


class Any(CAReduce):
    """Logical or over ``axis``; a non-bool input is compared with 0 first."""

    def __init__(self, axis=None):
        super().__init__(aes.or_, axis=axis, dtype="bool")

    def make_node(self, inp):
        inp = as_tensor_variable(inp)
        if inp.type.dtype != "bool":
            inp = neq(inp, constant(0, dtype="int8"))
        return super().make_node(inp)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, 0, inputs[0])]

    def __str__(self):
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"Any{ax}"


def _reduce(op, x, keepdims):
    x = as_tensor_variable(x)
    res = op(x)
    if keepdims:
        res = DimShuffle(res.type.ndim, _kept_order(x.type.ndim, op._normalized_axes(x.type.ndim)))(res)
    return res


def prod(x, axis=None, dtype=None, keepdims=False, acc_dtype=None):
    return _reduce(Prod(axis=axis, dtype=dtype, acc_dtype=acc_dtype), x, keepdims)


def max(x, axis=None, keepdims=False):
    return _reduce(Max(axis), x, keepdims)


def min(x, axis=None, keepdims=False):
    return _reduce(Min(axis), x, keepdims)


def all(x, axis=None, keepdims=False):
    return _reduce(All(axis), x, keepdims)


def any(x, axis=None, keepdims=False):
    return _reduce(Any(axis), x, keepdims)


class Argmax(Op):
    """The index of the first maximum over ``axis`` (None: all axes, over
    the flattened array), as int64."""

    __props__ = ("axis",)

    def __init__(self, axis=None):
        if axis is None:
            self.axis = None
        elif isinstance(axis, (int, np.integer)):
            self.axis = (int(axis),)
        else:
            self.axis = tuple(sorted(int(a) for a in axis))

    def axes(self, ndim: int):
        if self.axis is None:
            return tuple(range(ndim))
        if builtins.any(not -ndim <= a < ndim for a in self.axis):
            raise ValueError(f"axis {self.axis} out of range for ndim {ndim}")
        return tuple(sorted(a % ndim for a in self.axis))

    def make_node(self, x):
        x = as_tensor_variable(x)
        axes = self.axes(x.type.ndim)
        out_shape = tuple(s for d, s in enumerate(x.type.shape) if d not in axes)
        return Apply(self, [x], [TensorType("int64", out_shape)()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        axes = self.axes(x.ndim)
        keep = [d for d in range(x.ndim) if d not in axes]
        flat = np.transpose(x, keep + list(axes)).reshape([x.shape[d] for d in keep] + [-1])
        output_storage[0][0] = np.asarray(np.argmax(flat, axis=-1), dtype=np.int64)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, 0, inputs[0], "argmax is discrete")]

    def __str__(self):
        return f"Argmax{{axis={self.axis}}}"


def argmax(x, axis=None):
    return Argmax(axis)(x)


class Dot(Op):
    """Vector/matrix product for ndim 1 or 2."""

    __props__ = ()

    def make_node(self, x, y):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if x.type.ndim not in (1, 2) or y.type.ndim not in (1, 2):
            raise TypeError(f"Dot supports ndim 1/2, got {x.type.ndim} and {y.type.ndim}")
        xi, yi = x.type.shape[-1], y.type.shape[0]
        if xi is not None and yi is not None and xi != yi:
            raise TypeError(f"Dot inner dims mismatch: {xi} vs {yi}")
        out_shape = x.type.shape[:-1] + y.type.shape[1:]
        return Apply(self, [x, y], [TensorType(upcast(x.type.dtype, y.type.dtype), out_shape)()])

    def perform(self, node, inputs, output_storage):
        x, y = inputs
        output_storage[0][0] = to_host(np.dot(x, y), node.outputs[0].type.dtype)

    def grad(self, inputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        if x.type.ndim == 2 and y.type.ndim == 2:
            gx, gy = dot(gz, y.T), dot(x.T, gz)
        elif x.type.ndim == 1 and y.type.ndim == 2:
            gx, gy = dot(gz, y.T), _dot(x.dimshuffle(0, "x"), gz.dimshuffle("x", 0))
        elif x.type.ndim == 2 and y.type.ndim == 1:
            gx, gy = _dot(gz.dimshuffle(0, "x"), y.dimshuffle("x", 0)), dot(x.T, gz)
        else:
            gx, gy = mul(gz, y), mul(gz, x)
        return [cast(gx, x.type.dtype), cast(gy, y.type.dtype)]

    def __str__(self):
        return "dot"


_dot = Dot()


def dot(x, y):
    """NumPy dot semantics; an operand above 2-d goes through tensordot; a
    sparse operand routes to the sparse ``Dot``, as
    ``aesara_tpu/tensor/math.py:805-818`` does."""
    from aesara_tpu_torch.sparse.type import SparseTensorType

    if builtins.any(isinstance(getattr(v, "type", None), SparseTensorType) for v in (x, y)):
        from aesara_tpu_torch.sparse.basic import dot as sparse_dot

        return sparse_dot(x, y)
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    if x.type.ndim == 0 or y.type.ndim == 0:
        return mul(x, y)
    if x.type.ndim > 2 or y.type.ndim > 2:
        return tensordot(x, y, [[x.type.ndim - 1], [builtins.max(y.type.ndim - 2, 0)]])
    return _dot(x, y)


class BatchedDot(Op):
    """Product over a leading batch dim of ndim 2 or 3 operands (reference
    ``aesara_tpu/tensor/math.py:715-830``): (b,i,j)x(b,j,k), (b,i,j)x(b,j),
    (b,i)x(b,i,j) and (b,i)x(b,i)."""

    __props__ = ()

    def make_node(self, x, y):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if x.type.ndim not in (2, 3) or y.type.ndim not in (2, 3):
            raise TypeError("BatchedDot needs ndim 2 or 3 inputs")
        xs, ys = x.type.shape, y.type.shape
        batch = xs[0] if xs[0] is not None else ys[0]
        out_shape = (batch,) + xs[1:-1] + ys[2:]
        return Apply(self, [x, y], [TensorType(upcast(x.type.dtype, y.type.dtype), out_shape)()])

    def perform(self, node, inputs, output_storage):
        x, y = inputs
        res = np.einsum(_BATCHED_SUBSCRIPTS[x.ndim, y.ndim], x, y)
        output_storage[0][0] = to_host(res, node.outputs[0].type.dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        xs, ys = input_shapes
        return [(xs[0],) + tuple(xs[1:-1]) + tuple(ys[2:])]

    def grad(self, inputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        xdim, ydim = x.type.ndim, y.type.ndim
        if xdim == 3 and ydim == 3:
            gx = batched_dot(gz, y.dimshuffle(0, 2, 1))
            gy = batched_dot(x.dimshuffle(0, 2, 1), gz)
        elif xdim == 3 and ydim == 2:
            gx = mul(gz.dimshuffle(0, 1, "x"), y.dimshuffle(0, "x", 1))
            gy = batched_dot(x.dimshuffle(0, 2, 1), gz)
        elif xdim == 2 and ydim == 3:
            gx = batched_dot(gz, y.dimshuffle(0, 2, 1))
            gy = mul(x.dimshuffle(0, 1, "x"), gz.dimshuffle(0, "x", 1))
        else:
            gx = mul(gz.dimshuffle(0, "x"), y)
            gy = mul(gz.dimshuffle(0, "x"), x)
        if gx.type.dtype != x.type.dtype:
            gx = cast(gx, x.type.dtype)
        if gy.type.dtype != y.type.dtype:
            gy = cast(gy, y.type.dtype)
        return [gx, gy]

    def __str__(self):
        return "batched_dot"


#: the einsum of each (x.ndim, y.ndim) case of BatchedDot
_BATCHED_SUBSCRIPTS = {(3, 3): "bij,bjk->bik", (3, 2): "bij,bj->bi", (2, 3): "bi,bij->bj", (2, 2): "bi,bi->b"}

_batched_dot = BatchedDot()


def batched_dot(x, y):
    return _batched_dot(x, y)


def tensordot(a, b, axes):
    """numpy.tensordot as transpose + reshape + Dot (the JAX package's
    ``_tensordot_as_dot``, unbatched)."""
    from aesara_tpu_torch.tensor.shape import reshape, shape_tuple

    a, b = as_tensor_variable(a), as_tensor_variable(b)
    a_axes = [int(ax) % a.type.ndim for ax in np.atleast_1d(axes[0])]
    b_axes = [int(ax) % b.type.ndim for ax in np.atleast_1d(axes[1])]
    if len(a_axes) != len(b_axes):
        raise ValueError("tensordot axes must have equal length")
    a_free = [d for d in range(a.type.ndim) if d not in a_axes]
    b_free = [d for d in range(b.type.ndim) if d not in b_axes]
    at = a.dimshuffle(*(a_free + a_axes))
    bt = b.dimshuffle(*(b_axes + b_free))
    ashape, bshape = shape_tuple(at), shape_tuple(bt)
    nfa, nca = len(a_free), len(a_axes)
    one = constant(1, dtype="int64")

    def prod_dims(dims):
        r = one
        for d in dims:
            r = mul(r, d)
        return r

    am = reshape(at, [prod_dims(ashape[:nfa]), prod_dims(ashape[nfa:])], ndim=2)
    bm = reshape(bt, [prod_dims(bshape[:nca]), prod_dims(bshape[nca:])], ndim=2)
    out = _dot(am, bm)
    final = [ashape[i] for i in range(nfa)] + [bshape[nca + i] for i in range(len(b_free))]
    return reshape(out, final, ndim=len(final))
