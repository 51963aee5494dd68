"""``TensorVariable``: the NumPy-like operator surface (reference
``aesara_tpu/tensor/var.py``).  ``x.shape`` is a ``Shape`` vector, as
there: ``x.shape[i]`` builds ``Subtensor(Shape(x))``, which the
canonicalizer rewrites to ``Shape_i`` or a constant.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Constant, Variable
from aesara_tpu_torch.tensor.type import TensorType


def _coerce(other):
    """The foreign operand as a variable, or None for NotImplemented."""
    from aesara_tpu_torch.tensor.basic import as_tensor_variable

    if isinstance(other, Variable):
        return other
    try:
        return as_tensor_variable(other)
    except (TypeError, ValueError):
        return None


def _binary(fn_name, reflected=False):
    def op(self, other):
        from aesara_tpu_torch.tensor import math as tm

        other = _coerce(other)
        if other is None:
            return NotImplemented
        fn = getattr(tm, fn_name)
        return fn(other, self) if reflected else fn(self, other)

    return op


class _tensor_operators:
    """Operator overloads shared by variables, constants and shareds."""

    # make ndarray defer to the reflected dunders
    __array_priority__ = 1000

    __add__ = _binary("add")
    __radd__ = _binary("add", reflected=True)
    __sub__ = _binary("sub")
    __rsub__ = _binary("sub", reflected=True)
    __mul__ = _binary("mul")
    __rmul__ = _binary("mul", reflected=True)
    __truediv__ = _binary("true_div")
    __rtruediv__ = _binary("true_div", reflected=True)
    __pow__ = _binary("pow")
    __rpow__ = _binary("pow", reflected=True)
    __and__ = _binary("and_")
    __rand__ = _binary("and_", reflected=True)
    __or__ = _binary("or_")
    __ror__ = _binary("or_", reflected=True)
    __floordiv__ = _binary("int_div")
    __rfloordiv__ = _binary("int_div", reflected=True)
    __mod__ = _binary("mod")
    __rmod__ = _binary("mod", reflected=True)
    __xor__ = _binary("xor")
    __rxor__ = _binary("xor", reflected=True)
    __lshift__ = _binary("shift_left")
    __rshift__ = _binary("shift_right")
    __matmul__ = _binary("matmul")
    __rmatmul__ = _binary("matmul", reflected=True)
    __divmod__ = _binary("divmod_")
    __lt__ = _binary("lt")
    __le__ = _binary("le")
    __gt__ = _binary("gt")
    __ge__ = _binary("ge")

    def __abs__(self):
        from aesara_tpu_torch.tensor import math as tm

        return tm.abs(self)

    def __invert__(self):
        from aesara_tpu_torch.tensor import math as tm

        return tm.invert(self)

    def __bool__(self):
        # ``x < 0`` builds a graph: its truth value is a program error
        raise TypeError("cannot take the truth value of a symbolic variable; compare with tensor.eq/neq")

    def __neg__(self):
        from aesara_tpu_torch.tensor import math as tm

        return tm.neg(self)

    def __iter__(self):
        if self.type.ndim == 0:
            raise TypeError("iteration over a 0-d tensor")
        n = self.type.shape[0]
        if n is None:
            raise TypeError("cannot iterate over a tensor with unknown leading dimension")
        return iter(self[i] for i in range(n))

    @property
    def shape(self):
        from aesara_tpu_torch.tensor.shape import shape

        return shape(self)

    @property
    def ndim(self) -> int:
        return self.type.ndim

    @property
    def dtype(self) -> str:
        return self.type.dtype

    @property
    def T(self):
        return self.dimshuffle(*reversed(range(self.type.ndim)))

    def reshape(self, shape, ndim=None):
        from aesara_tpu_torch.tensor.shape import reshape

        return reshape(self, shape, ndim=ndim)

    def flatten(self, ndim=1):
        from aesara_tpu_torch.tensor.basic import flatten

        return flatten(self, ndim)

    def __getitem__(self, args):
        """Basic indexing (slices, integers, None, Ellipsis), a leading
        integer vector, or integer arrays over the leading dims
        (``subtensor.take_slice``)."""
        from aesara_tpu_torch.tensor.subtensor import take_slice

        return take_slice(self, args)

    def dimshuffle(self, *pattern):
        from aesara_tpu_torch.tensor.elemwise import DimShuffle

        if len(pattern) == 1 and isinstance(pattern[0], (list, tuple)):
            pattern = tuple(pattern[0])
        return DimShuffle(self.type.ndim, pattern)(self)

    # -- the NumPy-like methods (reference ``aesara_tpu/tensor/var.py:
    # 237-471``): each calls the function the JAX package's calls, so the
    # graph it builds has the same nodes

    @property
    def size(self):
        from aesara_tpu_torch.tensor.basic import constant
        from aesara_tpu_torch.tensor.math import prod
        from aesara_tpu_torch.tensor.shape import shape

        if self.type.ndim == 0:
            return constant(1, dtype="int64")
        return prod(shape(self))

    @property
    def broadcastable(self):
        return tuple(s == 1 for s in self.type.shape)

    def transpose(self, *axes):
        from aesara_tpu_torch.tensor.basic import transpose

        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return transpose(self, axes or None)

    def ravel(self):
        return self.flatten()

    def squeeze(self, axis=None):
        from aesara_tpu_torch.tensor.extra_ops import squeeze

        return squeeze(self, axis=axis)

    def take(self, indices, axis=None, mode="raise"):
        from aesara_tpu_torch.tensor.subtensor import take

        return take(self, indices, axis=axis, mode=mode)

    def diagonal(self, offset=0, axis1=0, axis2=1):
        from aesara_tpu_torch.tensor.basic import diagonal

        return diagonal(self, offset, axis1, axis2)

    def trace(self):
        """The sum of the diagonal (the JAX package's ``nlinalg.trace``)."""
        from aesara_tpu_torch.tensor.basic import diagonal
        from aesara_tpu_torch.tensor.math import sum as tsum

        return tsum(diagonal(self))

    def astype(self, dtype):
        from aesara_tpu_torch.tensor.basic import cast

        return cast(self, dtype)

    def copy(self, name=None):
        from aesara_tpu_torch.tensor.basic import tensor_copy

        out = tensor_copy(self)
        out.name = name
        return out

    def repeat(self, repeats, axis=None):
        from aesara_tpu_torch.tensor.extra_ops import repeat

        return repeat(self, repeats, axis=axis)

    def round(self, mode="half_to_even"):
        from aesara_tpu_torch.tensor import math as tm

        return tm.round(self, mode)

    def cumsum(self, axis=None):
        from aesara_tpu_torch.tensor.extra_ops import cumsum

        return cumsum(self, axis)

    def cumprod(self, axis=None):
        from aesara_tpu_torch.tensor.extra_ops import cumprod

        return cumprod(self, axis)

    def sort(self, axis=-1, kind="quicksort", order=None):
        from aesara_tpu_torch.tensor.sort import sort

        return sort(self, axis, kind, order)

    def argsort(self, axis=-1, kind="quicksort", order=None):
        from aesara_tpu_torch.tensor.sort import argsort

        return argsort(self, axis, kind, order)

    def nonzero(self, return_matrix=False):
        from aesara_tpu_torch.tensor.basic import nonzero

        return nonzero(self, return_matrix)

    def nonzero_values(self):
        from aesara_tpu_torch.tensor.basic import nonzero_values

        return nonzero_values(self)

    def choose(self, choices, mode="raise"):
        from aesara_tpu_torch.tensor.basic import choose

        return choose(self, choices, mode)

    def sum(self, axis=None, dtype=None, keepdims=False, acc_dtype=None):
        from aesara_tpu_torch.tensor import math as tm

        return tm.sum(self, axis=axis, dtype=dtype, keepdims=keepdims, acc_dtype=acc_dtype)

    def prod(self, axis=None, dtype=None, keepdims=False, acc_dtype=None):
        from aesara_tpu_torch.tensor import math as tm

        return tm.prod(self, axis=axis, dtype=dtype, keepdims=keepdims, acc_dtype=acc_dtype)

    def mean(self, axis=None, dtype=None, keepdims=False, acc_dtype=None):
        from aesara_tpu_torch.tensor import math as tm

        return tm.mean(self, axis=axis, dtype=dtype, keepdims=keepdims, acc_dtype=acc_dtype)

    def var(self, axis=None, ddof=0, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def std(self, axis=None, ddof=0, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.min(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.max(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.argmin(self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.argmax(self, axis=axis, keepdims=keepdims)

    def all(self, axis=None, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.all(self, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.any(self, axis=axis, keepdims=keepdims)

    def norm(self, L, axis=None, keepdims=False):
        from aesara_tpu_torch.tensor import math as tm

        return tm.norm(self, L, axis=axis, keepdims=keepdims)

    def dot(self, other):
        from aesara_tpu_torch.tensor import math as tm

        return tm.dot(self, other)

    def clip(self, a_min, a_max):
        from aesara_tpu_torch.tensor import math as tm

        return tm.clip(self, a_min, a_max)

    def fill(self, value):
        from aesara_tpu_torch.tensor.basic import fill

        return fill(self, value)

    def zeros_like(self, dtype=None):
        from aesara_tpu_torch.tensor.basic import zeros_like

        return zeros_like(self, dtype=dtype)

    def ones_like(self, dtype=None):
        from aesara_tpu_torch.tensor.basic import ones_like

        return ones_like(self, dtype=dtype)


class TensorVariable(_tensor_operators, Variable):
    """A tensor-typed symbolic variable; identity semantics for ``==``."""

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __ne__(self, other):
        return self is not other


class TensorConstant(TensorVariable, Constant):
    """A constant ndarray; equal constants compare and hash equal."""

    def __init__(self, type, data, name=None):
        if tuple(type.shape) != np.shape(data):
            type = type.clone(shape=np.shape(data))
        Constant.__init__(self, type, data, name)

    def __hash__(self):
        d = self.data
        return hash((self.type, d.shape, d.tobytes() if d.size <= 100000 else d.size))

    def __eq__(self, other):
        return isinstance(other, TensorConstant) and self.signature() == other.signature()

    def __ne__(self, other):
        return not self == other

    def __str__(self):
        if self.name is not None:
            return self.name
        return f"TensorConstant{{{np.array2string(np.asarray(self.data), threshold=5)}}}"


TensorType.variable_type = TensorVariable
TensorType.constant_type = TensorConstant
