"""``TensorVariable``: the NumPy-like operator surface (reference
``aesara_tpu/tensor/var.py``).

One deliberate difference: ``x.shape`` is a tuple of 0-d int64 variables
(a constant for each static dim, ``Shape_i`` otherwise).  In the JAX
package ``x.shape[i]`` builds ``Subtensor(Shape(x))``, which its
canonicalizer rewrites to the same ``Shape_i``; the port builds the
rewritten form directly.
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

    @property
    def shape(self) -> tuple:
        from aesara_tpu_torch.tensor.shape import shape_tuple

        return shape_tuple(self)

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
