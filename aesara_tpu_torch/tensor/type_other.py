"""Symbolic slice and None types (reference ``aesara_tpu/tensor/type_other.py``):
``SliceType`` with ``SliceConstant``, ``MakeSlice``, ``NoneTypeT`` and
``NoneConst``.

Indexing keeps its slices in an op's ``idx_list``; these types pass a
slice around as a value of its own.  ``take_slice`` unwraps a
``MakeSlice`` output back into its parts and a ``SliceConstant`` into its
Python slice.
"""

from __future__ import annotations

from aesara_tpu_torch.graph.ir import Apply, Constant, Type
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable


__all__ = ["SliceType", "slicetype", "SliceConstant", "MakeSlice", "make_slice", "NoneTypeT", "none_type_t",
           "NoneConst", "as_int_none_variable", "as_symbolic_slice", "as_symbolic_None"]


class SliceType(Type):
    def filter(self, data, strict=False, allow_downcast=None):
        if isinstance(data, slice):
            return data
        raise TypeError(f"expected a slice, got {type(data)}")

    def __eq__(self, other):
        return type(other) is SliceType

    def __hash__(self):
        return hash(SliceType)

    def __str__(self):
        return "slice"


slicetype = SliceType()


class SliceConstant(Constant):
    def __init__(self, type, data, name=None):
        assert isinstance(data, slice)
        super().__init__(type, data, name=name)

    def signature(self):
        return (SliceType, self.data.start, self.data.stop, self.data.step)

    def __str__(self):
        return f"SliceConstant{{{self.data.start},{self.data.stop},{self.data.step}}}"


class NoneTypeT(Type):
    """The type whose only value is None."""

    def filter(self, data, strict=False, allow_downcast=None):
        if data is None:
            return None
        raise TypeError(f"expected None, got {data!r}")

    def __eq__(self, other):
        return type(other) is NoneTypeT

    def __hash__(self):
        return hash(NoneTypeT)

    def __str__(self):
        return "NoneType"


none_type_t = NoneTypeT()
NoneConst = Constant(none_type_t, None, name="NoneConst")


def as_int_none_variable(x):
    if x is None:
        return NoneConst
    x = as_tensor_variable(x)
    if x.type.ndim != 0 or not x.type.dtype.startswith(("int", "uint")):
        from aesara_tpu_torch.tensor.basic import cast

        x = cast(x, "int64")
    return x


class MakeSlice(Op):
    """(start, stop, step) → a slice value."""

    __props__ = ()

    def make_node(self, *inputs):
        return Apply(self, [as_int_none_variable(i) for i in inputs], [slicetype()])

    def perform(self, node, inputs, output_storage):
        vals = [None if v is None else int(v) for v in inputs]
        while len(vals) < 3:
            vals.append(None)
        output_storage[0][0] = slice(*vals)


make_slice = MakeSlice()


def as_symbolic_slice(x, **kwargs):
    if isinstance(x, slice):
        return SliceConstant(slicetype, x)
    raise TypeError(f"cannot interpret {x} as a symbolic slice")


def as_symbolic_None(x, **kwargs):
    if x is None:
        return NoneConst
    raise TypeError("expected None")
