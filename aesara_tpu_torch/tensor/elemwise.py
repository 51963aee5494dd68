"""``DimShuffle``, ``Elemwise`` and ``CAReduce``: the scalar algebra lifted
to tensors (reference ``aesara_tpu/tensor/elemwise.py``).

Broadcasting contract: a dimension broadcasts only if its *static* shape
is 1.  Unknown (None) dims are non-broadcastable; a runtime size-1 dim
there raises when the graph runs.
"""

from __future__ import annotations

from copy import copy
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.scalar.ops import ScalarType, _np_dtype, discrete_dtypes, to_host
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["DimShuffle", "Elemwise", "CAReduce", "check_static_broadcast"]


class DimShuffle(Op):
    """Transpose, insert broadcast dims ('x') and drop size-1 dims."""

    __props__ = ("input_ndim", "new_order")

    def __init__(self, input_ndim: int, new_order: Sequence[Union[int, str]]):
        self.input_ndim = int(input_ndim)
        self.new_order = tuple(new_order)
        kept = [d for d in self.new_order if d != "x"]
        for d in kept:
            if not isinstance(d, (int, np.integer)) or not 0 <= d < input_ndim:
                raise ValueError(f"bad axis {d!r} for ndim {input_ndim}")
        if len(kept) != len(set(kept)):
            raise ValueError(f"duplicate axes in {new_order}")
        self.drop = [i for i in range(input_ndim) if i not in self.new_order]
        self.shuffle = kept
        self.augment = [i for i, d in enumerate(self.new_order) if d == "x"]
        self.transposition = self.shuffle + self.drop
        self.is_transpose = not self.drop and not self.augment

    def make_node(self, inp) -> Apply:
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        inp = as_tensor_variable(inp)
        if inp.type.ndim != self.input_ndim:
            raise TypeError(f"DimShuffle expected ndim {self.input_ndim}, got {inp.type.ndim}")
        for d in self.drop:
            if inp.type.shape[d] != 1:
                raise TypeError(f"cannot drop non-broadcastable dim {d} of {inp.type}")
        out_shape = tuple(1 if d == "x" else inp.type.shape[d] for d in self.new_order)
        return Apply(self, [inp], [TensorType(inp.type.dtype, out_shape)()])

    def out_shape(self, in_shape) -> tuple:
        """Runtime output shape from the input's shape."""
        return tuple(1 if d == "x" else in_shape[d] for d in self.new_order)

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        output_storage[0][0] = np.transpose(x, self.transposition).reshape(self.out_shape(x.shape))

    def grad(self, inputs, output_grads):
        (x,) = inputs
        (gz,) = output_grads
        if x.type.dtype in discrete_dtypes:
            from aesara_tpu_torch.tensor.basic import zeros_like

            return [zeros_like(x)]
        # the inverse permutation; dims the forward dropped come back as 'x'
        grad_order = ["x"] * x.type.ndim
        for i, d in enumerate(self.new_order):
            if d != "x":
                grad_order[d] = i
        res = gz
        if self.augment:
            # the forward broadcast these dims: sum them out (keeping them
            # as size 1, which the inverse shuffle then drops)
            from aesara_tpu_torch.tensor.math import sum as tsum

            res = tsum(res, axis=self.augment, keepdims=True)
        return [DimShuffle(res.type.ndim, grad_order)(res)]

    def __str__(self):
        if self.is_transpose:
            return f"Transpose{{axes={self.shuffle}}}"
        return f"DimShuffle{{order=[{', '.join(map(str, self.new_order))}]}}"


def check_static_broadcast(static_shapes, runtime_shapes) -> None:
    """Raise if a dim broadcasts at runtime that is not statically 1
    (the JAX package's ``dispatch.py:554-580`` rule)."""
    ndim = max((len(s) for s in runtime_shapes), default=0)
    for d in range(ndim):
        dims = [s[d - ndim + len(s)] if d - ndim + len(s) >= 0 else 1 for s in runtime_shapes]
        if max(dims) == 1:
            continue
        for s, st in zip(runtime_shapes, static_shapes):
            k = d - ndim + len(s)
            if k >= 0 and s[k] == 1 and st[k] is None:
                raise ValueError(f"runtime broadcasting of non-broadcastable dim {k} "
                                 f"(static shape {st}, got {tuple(s)})")


class Elemwise(Op):
    """Broadcast a ScalarOp over tensors; lower-rank inputs are left-padded
    with broadcast dims in ``make_node``."""

    __props__ = ("scalar_op",)

    def __init__(self, scalar_op, name=None):
        self.scalar_op = scalar_op
        self.name = name

    def make_node(self, *inputs) -> Apply:
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        inputs = [as_tensor_variable(i) for i in inputs]
        target_ndim = max(i.type.ndim for i in inputs)
        padded = [
            DimShuffle(i.type.ndim, ("x",) * (target_ndim - i.type.ndim) + tuple(range(i.type.ndim)))(i)
            if i.type.ndim < target_ndim else i
            for i in inputs
        ]
        out_shape = []
        for dim in range(target_ndim):
            dims = [i.type.shape[dim] for i in padded]
            non_one = {d for d in dims if d is not None and d != 1}
            if len(non_one) > 1:
                raise TypeError(f"incompatible Elemwise input shapes at dim {dim}: {dims}")
            if non_one:
                out_shape.append(next(iter(non_one)))
            else:
                out_shape.append(1 if all(d == 1 for d in dims) else None)
        out_types = self.scalar_op.output_types([ScalarType(i.type.dtype) for i in padded])
        outputs = [TensorType(t.dtype, tuple(out_shape))() for t in out_types]
        return Apply(self, padded, outputs)

    def __str__(self):
        return self.name or f"Elemwise{{{self.scalar_op}}}"

    def connection_pattern(self, node):
        snode = self.scalar_op.make_node(*[ScalarType(i.type.dtype)() for i in node.inputs])
        return self.scalar_op.connection_pattern(snode)

    def L_op(self, inputs, outs, ograds):
        """The scalar op's gradient, built over scalar placeholders, lifted
        to a tensor graph over the inputs, then summed over the dims
        where an input was broadcast against the output."""
        from aesara_tpu_torch.gradient import DisconnectedType, NullType
        from aesara_tpu_torch.tensor.basic import cast, constant

        markers = (DisconnectedType, NullType)
        s_inputs = [ScalarType(i.type.dtype)() for i in inputs]
        s_node = self.scalar_op.make_node(*s_inputs)
        s_ograds = [g if isinstance(g.type, markers) else ScalarType(g.type.dtype)()
                    for g in ograds]
        s_igrads = self.scalar_op.L_op(s_inputs, s_node.outputs, s_ograds)
        mapping = dict(zip(s_inputs, inputs))
        mapping.update(zip(s_node.outputs, outs))
        mapping.update((s, t) for s, t in zip(s_ograds, ograds) if not isinstance(s.type, markers))

        def lift(s_var):
            if s_var in mapping:
                return mapping[s_var]
            if isinstance(s_var.type, markers):
                return s_var
            if s_var.owner is None:
                res = constant(s_var.data)   # a 0-d constant broadcasts
            else:
                t_ins = [lift(i) for i in s_var.owner.inputs]
                bad = next((t for t in t_ins if isinstance(t.type, markers)), None)
                if bad is not None:
                    res = bad
                else:
                    t_node = Elemwise(s_var.owner.op).make_node(*t_ins)
                    mapping.update(zip(s_var.owner.outputs, t_node.outputs))
                    res = t_node.outputs[s_var.index]
            mapping[s_var] = res
            return res

        rval = []
        for inp, s_igrad in zip(inputs, s_igrads):
            gx = lift(s_igrad)
            if isinstance(gx.type, markers):
                rval.append(gx)
                continue
            # dims where the input was broadcast against the output
            to_sum = [d for d in range(inp.type.ndim)
                      if inp.type.shape[d] == 1 and outs[0].type.shape[d] != 1]
            if to_sum:
                from aesara_tpu_torch.tensor.math import sum as tsum

                gx = tsum(gx, axis=to_sum, keepdims=True)
            if gx.type.dtype != inp.type.dtype and inp.type.dtype not in discrete_dtypes:
                gx = cast(gx, inp.type.dtype)
            rval.append(gx)
        return rval

    def perform(self, node, inputs, output_storage):
        check_static_broadcast([i.type.shape for i in node.inputs], [np.shape(i) for i in inputs])
        out_dts = [o.type.dtype for o in node.outputs]
        if all(dt not in discrete_dtypes for dt in out_dts):
            # compute in the output dtype, as the device path does
            tgt = _np_dtype(out_dts[0])
            inputs = [np.asarray(i).astype(tgt, copy=False) if np.asarray(i).dtype.kind in "bui" else i
                      for i in inputs]
        results = self.scalar_op.impl(*inputs)
        if self.scalar_op.nout == 1:
            results = (results,)
        for storage, r, o in zip(output_storage, results, node.outputs):
            storage[0] = to_host(r, o.type.dtype)


class CAReduce(Op):
    """Reduce along axes with a commutative, associative ScalarOp."""

    __props__ = ("scalar_op", "axis", "dtype", "acc_dtype")

    def __init__(self, scalar_op, axis: Optional[Union[int, Sequence[int]]] = None,
                 dtype: Optional[str] = None, acc_dtype: Optional[str] = None):
        self.scalar_op = scalar_op
        if axis is None:
            self.axis = None
        elif isinstance(axis, (int, np.integer)):
            self.axis = (int(axis),)
        else:
            self.axis = tuple(sorted(int(a) for a in axis))
        self.dtype = dtype
        self.acc_dtype = acc_dtype

    def _normalized_axes(self, ndim: int) -> Tuple[int, ...]:
        if self.axis is None:
            return tuple(range(ndim))
        axes = tuple(sorted(a + ndim if a < 0 else a for a in self.axis))
        if any(a < 0 or a >= ndim for a in axes):
            raise ValueError(f"axis {self.axis} out of range for ndim {ndim}")
        return axes

    def _output_dtype(self, input_dtype: str) -> str:
        if self.dtype is not None:
            return self.dtype
        if not isinstance(self.scalar_op, (aes.Add, aes.Mul)):
            return input_dtype
        # NumPy semantics: small integers sum in the platform int
        if input_dtype in ("bool", "int8", "int16", "int32"):
            return "int64"
        if input_dtype in ("uint8", "uint16", "uint32"):
            return "uint64"
        return input_dtype

    def make_node(self, inp) -> Apply:
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        inp = as_tensor_variable(inp)
        axes = self._normalized_axes(inp.type.ndim)
        op = self
        if self.axis is not None and axes != self.axis:
            op = copy(self)
            op.axis = axes
        out_shape = tuple(s for d, s in enumerate(inp.type.shape) if d not in axes)
        return Apply(op, [inp], [TensorType(self._output_dtype(inp.type.dtype), out_shape)()])

    _np_reducers = {"add": np.add, "mul": np.multiply, "maximum": np.maximum, "minimum": np.minimum,
                    "and_": np.bitwise_and, "or_": np.bitwise_or}

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        axes = self._normalized_axes(x.ndim)
        # bfloat16 and float16 sum in float32, as jnp.sum computes them
        out_dtype = node.outputs[0].type.dtype
        acc_dtype = self.acc_dtype or out_dtype
        acc = x.astype(_np_dtype("float32" if acc_dtype in ("bfloat16", "float16") else acc_dtype), copy=False)
        if axes:
            acc = self._np_reducers[str(self.scalar_op)].reduce(acc, axis=axes)
        output_storage[0][0] = to_host(acc, out_dtype)

    def __str__(self):
        ax = "" if self.axis is None else f"{{axis={list(self.axis)}}}"
        return f"CAReduce{{{self.scalar_op}}}{ax}"
