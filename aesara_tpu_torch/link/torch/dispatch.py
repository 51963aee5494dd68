"""Per-op lowerings: ``torch_funcify(op, node=)`` returns a plain
function on tensors (the counterpart of ``jax_funcify`` in
``aesara_tpu/link/jax/dispatch.py`` and ``nnet_dispatch.py``).

An op with no registration raises ``NotImplementedError`` naming it.
Values the linker keeps on the host (shape arithmetic) reach a lowering
as NumPy values only at the positions listed in its ``host_inputs``
attribute; every other input arrives as a tensor on the linker's device.
A lowering whose results are host values says so (``host_outputs``); one
whose inputs at some positions must be host values lists them with its
reason (``needs_host``), and the linker refuses to compile a graph where
they are not.  One that makes the host wait for the device, so that no
CUDA graph can capture it, says that (``capturable = False``, with its
reason in ``blocker``), or lists the inputs it reads on the host where
they are on the device (``syncs``).  One that creates its result from host
values alone takes the program's device (``takes_device``).
"""

from __future__ import annotations

import math
from functools import singledispatch

import numpy as np

from aesara_tpu_torch.gradient import GradManipulatorOp
from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.scalar.composite import Composite
from aesara_tpu_torch.tensor.basic import (
    Alloc, AllocEmpty, ARange, Join, MakeVector, ScalarFromTensor, Split, TensorFromScalar,
)
from aesara_tpu_torch.tensor.blas import Dot22, Dot22Scalar, Gemm, Gemv, Ger
from aesara_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise, check_static_broadcast
from aesara_tpu_torch.tensor.extra_ops import BroadcastTo, CumOp, Repeat
from aesara_tpu_torch.tensor.math import Argmax, BatchedDot, Dot
from aesara_tpu_torch.tensor.nnet.attention import FusedAttention, FusedAttentionGrad
from aesara_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape, Unbroadcast, check_specified_shape
from aesara_tpu_torch.tensor.sort import ArgSortOp, SortOp, TopKOp
from aesara_tpu_torch.tensor.special import LogSoftmax, Softmax, SoftmaxGrad
from aesara_tpu_torch.tensor.subtensor import (
    AdvancedIncSubtensor, AdvancedIncSubtensor1, AdvancedSubtensor, AdvancedSubtensor1, DynamicIncSubtensor,
    DynamicSlice, IncSubtensor, Subtensor, indices_from_subtensor,
)
from aesara_tpu_torch.link.torch.kernels.attention import flash_attention, flash_attention_grads
from aesara_tpu_torch.link.torch.kernels.elemwise import (
    ElemwiseKernel, apply_scalar_node, fused_elemwise, refuse_negative_int_pow, torch_dtype,
)
from aesara_tpu_torch.link.torch.kernels.softmax import softmax_rows


__all__ = ["torch_funcify", "in_place_lowering", "IN_PLACE_OPS"]

LOW_PRECISION = ("bfloat16", "float16")


@singledispatch
def torch_funcify(op, node=None):
    raise NotImplementedError(f"no torch lowering for op {op} ({type(op).__name__})")


@torch_funcify.register(Elemwise)
def _torch_elemwise(op, node):
    static_shapes = [tuple(i.type.shape) for i in node.inputs]
    out_dtype = node.outputs[0].type.dtype
    refuse_negative_int_pow(op.scalar_op, node.inputs)
    if isinstance(op.scalar_op, Composite):
        # the kernel is generated now, so an op without a Triton form
        # fails when the function is compiled
        kernel = ElemwiseKernel(op.scalar_op, [i.type.dtype for i in node.inputs], out_dtype)

        def composite(*args):
            check_static_broadcast(static_shapes, [a.shape for a in args])
            return fused_elemwise(kernel, *args)

        return composite

    def elemwise(*args):
        check_static_broadcast(static_shapes, [a.shape for a in args])
        return apply_scalar_node(op.scalar_op, out_dtype, args)

    return elemwise


@torch_funcify.register(DimShuffle)
def _torch_dimshuffle(op, node):
    perm = tuple(op.transposition)

    def dimshuffle(x):
        return x.permute(perm).reshape(op.out_shape(x.shape))

    return dimshuffle


@torch_funcify.register(CAReduce)
def _torch_careduce(op, node):
    import torch

    name = str(op.scalar_op)
    axes = op._normalized_axes(node.inputs[0].type.ndim)
    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    # bfloat16 and float16 sums and products accumulate in float32, as
    # jnp.sum and jnp.prod compute them
    acc = op.acc_dtype or node.outputs[0].type.dtype
    acc_dtype = torch_dtype("float32" if acc in LOW_PRECISION else acc)
    if name == "add":

        def reduce_sum(x):
            x = x.to(acc_dtype)
            return (torch.sum(x, dim=axes) if axes else x).to(out_dtype)

        return reduce_sum
    if name == "mul":

        def reduce_prod(x):
            x = x.to(acc_dtype)
            for d in reversed(axes):    # one axis a call: torch.prod takes one dim
                x = torch.prod(x, dim=d)
            return x.to(out_dtype)

        return reduce_prod
    # as the JAX package lowers them (link/jax/dispatch.py:630-665); amax
    # and amin propagate NaN, as numpy.max does
    reducers = {"maximum": torch.amax, "minimum": torch.amin}
    if name in reducers:
        base = reducers[name]
        return lambda x: (base(x, dim=axes) if axes else x).to(out_dtype)
    if name in ("and_", "or_") and node.inputs[0].type.dtype == "bool":
        base = torch.all if name == "and_" else torch.any

        def reduce_logical(x):
            for d in reversed(axes):    # one axis a call: torch.all takes one dim
                x = base(x, dim=d)
            return x

        return reduce_logical
    raise NotImplementedError(f"no torch lowering for CAReduce({name}) of {node.inputs[0].type.dtype}")


@torch_funcify.register(GradManipulatorOp)
def _torch_grad_manipulator(op, node):
    # identity forward, as the JAX package lowers zero_grad, grad_clip and
    # the others (dispatch.py:1154-1178); only their gradients differ
    return lambda x: x


@torch_funcify.register(MakeVector)
def _torch_make_vector(op, node):
    import torch

    dtype = torch_dtype(op.dtype)
    return lambda *args: torch.stack([a.to(dtype) for a in args])


@torch_funcify.register(Shape_i)
def _torch_shape_i(op, node):
    # a host value, so shape arithmetic downstream folds on the host
    i = op.i

    def shape_i(x):
        return np.asarray(x.shape[i], dtype=np.int64)

    shape_i.host_outputs = True
    return shape_i


@torch_funcify.register(Shape)
def _torch_shape(op, node):
    def shape(x):
        return np.asarray(x.shape, dtype=np.int64)

    shape.host_outputs = True
    return shape


@torch_funcify.register(Reshape)
def _torch_reshape(op, node):
    def reshape(x, shp):
        return x.reshape(tuple(int(s) for s in np.asarray(shp)))

    reshape.host_inputs = (1,)
    return reshape


def sums_in_fp32(fn, dtype: str):
    """``fn`` (a product or a fused BLAS call) for operands of ``dtype``:
    a bfloat16 or float16 product sums in fp32 and rounds once, as
    ``_dot_precision`` leaves it to the MXU (``aesara_tpu/link/jax/
    dispatch.py:1084-1096``).  On the card cuBLAS does so while PyTorch's
    reduced-precision reductions are off (``TorchLinker`` refuses to
    compile such a product while they are on); on the CPU the product is
    taken in float32 and rounded."""
    if dtype not in LOW_PRECISION:
        return fn
    import torch

    def product(*args, **kwargs):
        if args[0].device.type == "cuda":
            return fn(*args, **kwargs)
        return fn(*(a.float() for a in args), **kwargs).to(args[0].dtype)

    return product


@torch_funcify.register(Dot)
def _torch_dot(op, node):
    import torch

    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    matmul = sums_in_fp32(torch.matmul, node.outputs[0].type.dtype)

    def dot(x, y):
        # a plain product, left to the library as the JAX package left it to XLA
        return matmul(x.to(out_dtype), y.to(out_dtype))

    return dot


@torch_funcify.register(BatchedDot)
def _torch_batched_dot(op, node):
    # a plain batched product in full fp32 (link/jax/dispatch.py:1113-1129
    # leaves it to XLA's dot_general): bmm for 3x3, matmul with a unit
    # dim for 3x2 and 2x3, a batched dot product for 2x2
    import torch

    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    case = (node.inputs[0].type.ndim, node.inputs[1].type.ndim)
    bmm, matmul, dots = (sums_in_fp32(f, node.outputs[0].type.dtype) for f in (
        torch.bmm, torch.matmul, lambda a, b: torch.einsum("bi,bi->b", a, b)))

    def batched_dot(x, y):
        x, y = x.to(out_dtype), y.to(out_dtype)
        if case == (3, 3):
            return bmm(x, y)
        if case == (3, 2):
            return matmul(x, y.unsqueeze(-1)).squeeze(-1)
        if case == (2, 3):
            return matmul(x.unsqueeze(1), y).squeeze(1)
        return dots(x, y)

    return batched_dot


def _coefficient(value, dtype):
    """A BLAS coefficient (kept on the host by ``host_inputs``): the Python
    number of a host value, as ``torch.addmm`` takes it, or the device
    tensor, multiplied in as a tensor (reading it on the host would make
    the host wait for the device)."""
    return value.item() if isinstance(value, np.ndarray) else value.to(dtype)


def _accumulate_lowering(node, fused, product):
    """beta·z + alpha·product(operands) for Gemm, Gemv and Ger (Ger: beta
    1), by ``fused(z, *operands, beta=, alpha=)`` (``torch.addmm``,
    ``addmv``, ``addr``) where both coefficients are host values (the
    constants and what the linker folds from them); a coefficient that
    lives on the device is a tensor multiply instead."""
    import torch

    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    with_beta = len(node.inputs) == 5
    fused, product = (sums_in_fp32(f, node.outputs[0].type.dtype) for f in (fused, product))

    def accumulate(z, alpha, *rest):
        operands = [o.to(out_dtype) for o in (rest[:-1] if with_beta else rest)]
        z = z.to(out_dtype)
        alpha = _coefficient(alpha, out_dtype)
        beta = _coefficient(rest[-1], out_dtype) if with_beta else 1
        if not isinstance(alpha, torch.Tensor) and not isinstance(beta, torch.Tensor):
            return fused(z, *operands, beta=beta, alpha=alpha)
        return torch.add(z * beta, product(*operands) * alpha)

    accumulate.host_inputs = (1, 4) if with_beta else (1,)
    return accumulate


@torch_funcify.register(Gemm)
def _torch_gemm(op, node):
    # the inplace flag changes nothing here: the port has no destroy
    # handler, so no rewrite sets it, and the value is the same
    import torch

    return _accumulate_lowering(node, torch.addmm, torch.mm)


@torch_funcify.register(Gemv)
def _torch_gemv(op, node):
    import torch

    return _accumulate_lowering(node, torch.addmv, torch.mv)


@torch_funcify.register(Ger)
def _torch_ger(op, node):
    import torch

    return _accumulate_lowering(node, torch.addr, torch.outer)


@torch_funcify.register(Dot22)
def _torch_dot22(op, node):
    import torch

    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    mm = sums_in_fp32(torch.mm, node.outputs[0].type.dtype)
    return lambda x, y: mm(x.to(out_dtype), y.to(out_dtype))


@torch_funcify.register(Dot22Scalar)
def _torch_dot22scalar(op, node):
    import torch

    out_dtype = torch_dtype(node.outputs[0].type.dtype)
    mm = sums_in_fp32(torch.mm, node.outputs[0].type.dtype)

    def dot22scalar(x, y, a):
        return mm(x.to(out_dtype), y.to(out_dtype)) * _coefficient(a, out_dtype)

    dot22scalar.host_inputs = (2,)
    return dot22scalar


@torch_funcify.register(FusedAttention)
def _torch_fused_attention(op, node):
    causal = op.causal

    def attention(q, k, v):
        return flash_attention(q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]))

    return attention


@torch_funcify.register(FusedAttentionGrad)
def _torch_fused_attention_grad(op, node):
    causal = op.causal

    def attention_grads(q, k, v, gz):
        return flash_attention_grads(q, k, v, gz, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]))

    return attention_grads


def _softmax_lowering(op, node, log: bool):
    ndim = node.inputs[0].type.ndim
    axis = None if op.axis is None or ndim == 0 else op.axis % ndim

    def softmax(x):
        if axis is None:    # one row of every value
            return softmax_rows(x.reshape(1, -1), log).reshape(x.shape)
        if axis == ndim - 1:
            return softmax_rows(x, log)
        return softmax_rows(x.movedim(axis, -1), log).movedim(-1, axis)

    return softmax


@torch_funcify.register(Softmax)
def _torch_softmax(op, node):
    return _softmax_lowering(op, node, log=False)


@torch_funcify.register(LogSoftmax)
def _torch_log_softmax(op, node):
    return _softmax_lowering(op, node, log=True)


@torch_funcify.register(SoftmaxGrad)
def _torch_softmax_grad(op, node):
    # plain torch ops, as the JAX package lowers it (linalg_dispatch.py:389-397)
    ndim = node.inputs[1].type.ndim
    axis = None if op.axis is None or ndim == 0 else op.axis % ndim

    def softmax_grad(dy, sm):
        prod = dy * sm
        inner = prod.sum() if axis is None else prod.sum(dim=axis, keepdim=True)
        return sm * (dy - inner)

    return softmax_grad


@torch_funcify.register(AdvancedSubtensor)
def _torch_advanced_subtensor(op, node):
    return lambda x, *indices: x[indices]


@torch_funcify.register(AdvancedIncSubtensor)
def _torch_advanced_inc_subtensor(op, node):
    accumulate = not op.set_instead_of_inc

    def advanced_inc_subtensor(x, y, *indices):
        return x.clone().index_put_(indices, y, accumulate=accumulate)

    return advanced_inc_subtensor


class _In(int):
    """The position of an index input, among a node's index inputs."""


def _basic_index(node, idx_list, n_fixed: int):
    """(``resolve``, the positions of the run-time integer indices in the
    static index, their positions among the index inputs, the positions
    of the slice bounds that must be host values among the node's inputs)
    of a Subtensor-like node whose index inputs start at ``n_fixed``;
    ``resolve(index_inputs)`` gives the static index tuple and the slices
    with a negative step by their position in its result.

    A slice bound that is not a constant reaches the lowering as a host
    value: one computed from shapes and constants, which the linker folds
    on the host and which each key of a function fixes (``needs_host``).
    One computed from data raises when the function is compiled: its
    result's length would be read on the host (the JAX package sends such
    a node to its Python fallback; the port has none).  A negative-step
    slice (torch slices step forward only) and a run-time integer index
    are kept as full slices in the static index and applied by
    ``_region``, the index gathered on the device."""
    index_inputs = list(node.inputs[n_fixed:])
    entries = indices_from_subtensor([_In(k) for k in range(len(index_inputs))], idx_list)
    template, dynamic, bounds, kept = [], [], [], 0     # kept: dims of the result so far
    for e in entries:
        if isinstance(e, slice):
            parts = []
            for p in (e.start, e.stop, e.step):
                if isinstance(p, _In):
                    if isinstance(index_inputs[p], Constant):
                        p = int(index_inputs[p].data)
                    else:
                        bounds.append(p)
                parts.append(p)
            template.append(tuple(parts))
            kept += 1
        elif isinstance(e, _In) and not isinstance(index_inputs[e], Constant):
            template.append(None)
            dynamic.append(kept)
            kept += 1
        else:
            template.append(int(index_inputs[e].data) if isinstance(e, _In) else int(e))
    runtime = [k for k, v in enumerate(index_inputs) if not isinstance(v, Constant) and k not in bounds]

    def resolve(values):
        static, negative, kept = [], {}, 0
        for e in template:
            if isinstance(e, tuple):
                sl = slice(*[int(values[p]) if isinstance(p, _In) else p for p in e])
                if sl.step is not None and sl.step < 0:
                    negative[kept] = sl     # by its dim in the result: an integer index drops one
                    sl = slice(None)
                static.append(sl)
            else:
                static.append(slice(None) if e is None else e)
            kept += e is None or isinstance(e, tuple)
        return tuple(static), negative

    if not bounds:
        fixed = resolve(())
        resolve = lambda values: fixed  # noqa: E731
    return resolve, dynamic, runtime, [n_fixed + k for k in bounds]


_RUN_TIME_BOUND = ("has a slice bound computed at run time from data, so its length is not known "
                   "when the function is compiled; index a window of constant length "
                   "(x[i*B:(i+1)*B] becomes a DynamicSlice) or compute the bound from shapes")


def _region(x, static, negative):
    """(a view of x at the static index and the negative-step slices, read
    forward, and the dims to flip to read them as they step)."""
    view = x[static]
    for pos, sl in negative.items():
        start, stop, step = sl.indices(view.shape[pos])
        count = len(range(start, stop, step))
        last = start + (count - 1) * step if count else 0
        view = view.narrow(pos, last, start - last + 1 if count else 0)[(slice(None),) * pos
                                                                        + (slice(None, None, -step),)]
    return view, list(negative)


def _wrapped(i, dim):
    """An index tensor with a negative entry wrapped once, as NumPy reads it."""
    import torch

    return torch.where(i < 0, i + dim, i)


def _run_time_indices(view, dynamic, values):
    """``view`` with its ``dynamic`` dims moved to the front, and the
    index of each as a (1,) tensor on the device (host values too)."""
    import torch

    moved = view.movedim(dynamic, list(range(len(dynamic))))
    idx = []
    for k, v in enumerate(values):
        dim = moved.shape[k]
        if isinstance(v, np.ndarray):
            v = int(v)
            idx.append(torch.full((1,), v + dim if v < 0 else v, dtype=torch.int64, device=view.device))
        else:
            idx.append(_wrapped(v.reshape(1), dim))
    return moved, idx


@torch_funcify.register(Subtensor)
def _torch_subtensor(op, node):
    resolve, dynamic, runtime, bounds = _basic_index(node, op.idx_list, 1)
    n_dyn = len(dynamic)

    def subtensor(x, *index_inputs):
        view, flips = _region(x, *resolve(index_inputs))
        if flips:
            view = view.flip(flips)
        if not n_dyn:
            return view
        moved, idx = _run_time_indices(view, dynamic, [index_inputs[k] for k in runtime])
        return moved[tuple(idx)].reshape(moved.shape[n_dyn:])

    subtensor.host_inputs = tuple(range(1, len(node.inputs)))
    subtensor.needs_host = (bounds, _RUN_TIME_BOUND)
    return subtensor


@torch_funcify.register(IncSubtensor)
def _torch_inc_subtensor(op, node):
    return _inc_subtensor_lowering(op, node, in_place=False)


def _inc_subtensor_lowering(op, node, in_place: bool):
    # out of place (a clone of x) but where a Scan's loop owns x
    # (``in_place_lowering``): the port has no destroy handler
    resolve, dynamic, runtime, bounds = _basic_index(node, op.idx_list, 2)
    n_dyn, set_instead = len(dynamic), op.set_instead_of_inc

    def inc_subtensor(x, y, *index_inputs):
        out = x if in_place else x.clone()
        view, flips = _region(out, *resolve(index_inputs))
        # y broadcast over the region, a run-time index's dim of size 1
        shape = [1 if d in dynamic else n for d, n in enumerate(view.shape)]
        values = y.broadcast_to([n for d, n in enumerate(shape) if d not in dynamic]).reshape(shape)
        if flips:
            values = values.flip(flips)
        if not n_dyn:
            if set_instead:
                view.copy_(values)
            else:
                view.add_(values)
            return out
        moved, idx = _run_time_indices(view, dynamic, [index_inputs[k] for k in runtime])
        values = values.movedim(dynamic, list(range(n_dyn))).reshape((1,) + tuple(moved.shape[n_dyn:]))
        moved.index_put_(tuple(idx), values, accumulate=not set_instead)
        return out

    inc_subtensor.host_inputs = tuple(range(2, len(node.inputs)))
    inc_subtensor.needs_host = (bounds, _RUN_TIME_BOUND)
    return inc_subtensor


@torch_funcify.register(AdvancedSubtensor1)
def _torch_advanced_subtensor1(op, node):
    return lambda x, ilist: x[ilist]


@torch_funcify.register(AdvancedIncSubtensor1)
def _torch_advanced_inc_subtensor1(op, node):
    accumulate = not op.set_instead_of_inc

    def advanced_inc_subtensor1(x, y, ilist):
        values = y.broadcast_to((ilist.shape[0],) + tuple(x.shape[1:]))
        return x.clone().index_put_((ilist,), values, accumulate=accumulate)

    return advanced_inc_subtensor1


def _window_index(lengths, shape, starts, aranges: dict):
    """The index of a dynamic window of a tensor of ``shape``: a slice for
    each whole axis, and for each sized one the int64 positions
    ``clamp(start, 0, dim - length) + arange(length)`` (a negative start
    wrapped once first), computed on the device from a start on the
    device: no value is read on the host, so a captured graph reads each
    replay's start.  ``aranges`` keeps one ``arange`` for each length and
    device, made at the first (eager) call."""
    import torch

    it = iter(starts)
    idx = []
    for d, n in enumerate(lengths):
        if n is None:
            idx.append(slice(None))
            continue
        dim = shape[d]
        if n > dim:
            raise ValueError(f"a window of {n} does not fit in axis {d} of length {dim}")
        start = next(it)
        if isinstance(start, np.ndarray):
            s = int(start)
            s = min(max(s + dim if s < 0 else s, 0), dim - n)
            idx.append(slice(s, s + n))
            continue
        key = (n, start.device)
        if key not in aranges:
            aranges[key] = torch.arange(n, dtype=torch.int64, device=start.device)
        idx.append(_wrapped(start, dim).clamp(0, dim - n) + aranges[key])
    return idx


def _gather_window(x, idx):
    """x at the window ``idx`` of ``_window_index``, one axis at a time."""
    out = x
    for d, e in enumerate(idx):
        out = out[(slice(None),) * d + (e,)] if isinstance(e, slice) else out.index_select(d, e)
    return out


@torch_funcify.register(DynamicSlice)
def _torch_dynamic_slice(op, node):
    lengths, aranges = op.lengths, {}

    def dynamic_slice(x, *starts):
        return _gather_window(x, _window_index(lengths, x.shape, starts, aranges))

    dynamic_slice.host_inputs = tuple(range(1, len(node.inputs)))
    return dynamic_slice


@torch_funcify.register(DynamicIncSubtensor)
def _torch_dynamic_inc_subtensor(op, node):
    return _dynamic_inc_subtensor_lowering(op, node, in_place=False)


def _dynamic_inc_subtensor_lowering(op, node, in_place: bool):
    import torch

    lengths, set_instead, aranges = op.lengths, op.set_instead_of_inc, {}

    def dynamic_inc_subtensor(x, y, *starts):
        out = x if in_place else x.clone()
        idx = _window_index(lengths, x.shape, starts, aranges)
        # every axis up to the last sized one as an open grid of positions
        grid = [e if not isinstance(e, slice) else
                torch.arange(x.shape[d], device=x.device)[e] for d, e in enumerate(idx)]
        grid = [g.reshape([-1 if k == d else 1 for k in range(len(grid))]) for d, g in enumerate(grid)]
        window = tuple(g.shape[d] for d, g in enumerate(grid)) + tuple(x.shape[len(grid):])
        values = y.broadcast_to(window)
        if not set_instead:
            values = out[tuple(grid)] + values
        # (window + y) in their common dtype, then x's, as the JAX lowering
        # casts (link/jax/dispatch.py:1004-1007)
        out.index_put_(tuple(grid), values.to(x.dtype))
        return out

    dynamic_inc_subtensor.host_inputs = tuple(range(2, len(node.inputs)))
    return dynamic_inc_subtensor


#: the ops that have a lowering writing into their first input
IN_PLACE_OPS = (IncSubtensor, DynamicIncSubtensor)


def in_place_lowering(node):
    """The lowering of ``node`` (an ``IN_PLACE_OPS`` node) that writes into
    its input ``x`` and returns it, where the caller owns ``x`` and nothing
    else reads it: a Scan's loop-carried state (``scan_dispatch.py``), the
    counterpart of XLA's in-place update of a donated carry."""
    if isinstance(node.op, IncSubtensor):
        return _inc_subtensor_lowering(node.op, node, in_place=True)
    return _dynamic_inc_subtensor_lowering(node.op, node, in_place=True)


@torch_funcify.register(Alloc)
def _torch_alloc(op, node):
    import torch

    def alloc(value, *shape):
        target = tuple(int(s) for s in shape)
        check_static_broadcast([node.inputs[0].type.shape, target], [tuple(value.shape), target])
        return torch.broadcast_to(value, target).clone(memory_format=torch.contiguous_format)

    alloc.host_inputs = tuple(range(1, len(node.inputs)))
    return alloc


@torch_funcify.register(ARange)
def _torch_arange(op, node):
    import torch

    dtype = torch_dtype(op.dtype)

    def arange(start, stop, step):
        # the linker folds an arange of host values through perform; this
        # runs only for bounds computed on the device, which the host reads
        return torch.arange(start.item(), stop.item(), step.item(), dtype=dtype, device=start.device)

    arange.capturable = False
    return arange


@torch_funcify.register(Argmax)
def _torch_argmax(op, node):
    import torch

    ndim = node.inputs[0].type.ndim
    axes = op.axes(ndim)
    keep = [d for d in range(ndim) if d not in axes]

    def argmax(x):
        if len(axes) == 1:
            return torch.argmax(x, dim=axes[0])
        flat = x.permute(keep + list(axes)).reshape([x.shape[d] for d in keep] + [-1])
        return torch.argmax(flat, dim=-1)

    return argmax


@torch_funcify.register(Repeat)
def _torch_repeat(op, node):
    import torch

    axis, gathers = op.axis, {}

    def repeat(x, repeats):
        # the counts are host values (needs_host), so the result's length
        # is fixed for a key of the function; a vector of counts gathers
        # by an index made at the first (eager) call of each
        counts = np.asarray(repeats)
        if not counts.ndim:
            return torch.repeat_interleave(x, int(counts), dim=axis)
        dim = 0 if axis is None else axis
        key = (tuple(counts.tolist()), x.device)
        if key not in gathers:
            gathers[key] = torch.as_tensor(np.repeat(np.arange(x.shape[dim]), counts), device=x.device)
        return (x.reshape(-1) if axis is None else x).index_select(dim, gathers[key])

    repeat.host_inputs = (1,)
    repeat.needs_host = ((1,), "has a repeat count computed at run time from data, so its result's "
                               "length is not known when the function is compiled")
    return repeat


@torch_funcify.register(AllocEmpty)
def _torch_alloc_empty(op, node):
    import torch

    dtype = torch_dtype(op.dtype)

    def alloc_empty(*shape, device):
        # zeros, as the JAX package's lowering gives (XLA has no unset values)
        return torch.zeros(tuple(int(s) for s in shape), dtype=dtype, device=device)

    alloc_empty.host_inputs = tuple(range(len(node.inputs)))
    alloc_empty.needs_host = (tuple(range(len(node.inputs))), "has a shape computed on the device")
    alloc_empty.takes_device = True
    return alloc_empty


@torch_funcify.register(TensorFromScalar)
def _torch_tensor_from_scalar(op, node):
    return lambda s: s.reshape(())


@torch_funcify.register(ScalarFromTensor)
def _torch_scalar_from_tensor(op, node):
    return lambda t: t.reshape(())


@torch_funcify.register(Join)
def _torch_join(op, node):
    import torch

    def join(axis, *tensors):
        return torch.cat(tensors, dim=int(axis))

    join.host_inputs = (0,)
    join.needs_host = ((0,), "has an axis computed on the device")
    return join


@torch_funcify.register(Split)
def _torch_split(op, node):
    import torch

    n = op.len_splits

    def split(x, axis, splits):
        sizes = [int(v) for v in np.asarray(splits)]
        axis = int(axis)
        if len(sizes) != n:
            raise ValueError("wrong number of splits")
        if sum(sizes) != x.shape[axis]:
            raise ValueError(f"split sizes {sizes} do not sum to axis length {x.shape[axis]}")
        return tuple(torch.split(x, sizes, dim=axis))

    split.host_inputs = (1, 2)
    split.needs_host = ((1, 2), "has an axis or split sizes computed on the device")
    return split


@torch_funcify.register(SpecifyShape)
def _torch_specify_shape(op, node):
    def specify_shape(x, *shape):
        check_specified_shape(tuple(x.shape), shape)
        return x

    specify_shape.host_inputs = tuple(range(1, len(node.inputs)))
    specify_shape.needs_host = (tuple(range(1, len(node.inputs))), "has a shape computed on the device")
    return specify_shape


@torch_funcify.register(Unbroadcast)
def _torch_unbroadcast(op, node):
    return lambda x: x


@torch_funcify.register(CumOp)
def _torch_cum(op, node):
    import torch

    fn = torch.cumsum if op.mode == "add" else torch.cumprod
    axis = op.axis

    def cum(x):
        # an integer input accumulates in int64 and wraps to its own dtype,
        # as jnp.cumsum/cumprod do where the output keeps the input's dtype
        out = fn(x.reshape(-1), 0) if axis is None else fn(x, axis)
        return out.to(x.dtype)

    return cum


@torch_funcify.register(BroadcastTo)
def _torch_broadcast_to(op, node):
    import torch

    def broadcast_to(x, *shape):
        # a view with zero strides on the broadcast dims (the op's view_map);
        # no lowering writes into an input in place but a Scan's own copy
        return torch.broadcast_to(x, tuple(int(s) for s in shape))

    broadcast_to.host_inputs = tuple(range(1, len(node.inputs)))
    broadcast_to.needs_host = (tuple(range(1, len(node.inputs))), "has a shape computed on the device")
    return broadcast_to


#: a same-width signed view of each unsigned dtype torch cannot sort or gather
_SIGNED_VIEW = {"uint16": "int16", "uint32": "int32", "uint64": "int64"}


def _sort_key(x):
    """A tensor that sorts as ``x`` sorts: an unsigned type as int64 (uint64
    with its top bit flipped), a bool as uint8."""
    import torch

    name = str(x.dtype).split(".")[-1]
    if name == "bool":
        return x.to(torch.uint8)
    if name in ("uint16", "uint32"):
        bits = {"uint16": 16, "uint32": 32}[name]
        return x.view(torch_dtype(_SIGNED_VIEW[name])).to(torch.int64) & ((1 << bits) - 1)
    if name == "uint64":
        return x.view(torch.int64) ^ torch.iinfo(torch.int64).min
    return x


def _gather(x, dim, idx):
    name = str(x.dtype).split(".")[-1]
    if name in _SIGNED_VIEW:
        return x.view(torch_dtype(_SIGNED_VIEW[name])).gather(dim, idx).view(x.dtype)
    return x.gather(dim, idx)


@torch_funcify.register(SortOp)
def _torch_sort(op, node):
    import torch

    def sort(x, axis):
        idx = torch.sort(_sort_key(x), dim=int(axis), stable=True).indices
        return _gather(x, int(axis), idx)

    sort.host_inputs = (1,)
    sort.needs_host = ((1,), "has an axis computed on the device")
    return sort


@torch_funcify.register(ArgSortOp)
def _torch_argsort(op, node):
    import torch

    def argsort(x, axis):
        return torch.sort(_sort_key(x), dim=int(axis), stable=True).indices

    argsort.host_inputs = (1,)
    argsort.needs_host = ((1,), "has an axis computed on the device")
    return argsort


@torch_funcify.register(TopKOp)
def _torch_topk(op, node):
    """As ``lax.top_k`` (``aesara_tpu/link/jax/linalg_dispatch.py:329-367``):
    the k largest along the axis (k < 0: the |k| smallest), largest first
    (smallest first), equal values lowest index first.  A stable sort, then
    a slice, gives that order on both devices (``torch.topk`` gives no
    order to ties on the card)."""
    import torch

    idx_dtype = torch_dtype(op.idx_dtype)

    def topk(x, k):
        k = int(k)
        if k == 0:
            raise ValueError("topk: k must be nonzero")
        ax = op.axis % x.dim()
        order = torch.sort(_sort_key(x), dim=ax, descending=k > 0, stable=True).indices
        idx = order.narrow(ax, 0, min(abs(k), x.shape[ax]))
        outs = []
        if op.return_values:
            outs.append(_gather(x, ax, idx))
        if op.return_indices:
            outs.append(idx.to(idx_dtype))
        return tuple(outs) if len(outs) > 1 else outs[0]

    topk.host_inputs = (1,)
    topk.needs_host = ((1,), "has a k computed on the device: top-k's result has k's length")
    return topk
