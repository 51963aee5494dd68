"""2-d pooling over the trailing two axes (the counterpart of
``aesara_tpu/tensor/nnet/pool.py``): ``Pool``, ``PoolGrad``, ``pool_2d``
with its legacy keyword aliases, and ``max_pool_2d``.

The JAX package pools by ``lax.reduce_window`` and takes the gradient by
its vjp; the ops here carry torch forms of the same functions, which the
lowering (``link/torch/nnet_dispatch.py``) runs and ``perform`` runs on
the CPU.  The input is padded explicitly (``F.pad``: ``-inf``, or the
integer minimum, for max; 0 otherwise), with the extra right-hand
padding the JAX package gives a last partial window where
``ignore_border`` is off, and the windows are reduced over ``unfold``
views, so every dtype pools and no window is dropped (torch's
``ceil_mode`` drops one that starts in the padding, and refuses an input
shorter than the window).  ``average_exc_pad`` divides by the count of
the window's positions that are not padding.

The max gradient goes where XLA's select-and-scatter puts it (the vjp of
``reduce_window`` max): walking a window's positions in row order from
its first, the padding among them as ``-inf``, the selected one is kept
while it is ``>=`` the next and replaced otherwise.  So among tied values
the first wins, a comparison with NaN replaces the selected one, and a
window whose selected position is padding passes no gradient on.
"""

from __future__ import annotations

import math

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import perform_by_torch
from aesara_tpu_torch.tensor.basic import as_tensor_variable
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["Pool", "pool_2d", "max_pool_2d", "PoolGrad"]


def _out_len(i, w, s, pad, ignore_border):
    if i is None:
        return None
    i = i + 2 * pad
    if ignore_border:
        return max(0, (i - w) // s + 1)
    return max(0, int(math.ceil(max(i - w, 0) / s)) + 1) if i >= w else (1 if i > 0 else 0)


class Pool(Op):
    """2-d pooling over the trailing two axes (NCHW)."""

    __props__ = ("ws", "stride", "pad", "mode", "ignore_border")

    def __init__(self, ws, ignore_border=True, stride=None, pad=(0, 0), mode="max"):
        self.ws = tuple(ws)
        self.stride = tuple(stride) if stride is not None else tuple(ws)
        self.pad = tuple(pad)
        if mode not in ("max", "sum", "average_inc_pad", "average_exc_pad"):
            raise ValueError(f"bad pool mode {mode}")
        self.mode = mode
        self.ignore_border = bool(ignore_border)
        if not ignore_border and self.pad != (0, 0):
            raise NotImplementedError("padding requires ignore_border=True")

    def make_node(self, x):
        x = as_tensor_variable(x)
        if x.type.ndim < 2:
            raise TypeError("pool needs ndim >= 2")
        shape = list(x.type.shape)
        for d in (-2, -1):
            shape[d] = _out_len(shape[d], self.ws[d], self.stride[d], self.pad[d], self.ignore_border)
        return Apply(self, [x], [TensorType(x.type.dtype, tuple(shape))()])

    # -- the torch forms (the lowering's and perform's) ----------------------

    def pads(self, hw) -> tuple:
        """((top, bottom), (left, right)) of an input whose trailing two
        dims are ``hw``."""
        if self.ignore_border:
            return tuple((p, p) for p in self.pad)
        return tuple((0, max(0, (_out_len(n, w, s, 0, False) - 1) * s + w - n))
                     for n, w, s in zip(hw, self.ws, self.stride))

    def _padded(self, x, value):
        import torch.nn.functional as F

        (t, b), (lft, r) = self.pads(tuple(x.shape[-2:]))
        return F.pad(x, (lft, r, t, b), value=value) if t or b or lft or r else x

    def _windows(self, x):
        """The (..., out_h, out_w, ws_h, ws_w) view of the windows of x."""
        nd = x.dim()
        return x.unfold(nd - 2, self.ws[0], self.stride[0]).unfold(nd - 1, self.ws[1], self.stride[1])

    def _counts(self, x, dtype):
        """Per output position, how many of its window's positions lie in
        the input (``average_exc_pad``'s divisor)."""
        import torch

        ones = self._padded(torch.ones(tuple(x.shape[-2:]), dtype=dtype, device=x.device), 0)
        return self._windows(ones).sum(dim=(-2, -1))

    def _average_dtype(self, x):
        # an integer average divides in float64 and truncates, as the JAX
        # package's (64-bit mode) does
        import torch

        return x.dtype if x.dtype.is_floating_point else torch.float64

    def _out_hw(self, x) -> tuple:
        return tuple(_out_len(n, w, s, p, self.ignore_border)
                     for n, w, s, p in zip(x.shape[-2:], self.ws, self.stride, self.pad))

    def torch_forward(self, x):
        import torch

        if 0 in self._out_hw(x):     # an input shorter than the window, its border ignored
            return x.new_zeros(tuple(x.shape[:-2]) + self._out_hw(x))
        if self.mode == "max":
            low = -math.inf if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
            return self._windows(self._padded(x, low)).amax(dim=(-2, -1))
        summed = self._windows(self._padded(x, 0)).sum(dim=(-2, -1), dtype=x.dtype)
        if self.mode == "sum":
            return summed
        dtype = self._average_dtype(x)
        denom = float(np.prod(self.ws)) if self.mode == "average_inc_pad" else self._counts(x, dtype)
        return (summed.to(dtype) / denom).to(x.dtype)

    def _scatter(self, shape, per_offset, dtype, device):
        """The gradient of the input: for each window offset, the cotangent
        that ``per_offset(k)`` gives for the position at offset k of every
        window, summed where windows overlap, the padding cropped."""
        import torch

        (t, b), (lft, r) = self.pads(tuple(shape[-2:]))
        out = torch.zeros(tuple(shape[:-2]) + (shape[-2] + t + b, shape[-1] + lft + r), dtype=dtype, device=device)
        for k, window in enumerate(self._offsets(out)):
            window.add_(per_offset(k))
        return out[..., t:t + shape[-2], lft:lft + shape[-1]]

    def _offsets(self, padded):
        """Views of ``padded`` at each offset of a window, in row order,
        each shaped like the output."""
        views = self._windows(padded)
        return [views[..., a, b] for a in range(self.ws[0]) for b in range(self.ws[1])]

    def torch_grad(self, x, gz):
        import torch

        gz = gz.to(x.dtype)
        if 0 in self._out_hw(x):
            return torch.zeros_like(x)
        if self.mode != "max":
            if self.mode == "average_inc_pad":
                gz = gz / float(np.prod(self.ws))
            elif self.mode == "average_exc_pad":
                gz = gz / self._counts(x, x.dtype)
            return self._scatter(x.shape, lambda k: gz, x.dtype, x.device)
        # the position each window selects (module docstring)
        chosen = selected = None
        for k, value in enumerate(self._offsets(self._padded(x, -math.inf))):
            if selected is None:
                selected, chosen = value, torch.zeros(value.shape, dtype=torch.int64, device=x.device)
                continue
            take = ~(selected >= value)
            selected, chosen = torch.where(take, value, selected), torch.where(take, k, chosen)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return self._scatter(x.shape, lambda k: torch.where(chosen == k, gz, zero), x.dtype, x.device)

    def perform(self, node, inputs, output_storage):
        perform_by_torch(self.torch_forward, node, inputs, output_storage)

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.shape import shape as tshape

        out = node.outputs[0]
        return [tuple(tshape(out)[d] for d in range(out.type.ndim))]

    def L_op(self, inputs, outputs, output_grads):
        (x,) = inputs
        (gz,) = output_grads
        return [PoolGrad(self)(x, gz)]

    def __str__(self):
        return f"Pool{{{self.mode}, ws={self.ws}, stride={self.stride}}}"


class PoolGrad(Op):
    """The gradient of ``Pool`` ``fwd``: inputs (x, output cotangent)."""

    __props__ = ("fwd_props",)

    def __init__(self, fwd: Pool):
        self.fwd = fwd
        self.fwd_props = (fwd.ws, fwd.stride, fwd.pad, fwd.mode, fwd.ignore_border)

    def make_node(self, x, gz):
        x = as_tensor_variable(x)
        gz = as_tensor_variable(gz)
        return Apply(self, [x, gz], [x.type()])

    def torch_grad(self, x, gz):
        return self.fwd.torch_grad(x, gz)

    def perform(self, node, inputs, output_storage):
        perform_by_torch(self.torch_grad, node, inputs, output_storage)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_not_implemented

        return [grad_not_implemented(self, i, v) for i, v in enumerate(inputs)]


def pool_2d(input, ws=None, ignore_border=True, stride=None, pad=(0, 0), mode="max", ds=None, st=None, padding=None):
    """Pool the trailing two axes; ``ds``, ``st`` and ``padding`` are the
    legacy names of ``ws``, ``stride`` and ``pad``."""
    if ds is not None:
        ws = ds
    if st is not None:
        stride = st
    if padding is not None:
        pad = padding
    return Pool(ws, ignore_border, stride, pad, mode)(input)


def max_pool_2d(input, ws, ignore_border=True, stride=None, pad=(0, 0)):
    return pool_2d(input, ws, ignore_border, stride, pad, mode="max")
