"""2-d and 3-d convolution (the counterpart of
``aesara_tpu/tensor/nnet/abstract_conv.py``): ``AbstractConv2d`` with its
gradient ops ``AbstractConv2dGradInputs`` and ``AbstractConv2dGradWeights``,
``AbstractConv3d``, and ``conv2d``, ``conv2d_transpose``, ``conv3d`` and
``get_conv_output_shape``.  Layout is NCHW / OIHW (NCDHW / OIDHW).

As the JAX package's ops carry their ``lax.conv_general_dilated`` forms,
these carry their torch forms, which the lowering
(``link/torch/nnet_dispatch.py``) runs and ``perform`` runs on the CPU:
``torch.nn.functional.conv2d``/``conv3d`` forward, and
``aten.convolution_backward`` with the mask of the one gradient wanted.
Aesara convolves (``filter_flip``, the default) where torch correlates, so
the kernel is flipped first.  ``F.conv2d`` pads symmetrically, so an
asymmetric border (a tuple of pairs) is an explicit ``F.pad`` of the
image, whose gradient is cropped back.  These are library calls: the JAX
package computes convolution by XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import perform_by_torch, upcast
from aesara_tpu_torch.tensor.basic import as_tensor_variable
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["AbstractConv2d", "AbstractConv2dGradInputs", "AbstractConv2dGradWeights", "AbstractConv3d", "conv2d",
           "conv2d_transpose", "conv3d", "get_conv_output_shape"]


def _norm_border(border_mode, kh: Optional[int], kw: Optional[int]):
    """``border_mode`` as explicit ((top, bottom), (left, right)) padding,
    or None where the mode needs a kernel size that is not known."""
    if border_mode == "valid":
        return ((0, 0), (0, 0))
    if border_mode == "full":
        if kh is None or kw is None:
            return None
        return ((kh - 1, kh - 1), (kw - 1, kw - 1))
    if border_mode == "half":
        if kh is None or kw is None:
            return None
        return ((kh // 2, kh // 2), (kw // 2, kw // 2))
    if isinstance(border_mode, int):
        return ((border_mode, border_mode), (border_mode, border_mode))
    if isinstance(border_mode, (tuple, list)):
        ph, pw = border_mode
        ph = (ph, ph) if isinstance(ph, int) else tuple(ph)
        pw = (pw, pw) if isinstance(pw, int) else tuple(pw)
        return (ph, pw)
    raise ValueError(f"bad border_mode {border_mode!r}")


def _norm_border3(border_mode, kshape):
    """The 3-d form of ``_norm_border``."""
    if border_mode == "valid":
        return ((0, 0),) * 3
    if border_mode in ("full", "half"):
        if any(k is None for k in kshape):
            return None
        return tuple((k - 1, k - 1) if border_mode == "full" else (k // 2, k // 2) for k in kshape)
    if isinstance(border_mode, int):
        return ((border_mode, border_mode),) * 3
    if isinstance(border_mode, (tuple, list)):
        return tuple((p, p) if isinstance(p, int) else tuple(p) for p in border_mode)
    raise ValueError(f"bad border_mode {border_mode!r}")


def get_conv_output_shape(image_shape, kernel_shape, border_mode, subsample, filter_dilation=(1, 1)):
    """The static output shape of a 2-d convolution (None where unknown)."""
    b, _, ih, iw = image_shape
    nf, _, kh, kw = kernel_shape
    pad = _norm_border(border_mode, kh, kw)
    out = [b, nf]
    for i, (isz, ksz, s, d) in enumerate(zip((ih, iw), (kh, kw), subsample, filter_dilation)):
        if isz is None or ksz is None or pad is None:
            out.append(None)
            continue
        keff = (ksz - 1) * d + 1
        out.append((isz + pad[i][0] + pad[i][1] - keff) // s + 1)
    return tuple(out)


class AbstractConv2d(Op):
    """NCHW x OIHW 2-d convolution."""

    __props__ = ("border_mode", "subsample", "filter_flip", "filter_dilation", "num_groups")

    def __init__(self, border_mode="valid", subsample=(1, 1), filter_flip=True, filter_dilation=(1, 1), num_groups=1,
                 imshp=None, kshp=None):
        self.border_mode = tuple(border_mode) if isinstance(border_mode, (list, tuple)) else border_mode
        self.subsample = tuple(subsample)
        self.filter_flip = bool(filter_flip)
        self.filter_dilation = tuple(filter_dilation)
        self.num_groups = int(num_groups)

    def make_node(self, img, kern):
        img = as_tensor_variable(img)
        kern = as_tensor_variable(kern)
        if img.type.ndim != 4 or kern.type.ndim != 4:
            raise TypeError("conv2d needs 4-d image (NCHW) and kernel (OIHW)")
        dtype = upcast(img.type.dtype, kern.type.dtype)
        out_shape = get_conv_output_shape(img.type.shape, kern.type.shape, self.border_mode, self.subsample,
                                          self.filter_dilation)
        return Apply(self, [img, kern], [TensorType(dtype, out_shape)()])

    # -- the torch forms (the lowering's and perform's) ----------------------

    def _pads(self, kshape) -> tuple:
        return _norm_border(self.border_mode, *kshape)

    def _prepared(self, img, kern):
        """(image padded where its border is asymmetric, kernel flipped
        where ``filter_flip``, the symmetric padding left to the conv)."""
        import torch
        import torch.nn.functional as F

        nd = kern.dim() - 2
        dtype = torch.promote_types(img.dtype, kern.dtype)
        img, kern = img.to(dtype), kern.to(dtype)
        pads = self._pads(tuple(kern.shape[2:]))
        if self.filter_flip:
            kern = kern.flip(tuple(range(2, 2 + nd)))
        if all(lo == hi for lo, hi in pads):
            return img, kern, tuple(lo for lo, _ in pads)
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]    # F.pad: the last dim first
        return F.pad(img, flat), kern, (0,) * nd

    def torch_forward(self, img, kern):
        import torch.nn.functional as F

        img, kern, padding = self._prepared(img, kern)
        conv = F.conv2d if kern.dim() == 4 else F.conv3d
        return conv(img, kern, stride=self.subsample, padding=padding, dilation=self.filter_dilation,
                    groups=self.num_groups)

    def torch_grads(self, img, kern, gz, wants: tuple):
        """(gradient of the image or None, of the kernel or None) of the
        forward's output cotangent ``gz``; ``wants`` says which."""
        import torch

        nd = kern.dim() - 2
        shape = img.shape
        img, kern_f, padding = self._prepared(img, kern)
        g_img, g_kern, _ = torch.ops.aten.convolution_backward(
            gz.to(img.dtype), img, kern_f, None, list(self.subsample), list(padding), list(self.filter_dilation),
            False, [0] * nd, self.num_groups, [wants[0], wants[1], False])
        if g_img is not None and tuple(g_img.shape) != tuple(shape):
            lows = [lo for lo, _ in self._pads(tuple(kern.shape[2:]))]
            g_img = g_img[(Ellipsis,) + tuple(slice(lo, lo + n) for lo, n in zip(lows, shape[2:]))]
        if g_kern is not None and self.filter_flip:
            g_kern = g_kern.flip(tuple(range(2, 2 + nd)))
        return g_img, g_kern

    def perform(self, node, inputs, output_storage):
        perform_by_torch(self.torch_forward, node, inputs, output_storage)

    def infer_shape(self, fgraph, node, input_shapes):
        from aesara_tpu_torch.tensor.shape import shape as tshape

        out = node.outputs[0]
        return [tuple(tshape(out)[d] for d in range(out.type.ndim))]

    def L_op(self, inputs, outputs, output_grads):
        img, kern = inputs
        (gz,) = output_grads
        g_img = AbstractConv2dGradInputs(self)(kern, gz, img)
        g_kern = AbstractConv2dGradWeights(self)(img, gz, kern)
        return [g_img, g_kern]

    def __str__(self):
        return f"{type(self).__name__}{{{self.border_mode}, sub={self.subsample}, flip={self.filter_flip}}}"


class _ConvGradBase(Op):
    """A gradient of the forward ``fwd`` (2-d or 3-d), by its ``torch_grads``."""

    __props__ = ("fwd_props",)
    #: which gradient this op computes: (image, kernel)
    wants = (False, False)

    def __init__(self, fwd: AbstractConv2d):
        self.fwd = fwd
        self.fwd_props = (fwd.border_mode, fwd.subsample, fwd.filter_flip, fwd.filter_dilation, fwd.num_groups)

    def make_node(self, a, gz, template):
        a, gz, template = as_tensor_variable(a), as_tensor_variable(gz), as_tensor_variable(template)
        return Apply(self, [a, gz, template], [template.type()])

    def torch_grad(self, a, gz, template):
        img, kern = (template, a) if self.wants[0] else (a, template)
        g_img, g_kern = self.fwd.torch_grads(img, kern, gz, self.wants)
        return (g_img if self.wants[0] else g_kern).to(template.dtype)

    def perform(self, node, inputs, output_storage):
        perform_by_torch(self.torch_grad, node, inputs, output_storage)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[2]]

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_not_implemented

        return [grad_not_implemented(self, i, v) for i, v in enumerate(inputs)]


class AbstractConv2dGradInputs(_ConvGradBase):
    """The gradient with respect to the image: inputs (kernel, output
    cotangent, the image as its shape's template)."""

    wants = (True, False)


class AbstractConv2dGradWeights(_ConvGradBase):
    """The gradient with respect to the kernel: inputs (image, output
    cotangent, the kernel as its shape's template)."""

    wants = (False, True)


def conv2d(input, filters, input_shape=None, filter_shape=None, border_mode="valid", subsample=(1, 1),
           filter_flip=True, filter_dilation=(1, 1), num_groups=1, **kwargs):
    """The user-facing 2-d convolution."""
    return AbstractConv2d(border_mode, subsample, filter_flip, filter_dilation, num_groups)(input, filters)


def conv2d_transpose(input, filters, output_shape=None, filter_shape=None, border_mode="valid",
                     input_dilation=(1, 1), filter_flip=True, num_groups=1):
    """The transposed (fractionally strided) convolution: the image
    gradient of the forward convolution whose output is ``input``."""
    from aesara_tpu_torch.tensor.basic import zeros

    input = as_tensor_variable(input)
    filters = as_tensor_variable(filters)
    if output_shape is None:
        raise ValueError("conv2d_transpose requires output_shape")
    template = zeros(tuple(output_shape), dtype=input.type.dtype)
    fwd = AbstractConv2d(border_mode, input_dilation, filter_flip, (1, 1), num_groups)
    return AbstractConv2dGradInputs(fwd)(filters, input, template)


class AbstractConv3d(AbstractConv2d):
    """NCDHW x OIDHW 3-d convolution."""

    def __init__(self, border_mode="valid", subsample=(1, 1, 1), filter_flip=True, filter_dilation=(1, 1, 1),
                 num_groups=1, imshp=None, kshp=None):
        super().__init__(border_mode, subsample, filter_flip, filter_dilation, num_groups)

    def make_node(self, img, kern):
        img = as_tensor_variable(img)
        kern = as_tensor_variable(kern)
        if img.type.ndim != 5 or kern.type.ndim != 5:
            raise TypeError("conv3d needs 5-d image (NCDHW) and kernel (OIDHW)")
        dtype = upcast(img.type.dtype, kern.type.dtype)
        pad3 = _norm_border3(self.border_mode, kern.type.shape[2:])
        spatial = []
        for i in range(3):
            isz, ksz = img.type.shape[2 + i], kern.type.shape[2 + i]
            if isz is None or ksz is None or pad3 is None:
                spatial.append(None)
                continue
            keff = (ksz - 1) * self.filter_dilation[i] + 1
            spatial.append((isz + pad3[i][0] + pad3[i][1] - keff) // self.subsample[i] + 1)
        return Apply(self, [img, kern], [TensorType(dtype, (img.type.shape[0], kern.type.shape[0]) + tuple(spatial))()])

    def _pads(self, kshape) -> tuple:
        return _norm_border3(self.border_mode, kshape)


def conv3d(input, filters, input_shape=None, filter_shape=None, border_mode="valid", subsample=(1, 1, 1),
           filter_flip=True, filter_dilation=(1, 1, 1), num_groups=1, **kwargs):
    """The user-facing 3-d convolution."""
    return AbstractConv3d(border_mode, subsample, filter_flip, filter_dilation, num_groups)(input, filters)
