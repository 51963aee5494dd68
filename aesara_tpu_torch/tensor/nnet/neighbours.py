"""``images2neibs``: the sliding patches of images as rows (the
counterpart of ``aesara_tpu/tensor/nnet/neighbours.py``).  The lowering
(``link/torch/nnet_dispatch.py``) takes them by ``unfold``; the patch
shape and step are read on the host."""

from __future__ import annotations

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.scalar.ops import perform_by_torch
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["Images2Neibs", "images2neibs"]


class Images2Neibs(Op):
    """(b, c, H, W) to the (b*c*nH*nW, hh*ww) matrix of its patches, row
    by row of patches within each image and channel.  Mode "valid" needs
    the patches to tile the image exactly; "ignore_borders" drops what is
    left over."""

    __props__ = ("mode",)

    def __init__(self, mode="valid"):
        if mode not in ("valid", "ignore_borders"):
            raise NotImplementedError(f"images2neibs mode {mode}")
        self.mode = mode

    def make_node(self, ten4, neib_shape, neib_step=None):
        ten4 = as_tensor_variable(ten4)
        neib_shape = cast(as_tensor_variable(neib_shape), "int64")
        neib_step = neib_shape if neib_step is None else cast(as_tensor_variable(neib_step), "int64")
        if ten4.type.ndim != 4:
            raise TypeError("images2neibs needs a 4-d tensor")
        return Apply(self, [ten4, neib_shape, neib_step], [TensorType(ten4.type.dtype, (None, None))()])

    def torch_patches(self, x, neib_shape, neib_step):
        """The patch matrix of the tensor ``x``; the patch shape and step
        are read on the host."""
        (hh, ww), (sh, sw) = [int(v) for v in neib_shape.tolist()], [int(v) for v in neib_step.tolist()]
        if self.mode == "valid" and ((x.shape[2] - hh) % sh or (x.shape[3] - ww) % sw):
            raise ValueError("images2neibs 'valid': shape must tile exactly; use ignore_borders")
        patches = x.unfold(2, hh, sh).unfold(3, ww, sw)      # (b, c, nH, nW, hh, ww)
        return patches.reshape(-1, hh * ww)

    def perform(self, node, inputs, output_storage):
        perform_by_torch(self.torch_patches, node, inputs, output_storage)

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import disconnected_type, grad_not_implemented

        return [grad_not_implemented(self, 0, inputs[0], "images2neibs grad"), disconnected_type(),
                disconnected_type()]


def images2neibs(ten4, neib_shape, neib_step=None, mode="valid"):
    return Images2Neibs(mode)(ten4, neib_shape, neib_step)
