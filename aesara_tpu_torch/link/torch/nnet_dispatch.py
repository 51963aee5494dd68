"""The lowerings of convolution, pooling, ``Images2Neibs`` and the CTC
loss (the counterparts of ``aesara_tpu/link/jax/nnet_dispatch.py:18-53``
and ``nnet_extra_dispatch.py:20-56``).

Each runs its op's own torch form, as each JAX lowering runs its op's
``lax`` form: ``torch.nn.functional.conv2d``/``conv3d`` forward, the
gradients by ``aten.convolution_backward`` with the mask of the one
wanted (``tensor/nnet/abstract_conv.py``), pooling over an explicit
``F.pad`` and its gradient as XLA's select-and-scatter places it
(``tensor/nnet/pool.py``), and the patches of ``images2neibs`` by
``unfold``, and the CTC loss's DP and its autograd gradient as torch ops
over the steps (``tensor/nnet/ctc.py``).  These are library calls and
torch ops, not kernels of the port: the JAX package computes them by XLA,
outside any Pallas kernel.  On the card,
cuDNN runs the convolutions, so ``TorchLinker`` refuses to compile an fp32
or fp64 one while cuDNN may round it to TF32 or autotunes
(``linker.cudnn_refusal``).
"""

from __future__ import annotations

from aesara_tpu_torch.link.torch.dispatch import torch_funcify
from aesara_tpu_torch.tensor.nnet.abstract_conv import AbstractConv2d, _ConvGradBase
from aesara_tpu_torch.tensor.nnet.ctc import CTCGrad, CTCLoss
from aesara_tpu_torch.tensor.nnet.neighbours import Images2Neibs
from aesara_tpu_torch.tensor.nnet.pool import Pool, PoolGrad


__all__ = ["CONV_OPS"]

#: the ops cuDNN computes on the card (``AbstractConv3d`` is an ``AbstractConv2d``)
CONV_OPS = (AbstractConv2d, _ConvGradBase)


@torch_funcify.register(AbstractConv2d)
def _torch_conv(op, node):
    return op.torch_forward


@torch_funcify.register(_ConvGradBase)
def _torch_conv_grad(op, node):
    return op.torch_grad


@torch_funcify.register(Pool)
def _torch_pool(op, node):
    return op.torch_forward


@torch_funcify.register(PoolGrad)
def _torch_pool_grad(op, node):
    return op.torch_grad


@torch_funcify.register(Images2Neibs)
def _torch_images2neibs(op, node):
    def images2neibs(x, neib_shape, neib_step):
        return op.torch_patches(x, neib_shape, neib_step)

    images2neibs.host_inputs = (1, 2)
    images2neibs.syncs = (1, 2)
    images2neibs.sync_blocker = "reads its patch shape or step on the host"
    return images2neibs


@torch_funcify.register(CTCLoss)
def _torch_ctc(op, node):
    return op.torch_forward


@torch_funcify.register(CTCGrad)
def _torch_ctc_grad(op, node):
    return op.torch_forward
