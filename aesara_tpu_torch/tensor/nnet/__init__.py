"""Neural-network ops and graph functions of the port (the counterpart of
``aesara_tpu/tensor/nnet/__init__.py``): convolution and pooling
(``abstract_conv``, ``pool``: library calls through
``link/torch/nnet_dispatch.py``), the graph functions of ``basic`` and
``batchnorm``, ``images2neibs`` (``neighbours``), fused attention
(``attention``: K2 and K3) and the CTC loss (``ctc``: its DP as torch ops,
the log-softmax on K4)."""

from aesara_tpu_torch.tensor.nnet.abstract_conv import (  # noqa: F401
    AbstractConv2d, AbstractConv3d, conv2d, conv2d_transpose, conv3d,
)
from aesara_tpu_torch.tensor.nnet.abstract_conv import conv2d as abstract_conv2d  # noqa: F401
from aesara_tpu_torch.tensor.nnet.abstract_conv import conv2d_transpose as conv2d_grad_wrt_inputs  # noqa: F401
from aesara_tpu_torch.tensor.nnet.attention import FusedAttention, fused_attention  # noqa: F401
from aesara_tpu_torch.tensor.nnet.basic import (  # noqa: F401
    binary_crossentropy, categorical_crossentropy, confusion_matrix, crossentropy_categorical_1hot,
    crossentropy_categorical_1hot_grad, crossentropy_softmax_1hot, crossentropy_softmax_1hot_with_bias,
    crossentropy_softmax_1hot_with_bias_dx, crossentropy_softmax_argmax_1hot_with_bias,
    crossentropy_softmax_max_and_argmax_1hot, crossentropy_softmax_max_and_argmax_1hot_with_bias, elu, h_softmax,
    hard_sigmoid, logsoftmax, prepend_0_to_each_row, prepend_1_to_each_row, prepend_scalar_to_each_row, relu, selu,
    sigmoid, sigmoid_binary_crossentropy, softmax, softmax_grad_legacy, softmax_legacy, softmax_with_bias, softplus,
    softsign, ultra_fast_sigmoid,
)
from aesara_tpu_torch.tensor.nnet.ctc import CTCGrad, CTCLoss, ctc  # noqa: F401
from aesara_tpu_torch.tensor.nnet.batchnorm import (  # noqa: F401
    batch_normalization, batch_normalization_test, batch_normalization_train,
)
from aesara_tpu_torch.tensor.nnet.neighbours import Images2Neibs, images2neibs  # noqa: F401
from aesara_tpu_torch.tensor.nnet.pool import Pool, max_pool_2d, pool_2d  # noqa: F401

#: the JAX package's names of the softmax rewrites, and the port's rewrites they are
_REWRITE_ALIASES = {
    "softmax_simplifier": "local_softmax_graph",
    "crossentropy_to_crossentropy_with_softmax": "local_logsoftmax",
    "crossentropy_to_crossentropy_with_softmax_with_bias": "local_logsoftmax",
    "graph_merge_softmax_with_crossentropy_softmax": "local_softmax_graph",
}


def __getattr__(name):
    # lazy: the rewrites import compile.mode, which the linker imports
    if name in _REWRITE_ALIASES:
        from aesara_tpu_torch.tensor.rewriting import special

        return getattr(special, _REWRITE_ALIASES[name])
    raise AttributeError(f"module 'aesara_tpu_torch.tensor.nnet' has no attribute {name!r}")


def separable_conv2d(input, depthwise_filters, pointwise_filters, num_channels, **kwargs):
    """A depthwise convolution (one group per input channel) then a 1x1
    pointwise one.  ``depthwise_filters`` is (num_channels * multiplier,
    1, h, w); filters [c*m:(c+1)*m] convolve input channel c.  Channel
    counts are static, so the groups unroll when the graph is built."""
    from aesara_tpu_torch.tensor.basic import join

    num_channels = int(num_channels)
    # constant slice bounds where the filter count is static
    static_n = depthwise_filters.type.shape[0]
    mult = static_n // num_channels if static_n is not None else depthwise_filters.shape[0] // num_channels
    chans = [conv2d(input[:, c:c + 1], depthwise_filters[c * mult:(c + 1) * mult], **kwargs)
             for c in range(num_channels)]
    return conv2d(join(1, *chans), pointwise_filters, border_mode="valid")
