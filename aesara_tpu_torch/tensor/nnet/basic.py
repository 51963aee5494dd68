"""The nnet graph functions (the counterpart of
``aesara_tpu/tensor/nnet/basic.py``): activations, the cross-entropy
family, ``confusion_matrix``, the ``prepend_*`` helpers and
``h_softmax``.  All are compositions of ops the port already has, so K1
fuses their elementwise chains and K4 computes their softmaxes."""

from __future__ import annotations

import aesara_tpu_torch.tensor.basic as tb
import aesara_tpu_torch.tensor.math as tm
from aesara_tpu_torch.tensor.basic import as_tensor_variable, cast, constant
from aesara_tpu_torch.tensor.special import log_softmax, softmax
from aesara_tpu_torch.tensor.math import sigmoid, softplus


__all__ = [
    "sigmoid", "ultra_fast_sigmoid", "hard_sigmoid", "softplus", "softmax",
    "softmax_with_bias", "relu", "elu", "selu",
    "binary_crossentropy", "sigmoid_binary_crossentropy",
    "categorical_crossentropy", "crossentropy_categorical_1hot",
    "crossentropy_softmax_1hot", "crossentropy_softmax_1hot_with_bias",
    "crossentropy_softmax_argmax_1hot_with_bias", "confusion_matrix",
]

# the reference's fast sigmoid approximations are sigmoid itself, as in the
# JAX package
ultra_fast_sigmoid = sigmoid


def hard_sigmoid(x):
    x = as_tensor_variable(x)
    slope = constant(0.2, dtype=x.type.dtype if x.type.dtype.startswith("float") else None)
    shift = constant(0.5, dtype=None)
    return tm.clip(x * slope + shift, 0.0, 1.0)


def softmax_with_bias(x, b):
    """(reference ``nnet/basic.py:57`` SoftmaxWithBias)"""
    return softmax(x + b, axis=-1)


def relu(x, alpha=0.0):
    x = as_tensor_variable(x)
    if isinstance(alpha, (int, float)) and alpha == 0.0:
        return tm.maximum(x, constant(0.0))
    return tb.switch(tm.gt(x, 0.0), x, alpha * x)


def elu(x, alpha=1.0):
    x = as_tensor_variable(x)
    return tb.switch(tm.gt(x, 0.0), x, alpha * tm.expm1(x))


def selu(x):
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    return scale * elu(x, alpha)


def binary_crossentropy(output, target):
    """-t log(o) - (1-t) log(1-o) (reference same name)."""
    output = as_tensor_variable(output)
    target = as_tensor_variable(target)
    return -(target * tm.log(output) + (1.0 - target) * tm.log(1.0 - output))


def sigmoid_binary_crossentropy(output, target):
    """Stable fused form on logits (reference same name)."""
    output = as_tensor_variable(output)
    target = as_tensor_variable(target)
    # -[t·log σ(x) + (1−t)·log(1−σ(x))] = softplus(x) − t·x
    return softplus(output) - target * output


def categorical_crossentropy(coding_dist, true_dist):
    """(reference same name): true_dist is one-hot matrix OR index vector."""
    coding_dist = as_tensor_variable(coding_dist)
    true_dist = as_tensor_variable(true_dist)
    if true_dist.type.ndim == coding_dist.type.ndim:
        return -tm.sum(true_dist * tm.log(coding_dist), axis=-1)
    if true_dist.type.ndim == coding_dist.type.ndim - 1:
        return crossentropy_categorical_1hot(coding_dist, true_dist)
    raise TypeError("rank mismatch between coding_dist and true_dist")


def crossentropy_categorical_1hot(coding_dist, true_one_of_n):
    """-log(coding[i, true[i]]) (reference CrossentropyCategorical1Hot)."""
    coding_dist = as_tensor_variable(coding_dist)
    idx = cast(as_tensor_variable(true_one_of_n), "int64")
    from aesara_tpu_torch.tensor.basic import arange
    from aesara_tpu_torch.tensor.shape import shape as tshape

    rows = arange(tshape(coding_dist)[0])
    return -tm.log(coding_dist[rows, idx])


def crossentropy_softmax_1hot_with_bias(x, b, y_idx):
    """(xent, softmax) pair (reference :458 family), stable log-softmax form."""
    x = as_tensor_variable(x)
    b = as_tensor_variable(b)
    logits = x + b
    lsm = log_softmax(logits, axis=-1)
    from aesara_tpu_torch.tensor.basic import arange
    from aesara_tpu_torch.tensor.shape import shape as tshape

    idx = cast(as_tensor_variable(y_idx), "int64")
    rows = arange(tshape(x)[0])
    xent = -lsm[rows, idx]
    return xent, softmax(logits, axis=-1)


def crossentropy_softmax_1hot(x, y_idx):
    from aesara_tpu_torch.tensor.basic import zeros
    from aesara_tpu_torch.tensor.shape import shape as tshape

    b = zeros((tshape(x)[1],), dtype=as_tensor_variable(x).type.dtype)
    return crossentropy_softmax_1hot_with_bias(x, b, y_idx)


def crossentropy_softmax_argmax_1hot_with_bias(x, b, y_idx):
    xent, sm = crossentropy_softmax_1hot_with_bias(x, b, y_idx)
    return xent, sm, tm.argmax(as_tensor_variable(x) + b, axis=-1)


def confusion_matrix(actual, pred):
    """(reference same name): returns (matrix, order).  The label set is
    ``Unique``'s, whose length the data decides, so the function runs
    eagerly."""
    from aesara_tpu_torch.tensor.extra_ops import Unique

    actual = as_tensor_variable(actual)
    pred = as_tensor_variable(pred)
    order = Unique(False, False, False)(tb.join(0, actual, pred))
    from aesara_tpu_torch.tensor.math import eq as teq
    from aesara_tpu_torch.tensor.shape import shape_padleft, shape_padright

    colA = shape_padright(actual, 1)
    colP = shape_padright(pred, 1)
    oA = teq(colA, shape_padleft(order, 1))  # [n, k]
    oP = teq(colP, shape_padleft(order, 1))
    conf = tm.dot(tb.cast(oA, "int64").T, tb.cast(oP, "int64"))
    return [conf, order]


# --- reference nnet/__init__ completions -------------------------------------

def softsign(x):
    """x / (1 + |x|) (reference ``nnet/basic.py softsign``)."""
    x = as_tensor_variable(x)
    return x / (1.0 + tm.abs(x))


def logsoftmax(x, axis=-1):
    from aesara_tpu_torch.tensor.special import log_softmax

    return log_softmax(x, axis=axis)


def softmax_legacy(x):
    from aesara_tpu_torch.tensor.special import softmax

    return softmax(x, axis=-1)


def softmax_grad_legacy(dy, sm):
    from aesara_tpu_torch.tensor.special import SoftmaxGrad

    return SoftmaxGrad(axis=-1)(dy, sm)


def crossentropy_softmax_max_and_argmax_1hot_with_bias(x, b, y_idx):
    xent, sm = crossentropy_softmax_1hot_with_bias(x, b, y_idx)
    mx = tm.max(as_tensor_variable(x) + b, axis=-1)
    am = tm.argmax(as_tensor_variable(x) + b, axis=-1)
    return xent, sm, mx, am


def crossentropy_softmax_max_and_argmax_1hot(x, y_idx):
    from aesara_tpu_torch.tensor.basic import zeros

    b = zeros((as_tensor_variable(x).shape[1],), dtype=x.dtype)
    return crossentropy_softmax_max_and_argmax_1hot_with_bias(x, b, y_idx)


def crossentropy_softmax_1hot_with_bias_dx(dy, sm, y_idx):
    """Gradient wrt x of the fused xent-softmax (reference
    ``CrossentropySoftmax1HotWithBiasDx``): dx = dy[:,None]*(sm - onehot)."""
    from aesara_tpu_torch.tensor.basic import arange
    from aesara_tpu_torch.tensor.subtensor import inc_subtensor

    sm = as_tensor_variable(sm)
    dy = as_tensor_variable(dy)
    n = sm.shape[0]
    dx = sm * dy.dimshuffle(0, "x")
    return inc_subtensor(dx[arange(n), y_idx], -dy)


def crossentropy_categorical_1hot_grad(dy, coding_dist, true_one_of_n):
    """(reference ``CrossentropyCategorical1HotGrad``)"""
    from aesara_tpu_torch.tensor.basic import arange, zeros_like
    from aesara_tpu_torch.tensor.subtensor import inc_subtensor

    coding = as_tensor_variable(coding_dist)
    n = coding.shape[0]
    g = zeros_like(coding)
    return inc_subtensor(
        g[arange(n), true_one_of_n],
        -as_tensor_variable(dy) / coding[arange(n), true_one_of_n],
    )


def prepend_scalar_to_each_row(scalar, x):
    """(reference ``Prepend_scalar_to_each_row``)"""
    from aesara_tpu_torch.tensor.basic import alloc, join

    x = as_tensor_variable(x)
    col = alloc(cast(scalar, x.dtype), x.shape[0], 1)
    return join(1, col, x)


def prepend_0_to_each_row(x):
    return prepend_scalar_to_each_row(0.0, x)


def prepend_1_to_each_row(x):
    return prepend_scalar_to_each_row(1.0, x)


def h_softmax(x, batch_size, n_outputs, n_classes, n_outputs_per_class,
              W1, b1, W2, b2, target=None):
    """Two-level hierarchical softmax (reference ``nnet/basic.py
    h_softmax``): class softmax x within-class softmax; with a target,
    return only the target's probability (the O(sqrt(V)) trick)."""
    from aesara_tpu_torch.tensor.basic import arange
    from aesara_tpu_torch.tensor.special import softmax

    x = as_tensor_variable(x)
    class_probs = softmax(tm.dot(x, W1) + b1, axis=-1)      # (B, n_classes)
    if target is None:
        # full distribution: (B, n_classes, n_outputs_per_class)
        activations = tm.dot(x, W2.reshape((W2.shape[0], -1)))
        activations = activations.reshape(
            (x.shape[0], n_classes, n_outputs_per_class)) + b2
        within = softmax(activations, axis=-1)
        out = class_probs.dimshuffle(0, 1, "x") * within
        return out.reshape((x.shape[0], n_classes * n_outputs_per_class))[
            :, :n_outputs]
    target = as_tensor_variable(target)
    cls = target // n_outputs_per_class
    within_idx = target % n_outputs_per_class
    b = arange(0, x.shape[0])
    # only the target class's weight column block, (B, D, P): the JAX
    # package's W2[:, cls, :] transposed, indexed on the leading axis
    W2_cls = W2.dimshuffle(1, 0, 2)[cls]
    act = tm.sum(x.dimshuffle(0, 1, "x") * W2_cls, axis=1)
    act = act + b2[cls]
    within = softmax(act, axis=-1)
    return class_probs[b, cls] * within[b, within_idx]


__all__ += [
    "softsign", "logsoftmax", "softmax_legacy", "softmax_grad_legacy",
    "crossentropy_softmax_max_and_argmax_1hot_with_bias",
    "crossentropy_softmax_max_and_argmax_1hot",
    "crossentropy_softmax_1hot_with_bias_dx",
    "crossentropy_categorical_1hot_grad",
    "prepend_0_to_each_row", "prepend_1_to_each_row",
    "prepend_scalar_to_each_row", "h_softmax",
]
