"""The tensor API of the port (reference ``aesara_tpu/tensor``): the
subset the encoder's forward and train step, the optimizers and the
linear models use."""

from aesara_tpu_torch.tensor.basic import (  # noqa: F401
    alloc, arange, as_tensor_variable, cast, constant, fill, flatten, ones_like, switch, where,
    zeros_like,
)
from aesara_tpu_torch.tensor.math import (  # noqa: F401
    abs, add, all, and_, any, argmax, clip, cos, dot, eq, exp, ge, gt, invert, isinf, isnan, le, log,
    lt, max, maximum, mean, min, minimum, mul, neg, neq, or_, pow, sgn, sin, sqr, sqrt, sub, sum,
    true_div,
)
from aesara_tpu_torch.tensor.nnet.attention import fused_attention  # noqa: F401
from aesara_tpu_torch.tensor.shape import reshape, shape_padright  # noqa: F401
from aesara_tpu_torch.tensor.special import log_softmax, softmax  # noqa: F401
from aesara_tpu_torch.tensor.type import TensorType, matrix, scalar, tensor3, vector  # noqa: F401
