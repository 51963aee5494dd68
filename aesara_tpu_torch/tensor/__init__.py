"""The tensor API of the port (reference ``aesara_tpu/tensor``): the
subset the encoder's forward and train step use."""

from aesara_tpu_torch.tensor.basic import (  # noqa: F401
    as_tensor_variable, cast, constant, fill, ones_like, zeros_like,
)
from aesara_tpu_torch.tensor.math import (  # noqa: F401
    add, dot, ge, lt, maximum, mean, mul, neg, sqr, sqrt, sub, sum, true_div,
)
from aesara_tpu_torch.tensor.nnet.attention import fused_attention  # noqa: F401
from aesara_tpu_torch.tensor.shape import reshape  # noqa: F401
from aesara_tpu_torch.tensor.type import TensorType, matrix, scalar, tensor3, vector  # noqa: F401
