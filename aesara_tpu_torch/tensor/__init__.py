"""The tensor API of the port (reference ``aesara_tpu/tensor``): the
subset the encoder's forward and train step, the optimizers, the linear
models, the MLP and the repo's reference configurations 1-3 use."""

from aesara_tpu_torch.tensor.basic import (  # noqa: F401
    alloc, arange, as_tensor_variable, cast, concatenate, constant, empty, fill, flatten, full, join, ones,
    ones_like, split, stack, switch, where, zeros, zeros_like,
)
from aesara_tpu_torch.tensor.math import (  # noqa: F401
    abs, add, all, and_, any, arccos, arccosh, arcsin, arcsinh, arctan, arctan2, arctanh, argmax, ceil,
    clip, cos, cosh, deg2rad, dot, eq, erf, erfc, erfcinv, erfcx, erfinv, exp, exp2, expit, expm1, floor,
    floor_div, gamma, gammaln, ge, gt, i0, i1, int_div, inv, invert, isinf, isnan, j0, j1, le, log, log1mexp,
    log1p, log1pexp, log2, log10, lt, max, maximum, mean, min, minimum, mod, mul, neg, neq, or_, pow, psi,
    rad2deg, reciprocal, round_half_away_from_zero, round_half_to_even, sgn, shift_left, shift_right,
    sigmoid, sin, sinh, softplus, sqr, sqrt, sub, sum, tan, tanh, tri_gamma, true_div, trunc, xor,
)
from aesara_tpu_torch.tensor.nnet.attention import fused_attention  # noqa: F401
from aesara_tpu_torch.tensor.shape import (  # noqa: F401
    reshape, shape_padleft, shape_padright, specify_shape, unbroadcast,
)
from aesara_tpu_torch.tensor.special import log_softmax, softmax  # noqa: F401
from aesara_tpu_torch.tensor.type import *  # noqa: F401,F403  (TensorType and the constructors)
from aesara_tpu_torch.tensor.subtensor import inc_subtensor, set_subtensor  # noqa: F401
