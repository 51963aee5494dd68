"""Random streams (the counterpart of ``aesara_tpu/tensor/random``):
threefry keys, ``RandomVariable`` and the distributions, ``RandomStream``,
the random rewrites, and the lowering of a draw onto the threefry kernel
and the loop kernels (importing this package registers the last two)."""

from aesara_tpu_torch.tensor.random import basic  # noqa: F401
from aesara_tpu_torch.tensor.random.basic import *  # noqa: F401,F403
from aesara_tpu_torch.tensor.random.op import (  # noqa: F401
    RandomGeneratorType, RandomStateType, RandomVariable, default_rng, random_generator_type,
)
from aesara_tpu_torch.tensor.random.utils import RandomStream, RandomStreams  # noqa: F401
from aesara_tpu_torch.tensor.random.var import (  # noqa: F401
    RandomGeneratorSharedVariable, RandomStateSharedVariable, RandomTypeSharedVariable,
)
from aesara_tpu_torch.tensor.random import rewriting  # noqa: F401  (registers the random rewrites)
from aesara_tpu_torch.link.torch import random_dispatch  # noqa: F401,E402  (registers RandomVariable's lowering)
