"""The reference's import path ``tensor/random/type.py``: the key types
live in ``tensor/random/op.py``."""
from aesara_tpu_torch.tensor.random.op import (  # noqa: F401
    RandomGeneratorType,
    RandomStateType,
    random_generator_type,
)
