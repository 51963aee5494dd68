"""Graph rewrites of the port; importing this package registers them."""

from aesara_tpu_torch.tensor.rewriting import (  # noqa: F401
    basic, elemwise, math, special, subtensor, uncanonicalize,
)
