"""Graph rewrites of the port; importing this package registers them."""

from aesara_tpu_torch.tensor.rewriting import basic, elemwise, math, special, subtensor  # noqa: F401
