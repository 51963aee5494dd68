"""Scalar types and ops (reference ``aesara_tpu/scalar``)."""

from aesara_tpu_torch.scalar import ops  # noqa: F401
from aesara_tpu_torch.scalar.composite import Composite  # noqa: F401
from aesara_tpu_torch.scalar.ops import ScalarType  # noqa: F401
