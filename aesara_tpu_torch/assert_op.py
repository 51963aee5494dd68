"""The import path ``assert_op`` of ``raise_op`` (as ``aesara_tpu/assert_op.py``)."""
from aesara_tpu_torch.raise_op import Assert, CheckAndRaise, assert_op  # noqa: F401
