"""Compilation: shared variables, modes and ``function`` (reference
``aesara_tpu/compile``)."""

from aesara_tpu_torch.compile.function import Function, function  # noqa: F401
from aesara_tpu_torch.compile.io import In, Out  # noqa: F401
from aesara_tpu_torch.compile.mode import TORCH, Mode, get_mode, optdb  # noqa: F401
from aesara_tpu_torch.compile.sharedvalue import SharedVariable, shared  # noqa: F401
