"""aesara_tpu_torch: the PyTorch and CUDA port of aesara_tpu.

Graphs are built with the same symbolic API (``aesara_tpu_torch.tensor``,
``shared``, ``grad``), compiled by ``function(inputs, outputs, mode=,
updates=)`` through the optdb rewrite pipeline, and run by
``TorchLinker`` on one torch device (the card unless the caller asks for
the CPU), with hand-written Hopper kernels for fused elementwise
Composites and row softmax (Triton), attention forward and backward, and
the CSR products of sparse inputs (CUDA C++).  This package imports torch
and never jax.
"""

from aesara_tpu_torch.config import config  # noqa: F401
from aesara_tpu_torch import tensor  # noqa: F401
from aesara_tpu_torch.compile.function import Function, function  # noqa: F401
from aesara_tpu_torch.compile.io import In, Out  # noqa: F401
from aesara_tpu_torch.compile.mode import TORCH, Mode, get_mode  # noqa: F401
from aesara_tpu_torch.compile.sharedvalue import shared  # noqa: F401
from aesara_tpu_torch.gradient import grad, hessian, jacobian  # noqa: F401
from aesara_tpu_torch.link.torch.linker import TorchLinker  # noqa: F401
from aesara_tpu_torch.tensor import rewriting  # noqa: F401  (registers the rewrites)
from aesara_tpu_torch.tensor import blas  # noqa: F401  (registers BlasOpt)
from aesara_tpu_torch import sparse  # noqa: F401  (registers the sparse rewrites)
from aesara_tpu_torch import scan  # noqa: F401  (registers the scan rewrites and Scan's lowering)
from aesara_tpu_torch.compile.builders import register_inline_ofg
from aesara_tpu_torch.link.torch import control_dispatch  # noqa: F401  (OpFromGraph's and RematBarrier's lowerings)

register_inline_ofg()

__all__ = ["config", "tensor", "sparse", "function", "Function", "In", "Out", "Mode", "TORCH",
           "get_mode", "shared", "grad", "jacobian", "hessian", "TorchLinker"]
