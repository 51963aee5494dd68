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

import logging

# the package's logger with one default stderr handler, which an
# application that configures logging itself may detach
aesara_logger = logging.getLogger("aesara_tpu_torch")
logging_default_handler = logging.StreamHandler()
logging_default_formatter = logging.Formatter(fmt="%(levelname)s (%(name)s): %(message)s")
logging_default_handler.setFormatter(logging_default_formatter)
aesara_logger.setLevel(logging.WARNING)
if not aesara_logger.hasHandlers():
    aesara_logger.addHandler(logging_default_handler)


def disable_log_handler(logger=aesara_logger, handler=logging_default_handler):
    """Detach the default handler."""
    if logger.hasHandlers():
        logger.removeHandler(handler)


from aesara_tpu_torch.config import change_flags, config  # noqa: E402,F401
from aesara_tpu_torch.graph.ir import Variable, clone_replace  # noqa: E402,F401
from aesara_tpu_torch import scalar  # noqa: E402,F401
from aesara_tpu_torch import tensor  # noqa: E402,F401
from aesara_tpu_torch import tensor as at  # noqa: E402,F401  (the conventional alias)
from aesara_tpu_torch.compile.function import Function, function, function_dump, pfunc  # noqa: E402,F401
from aesara_tpu_torch.compile.function import Function as FunctionMaker  # noqa: E402,F401
from aesara_tpu_torch.compile.io import In, Out  # noqa: E402,F401
from aesara_tpu_torch.compile.mode import (  # noqa: E402,F401
    FAST_COMPILE, FAST_RUN, TORCH, Mode, get_mode, predefined_linkers, predefined_modes, predefined_optimizers,
)
from aesara_tpu_torch.compile.ops import as_op  # noqa: E402,F401
from aesara_tpu_torch.compile.sharedvalue import SharedVariable, shared, shared_constructor  # noqa: E402,F401
from aesara_tpu_torch.gradient import Lop, Rop, grad, hessian, jacobian, subgraph_grad, verify_grad  # noqa: E402,F401
from aesara_tpu_torch.link.torch.linker import TorchLinker  # noqa: E402,F401
from aesara_tpu_torch.printing import Print  # noqa: E402,F401
from aesara_tpu_torch.raise_op import Assert, assert_op  # noqa: E402,F401
from aesara_tpu_torch.updates import OrderedUpdates  # noqa: E402,F401
from aesara_tpu_torch.tensor import rewriting as _tensor_rewriting  # noqa: E402,F401  (registers the rewrites)
from aesara_tpu_torch.tensor import blas as _blas  # noqa: E402,F401  (registers BlasOpt)
from aesara_tpu_torch import sparse  # noqa: E402,F401  (registers the sparse rewrites)
from aesara_tpu_torch import scan as _scan  # noqa: E402,F401  (registers the scan rewrites and Scan's lowering)
from aesara_tpu_torch.compile.builders import OpFromGraph, remat  # noqa: E402,F401
from aesara_tpu_torch.compile.builders import register_inline_ofg as _register_inline_ofg  # noqa: E402
from aesara_tpu_torch.link.torch import control_dispatch as _control_dispatch  # noqa: E402,F401  (IfElse, ...)
from aesara_tpu_torch.link.torch import nnet_dispatch as _nnet_dispatch  # noqa: E402,F401  (convolution, ...)
from aesara_tpu_torch.ifelse import ifelse  # noqa: E402,F401
from aesara_tpu_torch.ifelse import register_ifelse_rewrites as _register_ifelse_rewrites  # noqa: E402

_register_inline_ofg()
_register_ifelse_rewrites()

# ``scan`` is the function, as in the JAX package; the subpackage imported
# above stays reachable by its module path (``aesara_tpu_torch.scan.basic``)
from aesara_tpu_torch.scan.basic import scan  # noqa: E402,F401,F811
from aesara_tpu_torch.scan.views import foldl, foldr, map, reduce  # noqa: E402,F401,A004
from aesara_tpu_torch.scan.views import map as scan_map  # noqa: E402,F401
from aesara_tpu_torch.scan.checkpoints import scan_checkpoints  # noqa: E402,F401
from aesara_tpu_torch.scan.views import reduce as scan_reduce  # noqa: E402,F401


def as_symbolic(x, name=None, **kwargs):
    """``x`` as a Variable: a Variable as it is, a SciPy sparse matrix as a
    sparse constant, anything else through ``as_tensor_variable``."""
    import scipy.sparse

    if isinstance(x, Variable):
        return x
    if scipy.sparse.issparse(x):
        from aesara_tpu_torch.sparse.basic import as_sparse_variable

        res = as_sparse_variable(x)
        if name is not None:
            res.name = name
        return res
    res = tensor.as_tensor_variable(x, **kwargs)
    if name is not None:
        res.name = name
    return res


def get_scalar_constant_value(v):
    """The Python scalar behind a constant scalar graph."""
    return tensor.get_scalar_constant_value(v)
