"""The tensor API of the port (reference ``aesara_tpu/tensor/__init__.py``):
the NumPy-like symbolic namespace (``import aesara_tpu_torch.tensor as
at``), with the same names as the JAX package's but those the port leaves
out on purpose (``tests/test_torch_api_surface.py`` lists each with its
reason)."""

from aesara_tpu_torch.tensor.type import *  # noqa: F401,F403  (TensorType and the constructors)
from aesara_tpu_torch.tensor.type import TensorType, tensor  # noqa: F401
from aesara_tpu_torch.tensor.var import TensorConstant, TensorVariable  # noqa: F401
from aesara_tpu_torch.tensor.basic import *  # noqa: F401,F403
from aesara_tpu_torch.tensor.basic import (  # noqa: F401
    NotScalarConstantError, get_scalar_constant_value, get_vector_length,
)
from aesara_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise  # noqa: F401
from aesara_tpu_torch.tensor.shape import (  # noqa: F401
    Reshape, Shape, Shape_i, SpecifyShape, reshape, shape_padaxis, shape_padleft, shape_padright, specify_shape,
    unbroadcast,
)
from aesara_tpu_torch.tensor.math import *  # noqa: F401,F403
from aesara_tpu_torch.tensor.blas import batched_tensordot, outer  # noqa: F401
from aesara_tpu_torch.scalar.ops import ScalarType, upcast  # noqa: F401
from aesara_tpu_torch.tensor import math  # noqa: F401
from aesara_tpu_torch.tensor.blas import gemm, gemv, ger  # noqa: F401,E501
from aesara_tpu_torch.tensor.subtensor import (  # noqa: F401
    AdvancedIncSubtensor, AdvancedIncSubtensor1, AdvancedSubtensor, AdvancedSubtensor1, IncSubtensor, Subtensor,
    inc_subtensor, set_subtensor, take,
)
from aesara_tpu_torch.tensor.sort import argsort, argtopk, take_along_axis, topk, topk_and_argtopk  # noqa: F401
from aesara_tpu_torch.graph.ir import Apply, Constant, Variable  # noqa: F401
from aesara_tpu_torch.graph.op import Op  # noqa: F401
from aesara_tpu_torch.config import config  # noqa: F401
from aesara_tpu_torch.scalar.ops import discrete_dtypes  # noqa: F401
from aesara_tpu_torch.gradient import consider_constant, grad, hessian, jacobian  # noqa: F401
from aesara_tpu_torch.tensor.nnet.attention import fused_attention  # noqa: F401
from aesara_tpu_torch.tensor.special import log_softmax, softmax  # noqa: F401

#: anything ``as_tensor_variable`` converts
TensorLike = object

# ``var``, ``shape`` and ``sort`` name functions here, as in the JAX package,
# though submodules of this package share those names.  Each submodule is
# imported first, so no later import of it binds its name to the module;
# ``from aesara_tpu_torch.tensor.shape import ...`` reaches the module still.
import aesara_tpu_torch.tensor.shape  # noqa: E402,F401
import aesara_tpu_torch.tensor.sort  # noqa: E402,F401
import aesara_tpu_torch.tensor.var  # noqa: E402,F401
from aesara_tpu_torch.tensor.math import var  # noqa: E402,F401,F811
from aesara_tpu_torch.tensor.shape import shape  # noqa: E402,F401,F811
from aesara_tpu_torch.tensor.sort import sort  # noqa: E402,F401,F811


def __getattr__(name):
    """The submodules the port has, imported on first use, and the
    functions of ``extra_ops`` at the namespace's root, as in the JAX
    package."""
    import importlib

    lazy = {"extra_ops", "sort", "special", "random", "nnet", "blas", "rewriting", "sharedvar", "elemwise",
            "subtensor", "type", "basic", "type_other", "subtensor_opt"}
    if name in lazy:
        return importlib.import_module(f"aesara_tpu_torch.tensor.{name}")
    extra = importlib.import_module("aesara_tpu_torch.tensor.extra_ops")
    if name in extra.__all__:
        return getattr(extra, name)
    raise AttributeError(f"module 'aesara_tpu_torch.tensor' has no attribute {name!r}")
