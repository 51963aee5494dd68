"""Graph IR, FunctionGraph and the rewrite framework (reference
``aesara_tpu/graph``)."""

from aesara_tpu_torch.graph.fg import FunctionGraph  # noqa: F401
from aesara_tpu_torch.graph.ir import Apply, Constant, Variable  # noqa: F401
from aesara_tpu_torch.graph.op import Op  # noqa: F401
