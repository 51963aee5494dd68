"""The ``Type`` base class (defined with the IR in ``graph/ir.py``)."""

from aesara_tpu_torch.graph.ir import Type  # noqa: F401
