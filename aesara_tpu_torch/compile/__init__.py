"""Compilation: shared variables, modes and ``function`` (reference
``aesara_tpu/compile``), and the graph rewriters that attach a
destroy handler or another feature."""

from aesara_tpu_torch.compile.function import Function, function  # noqa: F401
from aesara_tpu_torch.compile.io import In, Out  # noqa: F401
from aesara_tpu_torch.compile.mode import TORCH, Mode, get_mode, optdb  # noqa: F401
from aesara_tpu_torch.compile.sharedvalue import SharedVariable, shared  # noqa: F401


class AddDestroyHandler:
    """A graph rewriter that attaches a DestroyHandler (reference
    ``aesara_tpu/compile/__init__.py:174-186``)."""

    def rewrite(self, fgraph):
        from aesara_tpu_torch.graph.destroyhandler import add_destroy_handler

        return add_destroy_handler(fgraph)

    __call__ = rewrite


class AddFeatureOptimizer:
    """A graph rewriter that attaches ``feature`` (reference
    ``aesara_tpu/compile/__init__.py:189-199``)."""

    def __init__(self, feature):
        self.feature = feature

    def rewrite(self, fgraph):
        fgraph.attach_feature(self.feature)
        return fgraph

    __call__ = rewrite
