"""``Mode`` = (rewrite query, linker), and the global ``optdb`` pipeline
(reference ``aesara_tpu/compile/mode.py``).

Positions follow the JAX package: merge1 at 0, useless at 0.6, canonicalize at 1,
stabilize at 1.5, the scan rewrites at 0.05 and 1.6-1.66 (and 50.5-50.6),
BlasOpt at 1.7, specialize at 2, uncanonicalize at 3, elemwise fusion at
49, merge2 and the destroy handler at 49.5, blas_inplace at 70, merge3 at
100.  The ``TORCH`` mode runs the ``fast_run`` rewrites and links
through ``TorchLinker``; ``including``/``excluding`` give a mode with
tags added to or taken from its query, as the JAX package's ``Mode``
does (``TORCH.excluding("BlasOpt")``).
"""

from __future__ import annotations

from typing import Optional, Union

from aesara_tpu_torch.graph.destroyhandler import add_destroy_handler
from aesara_tpu_torch.graph.rewriting.basic import FromFunctionGraphRewriter, MergeOptimizer
from aesara_tpu_torch.graph.rewriting.db import EquilibriumDB, RewriteDatabaseQuery, SequenceDB
from aesara_tpu_torch.link.torch.linker import TorchLinker


__all__ = ["Mode", "optdb", "get_mode", "register_useless", "register_canonicalize", "register_stabilize",
           "register_specialize", "register_uncanonicalize", "TORCH", "FAST_RUN", "FAST_COMPILE", "OPT_FAST_RUN",
           "OPT_FAST_COMPILE", "predefined_modes", "predefined_linkers", "predefined_optimizers"]


optdb = SequenceDB()
optdb.register("merge1", MergeOptimizer(), "fast_run", "fast_compile", "merge", position=0)
local_useless = EquilibriumDB()
optdb.register("useless", local_useless, "fast_run", "fast_compile", position=0.6)
canonicalize = EquilibriumDB()
optdb.register("canonicalize", canonicalize, "fast_run", "fast_compile", position=1)
stabilize = EquilibriumDB()
optdb.register("stabilize", stabilize, "fast_run", position=1.5)
specialize = EquilibriumDB()
optdb.register("specialize", specialize, "fast_run", position=2)
uncanonicalize = EquilibriumDB()
optdb.register("uncanonicalize", uncanonicalize, "fast_run", position=3)
optdb.register("merge2", MergeOptimizer(), "fast_run", "merge", position=49.5)
# the destroy handler, which the in-place rewrites (blas_inplace at 70) and
# the linker's donation of updated shared storage consult
optdb.register("add_destroy_handler", FromFunctionGraphRewriter(add_destroy_handler), "fast_run", "inplace",
               position=49.5)
optdb.register("merge3", MergeOptimizer(), "fast_run", "merge", position=100)
# position 1.7: BlasOpt, registered by aesara_tpu_torch.tensor.blas; position
# 49: elemwise fusion, registered by aesara_tpu_torch.tensor.rewriting


def register_useless(rewrite, *tags, name=None):
    local_useless.register(name or rewrite.name, rewrite, "fast_run", "fast_compile", *tags)
    return rewrite


def register_canonicalize(rewrite, *tags, name=None):
    canonicalize.register(name or rewrite.name, rewrite, "fast_run", "fast_compile", *tags)
    return rewrite


def register_stabilize(rewrite, *tags, name=None):
    stabilize.register(name or rewrite.name, rewrite, "fast_run", *tags)
    return rewrite


def register_specialize(rewrite, *tags, name=None):
    specialize.register(name or rewrite.name, rewrite, "fast_run", *tags)
    return rewrite


def register_uncanonicalize(rewrite, *tags, name=None):
    uncanonicalize.register(name or rewrite.name, rewrite, "fast_run", *tags)
    return rewrite


OPT_NONE = RewriteDatabaseQuery(include=[])
OPT_FAST_RUN = RewriteDatabaseQuery(include=["fast_run"])
OPT_FAST_COMPILE = RewriteDatabaseQuery(include=["fast_compile"])
OPT_MERGE = RewriteDatabaseQuery(include=["merge"])


class Mode:
    """A (rewrite query, linker) pair."""

    def __init__(self, linker=None, optimizer: Optional[RewriteDatabaseQuery] = OPT_FAST_RUN):
        self.linker = linker if linker is not None else TorchLinker()
        self.query = optimizer if optimizer is not None else OPT_NONE

    @property
    def optimizer(self):
        return optdb.query(self.query)

    def including(self, *tags) -> "Mode":
        return Mode(self.linker, self.query.including(*tags))

    def excluding(self, *tags) -> "Mode":
        return Mode(self.linker, self.query.excluding(*tags))

    def __str__(self):
        return f"Mode(linker={self.linker}, optimizer={self.query})"


TORCH = Mode(TorchLinker(), OPT_FAST_RUN)
# ``FAST_RUN`` is the JAX package's name for the same rewrites on its own
# linker (``aesara_tpu/compile/mode.py``), so its callers run verbatim here;
# ``FAST_COMPILE`` runs the merges, the useless-node removals and the
# canonicalizations only, as there.  The JAX package's ``JAX`` and ``PY``
# modes have no counterpart: the port has one linker and no fallback.
FAST_RUN = TORCH
FAST_COMPILE = Mode(TorchLinker(), OPT_FAST_COMPILE)
predefined_modes = {"TORCH": TORCH, "FAST_RUN": FAST_RUN, "FAST_COMPILE": FAST_COMPILE}
predefined_linkers = {"torch": TorchLinker()}
predefined_optimizers = {None: OPT_NONE, "None": OPT_NONE, "merge": OPT_MERGE, "fast_compile": OPT_FAST_COMPILE,
                         "fast_run": OPT_FAST_RUN}


def get_mode(mode: Optional[Union[str, Mode]]) -> Mode:
    if mode is None:
        return TORCH
    if isinstance(mode, Mode):
        return mode
    if mode in predefined_modes:
        return predefined_modes[mode]
    raise ValueError(f"unknown mode {mode!r}")
