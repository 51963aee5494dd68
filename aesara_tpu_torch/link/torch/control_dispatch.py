"""The lowerings of ``OpFromGraph`` and ``RematBarrier`` (the counterparts
of ``_jx_op_from_graph`` and ``_jx_remat_barrier`` in
``aesara_tpu/link/jax/control_dispatch.py``).

An ``OpFromGraph`` node (a ``Remat`` too) runs a copy of its subgraph as
an inner :class:`~aesara_tpu_torch.link.torch.linker.Program`, made when
the function is compiled.  The copy is rewritten as Scan's inner programs
are (``FAST_RUN`` but ``BlasOpt``, ``scan_dispatch.fused_inner_graph``),
so its elementwise chains fuse into K1 launches; the op's own ``fgraph``
is left as it is, since every function that holds the op shares it.  The
inner program frees its intermediates after their last reader
(``config.allow_gc``), so a ``Remat`` node keeps none of them: that is the
memory ``remat`` saves.  The inner program runs inside the outer step,
so a captured step records its launches too.

``RematBarrier`` is the identity.  What it fences is a recompute in the
outer graph, which no rewrite merges with the forward (its ``nonce``).
"""

from __future__ import annotations

from aesara_tpu_torch.compile.builders import OpFromGraph, RematBarrier
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.dispatch import torch_funcify


__all__ = ["fused_ofg_graph"]


def fused_ofg_graph(op):
    """A copy of the op's subgraph rewritten by the ``FAST_RUN`` pipeline
    but ``BlasOpt``, its elementwise chains fused."""
    from aesara_tpu_torch.compile.mode import get_mode

    fgraph = op.fgraph.clone()
    get_mode(None).excluding("BlasOpt").optimizer.rewrite(fgraph)
    return fgraph


@torch_funcify.register(OpFromGraph)
def _torch_op_from_graph(op, node):
    import torch

    from aesara_tpu_torch.link.torch.linker import Program

    inner = fused_ofg_graph(op)
    program = Program(inner, None, bool(config.allow_gc))
    # a program's uploads of host values depend on its inputs' shapes only
    uploads_by_shape: dict = {}

    def op_from_graph(*args):
        program.device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
        shapes = tuple((tuple(a.shape), getattr(a, "dtype", None)) for a in args)
        uploads = uploads_by_shape.setdefault(shapes, {})
        outs = [program.to_device(v, o, uploads) if not isinstance(v, torch.Tensor) else v
                for v, o in zip(program.run(list(args), uploads), inner.outputs)]
        return tuple(outs) if len(outs) != 1 else outs[0]

    op_from_graph.program = program     # the inner program (its kernels' launches count in the step)
    return op_from_graph


@torch_funcify.register(RematBarrier)
def _torch_remat_barrier(op, node):
    def remat_barrier(x):
        return x

    return remat_barrier
