"""The lowerings of ``IfElse``, ``CheckAndRaise``, ``Print``,
``OpFromGraph`` and ``RematBarrier`` (the counterparts of those in
``aesara_tpu/link/jax/control_dispatch.py``).

``IfElse`` picks its branch when the function is compiled where its
condition is a ``Constant`` (the JAX lowering picks it when it traces),
and on the host at the call where the condition is another host value of
the linker (computed from shapes, which a key fixes, as ``jax.jit`` makes
them concrete).  Otherwise it selects on the device with ``torch.where``
over the 0-d condition: no host read, so the step stays capturable, and
both branches are computed before, as under ``lax.cond``.  Branches of
different shapes are refused there, as ``lax.cond`` refuses them: when
the function is compiled where both static shapes are known, else at the
call, from the tensors' shapes.

``CheckAndRaise`` checks every condition that is a host value on every
call (a constant or one computed from shapes; the JAX lowering checks the
concrete ones) and raises ``op.exc_type(op.msg)`` when one is false; a
condition on the device is passed over unread, as the JAX lowering does.

``Print`` prints ``message`` and the value on every call, as
``jax.debug.print(message + " {}", x)`` prints it.  It reads the value on
the host, so a function that holds one runs eagerly
(``capturable = False``) and names it in its ``capture_blocker``.

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

import numpy as np

from aesara_tpu_torch.compile.builders import OpFromGraph, RematBarrier
from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.ifelse import IfElse
from aesara_tpu_torch.link.torch.dispatch import torch_funcify
from aesara_tpu_torch.printing import Print
from aesara_tpu_torch.raise_op import CheckAndRaise


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


def _branches(n: int, args, true: bool):
    taken = args[:n] if true else args[n:]
    return taken[0] if n == 1 else tuple(taken)


@torch_funcify.register(IfElse)
def _torch_ifelse(op, node):
    import torch

    n = op.n_outs
    cond = node.inputs[0]
    if isinstance(cond, Constant):
        true = bool(np.asarray(cond.data))

        def ifelse_constant(cond, *args):
            return _branches(n, args, true)

        return ifelse_constant
    pairs = list(zip(node.inputs[1:1 + n], node.inputs[1 + n:]))
    for t, f in pairs:
        if None not in t.type.shape and None not in f.type.shape and t.type.shape != f.type.shape:
            raise ValueError(f"{op}: the branches' shapes differ ({t.type.shape} vs {f.type.shape}) under a "
                             "condition on the device, which lax.cond refuses too")

    def ifelse(cond, *args):
        if isinstance(cond, (np.ndarray, np.generic)):
            return _branches(n, args, bool(cond))
        for t, f in zip(args[:n], args[n:]):
            if t.shape != f.shape:
                raise ValueError(f"{op}: the branches' shapes differ ({tuple(t.shape)} vs {tuple(f.shape)}) under "
                                 "a condition on the device, which lax.cond refuses too")
        take = cond.bool()
        outs = [torch.where(take, t, f) for t, f in zip(args[:n], args[n:])]
        return outs[0] if n == 1 else tuple(outs)

    ifelse.host_inputs = (0,)
    return ifelse


@torch_funcify.register(CheckAndRaise)
def _torch_check_and_raise(op, node):
    def check_and_raise(value, *conds):
        for c in conds:
            # a condition on the device passes unread, as under XLA
            if isinstance(c, (np.ndarray, np.generic)) and not np.all(c):
                raise op.exc_type(op.msg)
        return value

    check_and_raise.host_inputs = tuple(range(1, len(node.inputs)))
    return check_and_raise


@torch_funcify.register(Print)
def _torch_print(op, node):
    from aesara_tpu_torch.scalar.ops import to_host

    dtype = node.inputs[0].type.dtype

    def print_op(x):
        print(f"{op.message} {to_host(x, dtype)}")
        return x

    print_op.capturable = False
    print_op.blocker = "Print prints on the host"
    return print_op
