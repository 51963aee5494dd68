"""The lowering of ``Scan``: a host loop over the inner graph's compiled
program (the counterpart of ``_jax_scan`` and ``_jax_while_scan`` in
``aesara_tpu/link/jax/scan_dispatch.py``, which lower the loop to one
``lax.scan`` or ``lax.while_loop``).

The inner FunctionGraph is copied and the port's ``FAST_RUN`` rewrites
run on the copy, its elementwise fusion last, the counterpart of XLA
optimizing and fusing inside ``lax.scan``: the body's elementwise chains
become Composites, each one K1 launch a step.  ``BlasOpt`` does not run
there, so a product stays a product and the chain after it stays whole
(config 4's ``tanh(pre + h @ Wh + b)`` is one ``dot`` and one K1 launch,
not a Gemm and a lone tanh).  The rewrites are the outer step's, so
``function(steps_per_call=k)`` computes what k calls compute, bit for bit
where the step's graph holds no product ``BlasOpt`` would fuse.  The Scan
op's own ``fgraph`` stays node for node the JAX package's.  The copy is
lowered once, when the function is compiled, into a
:class:`~aesara_tpu_torch.link.torch.linker.Program`, which the loop
runs once a step:

- sequences are read by row (views);
- a recurrent output's taps are the last rows written: of its stack, or
  of a window of its last ``depth`` states where only the final state or
  a tail is kept;
- a stacked output (recurrent or nit-sot) is written row by row into an
  ``(n_steps, ...)`` buffer made at the first step; a ``final_only``
  output is the last state, a tail depth k the last k rows;
- shared states are carried;
- the inner program frees each step's intermediates after their last
  reader (``config.allow_gc``), so no step's values outlive the next;
- a final-only state of depth 1 whose inner input is read by one
  ``IncSubtensor`` or ``DynamicIncSubtensor`` alone, whose result is the
  state's new value, is owned by the loop: its initial value is copied
  once a call, and that node writes into the owned buffer in place
  (``in_place_writes``), the counterpart of XLA's in-place update of the
  donated carry.  The decoder's KV caches are such states, so a decode
  step writes its K/V rows and copies no cache.

The output shapes are those of the JAX lowering.  With a trip count that
is a host value (computed from shapes and constants, so fixed for a key
of the function) nothing is read from the device, and the linker's CUDA
graph captures the loop unrolled: every step's launches in one graph.  A
trip count computed on the device is read once on the host
(``syncs``), and a while-Scan (``until`` without ``padded_while``) reads
its condition each step and cuts its stacks at the step that made it
true, as ``Scan.perform`` does: both run eagerly and say so
(``TorchFunction.capture_blocker``).  So does a Scan whose body holds a
node that blocks a capture (a mask or a slice bound from data, read each
step; ``linker.inner_blocker``).  ``padded_while`` keeps its done
flag on the device and captures.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.dispatch import torch_funcify
from aesara_tpu_torch.scan.op import Scan


__all__ = ["fused_inner_graph", "in_place_writes"]


def fused_inner_graph(op):
    """A copy of the Scan's inner graph rewritten by the ``FAST_RUN``
    pipeline but ``BlasOpt``, its elementwise chains fused."""
    from aesara_tpu_torch.compile.mode import get_mode

    fgraph = op.fgraph.clone()
    get_mode(None).excluding("BlasOpt").optimizer.rewrite(fgraph)
    return fgraph


def in_place_writes(inner, info) -> dict:
    """{inner node: recurrent state} of the nodes of the rewritten inner
    graph ``inner`` that may write into their state's buffer: the node is
    an ``IN_PLACE_OPS`` node whose ``x`` is the inner input of a
    recurrent state that is final-only (not stacked, no tail) of depth 1,
    it is ``x``'s only client (so ``x`` is no inner output either), and
    its result is the state's new value and no other output (so the
    buffer the next step writes is the one this step wrote, and nothing
    else the loop carries)."""
    from aesara_tpu_torch.link.torch.dispatch import IN_PLACE_OPS

    n_rec = info.n_mit_sot + info.n_sit_sot
    taps = [tuple(t) for t in info.mit_sot_taps] + [(-1,)] * info.n_sit_sot
    found, pos = {}, info.n_seqs
    for i in range(n_rec):
        x = inner.inputs[pos]
        pos += len(taps[i])
        if taps[i] != (-1,) or not info.is_final_only(i) or info.tail_depth(i):
            continue
        clients = inner.clients.get(x, [])
        if len(clients) != 1:
            continue
        node, k = clients[0]
        if (k == 0 and isinstance(getattr(node, "op", None), IN_PLACE_OPS) and inner.outputs[i] is node.outputs[0]
                and sum(o is node.outputs[0] for o in inner.outputs) == 1):
            found[node] = i
    return found


def _host(value) -> bool:
    return isinstance(value, (np.ndarray, np.generic))


@torch_funcify.register(Scan)
def _torch_scan(op, node):
    import torch

    from aesara_tpu_torch.link.torch.linker import Program, inner_blocker

    info = op.info
    inner = fused_inner_graph(op)
    writes = in_place_writes(inner, info)
    program = Program(inner, None, bool(config.allow_gc), in_place=frozenset(writes))
    owned = sorted(set(writes.values()))
    n_rec = info.n_mit_sot + info.n_sit_sot
    depths = [-min(taps) for taps in info.mit_sot_taps] + [1] * info.n_sit_sot
    taps = [tuple(t) for t in info.mit_sot_taps] + [(-1,)] * info.n_sit_sot
    stacked_rec = [not info.is_final_only(i) and not info.tail_depth(i) for i in range(n_rec)]
    nit_types = [o.type for o in inner.outputs[n_rec:n_rec + info.n_nit_sot]]
    # a program's uploads of host values depend on the shapes of its
    # inputs only: one dict for each set of step shapes
    uploads_by_shape: dict = {}

    def scan(n_steps, *operands):
        n = int(n_steps) if _host(n_steps) else int(n_steps.item())
        if n < 0:
            raise ValueError(f"scan n_steps must be non-negative, got {n}")
        pos = 0
        seqs = operands[pos:pos + info.n_seqs]
        pos += info.n_seqs
        inits = operands[pos:pos + n_rec]
        pos += n_rec
        shared = list(operands[pos:pos + info.n_shared])
        pos += info.n_shared
        non_seqs = list(operands[pos:])
        for s in seqs:
            if s.shape[0] < n:
                raise ValueError(f"a sequence of {s.shape[0]} rows is shorter than the {n} steps of {op}")
        device = next((v.device for v in operands if isinstance(v, torch.Tensor)), None)
        program.device = device
        # the loop's own buffers of the states written in place: the
        # caller's value is never written, and a broadcast view (zero
        # strides, ``broadcast_to``) is copied into a dense buffer, so that
        # a write to one row writes that row alone
        inits = [init.clone(memory_format=torch.contiguous_format) if i in owned else init
                 for i, init in enumerate(inits)]

        # per recurrent output: the states its taps read (oldest first),
        # its stack, and its last rows where a tail is kept
        windows = [[init[d] for d in range(depth)] if i < info.n_mit_sot else [init]
                   for i, (init, depth) in enumerate(zip(inits, depths))]
        rec_stacks = [None] * n_rec
        rec_tails = [[] for _ in range(n_rec)]
        nit_stacks = [None] * info.n_nit_sot
        nit_tails = [[] for _ in range(info.n_nit_sot)]
        uploads = None
        executed = n
        for t in range(n):
            args = [s[t] for s in seqs]
            for window, tp, depth in zip(windows, taps, depths):
                args.extend(window[depth + k] for k in tp)
            args += shared + non_seqs
            if uploads is None:
                shapes = tuple((tuple(a.shape), a.dtype) for a in args)
                uploads = uploads_by_shape.setdefault(shapes, {})
            res = [program.to_device(v, o, uploads) if _host(v) else v
                   for v, o in zip(program.run(args, uploads), inner.outputs)]
            for i in range(n_rec):
                v = res[i]
                if stacked_rec[i]:
                    if rec_stacks[i] is None:
                        rec_stacks[i] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                    rec_stacks[i][t].copy_(v)
                    v = rec_stacks[i][t]
                elif info.tail_depth(i):
                    rec_tails[i] = (rec_tails[i] + [v])[-info.tail_depth(i):]
                windows[i] = (windows[i] + [v])[-depths[i]:]
            for j in range(info.n_nit_sot):
                v = res[n_rec + j]
                k = info.nit_tail_depth(j)
                if k:
                    nit_tails[j] = (nit_tails[j] + [v])[-k:]
                    continue
                if nit_stacks[j] is None:
                    nit_stacks[j] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                nit_stacks[j][t].copy_(v)
            shared = res[n_rec + info.n_nit_sot:n_rec + info.n_nit_sot + info.n_shared]
            if info.as_while and bool(res[-1].item()):
                # until(cond): stop after the step that made cond true
                executed = t + 1
                break

        outs = []
        for i in range(n_rec):
            if stacked_rec[i]:
                stack = rec_stacks[i]
                if stack is None:
                    stack = torch.empty((0,) + tuple(inits[i].shape[1:] if i < info.n_mit_sot else inits[i].shape),
                                        dtype=inits[i].dtype, device=device)
                outs.append(stack[:executed])
            elif info.tail_depth(i):
                outs.append(torch.stack(rec_tails[i]))
            else:
                outs.append(windows[i][-1])
        for j in range(info.n_nit_sot):
            if info.nit_tail_depth(j):
                outs.append(torch.stack(nit_tails[j]))
                continue
            stack = nit_stacks[j]
            if stack is None:
                stack = _empty_stack(nit_types[j], device)
            outs.append(stack[:executed])
        outs += shared
        return tuple(outs) if len(outs) != 1 else outs[0]

    scan.program = program     # the inner program (its kernels' launches are counted a step)
    scan.owned = owned         # the states the loop writes in place
    scan.host_inputs = (0,)
    scan.syncs = (0,)
    scan.sync_blocker = "reads its trip count on the host"
    if info.as_while:
        scan.capturable = False
        scan.blocker = "reads its until condition on the host each step"
    elif inner_blocker(program) is not None:
        scan.capturable = False
        scan.blocker = inner_blocker(program)
    return scan


def _empty_stack(out_type, device):
    """The (0, ...) stack of a nit-sot output no step computed: its row
    shape must be static, as no step gives it."""
    import torch

    from aesara_tpu_torch.link.torch.kernels.elemwise import torch_dtype

    if any(d is None for d in out_type.shape):
        raise ValueError(f"a scan of 0 steps cannot give the shape of a nit-sot output of type {out_type}")
    return torch.empty((0,) + tuple(out_type.shape), dtype=torch_dtype(out_type.dtype), device=device)
