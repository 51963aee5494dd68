"""``TorchLinker``: runs a rewritten FunctionGraph as one Python callable
over torch tensors on one device (the counterpart of ``fgraph_to_jax``
and ``JAXLinker``, ``aesara_tpu/link/jax/linker.py:38-212``).

Every Apply becomes the plain function ``torch_funcify`` gives for it;
the callable runs them in topological order under ``torch.no_grad()``.

Host folding: as the JAX linker folds every node whose inputs are all
concrete through its NumPy ``perform``, this one runs ``perform`` for
every node whose inputs are all host values (constants, ``Shape_i``
results and what is computed from them).  Shape arithmetic
(``Shape_i`` → ``MakeVector`` → ``Reshape``) therefore stays on the host
and never makes the device wait.  A host value that meets a device node
is copied to the device, except at the positions a lowering keeps on the
host (``host_inputs``, e.g. the target shape of ``Reshape``).

Sparse values (the counterpart of ``linker.py:296-402,414-469``): a
sparse argument or shared variable, a SciPy matrix on the host, crosses to
the device as a :class:`~aesara_tpu_torch.link.torch.csr.CSRMat`, with the
CSR of its transpose when the graph transposes it
(``sparse_dispatch.csr_plan``).  The upload is memoized per input by the
identity of the value object, so a shared matrix is uploaded once and
again after ``set_value``.  A sparse output goes back to SciPy with
exactly the device value's pattern.

There is no fallback: an op with no lowering raises when the function is
compiled.  Dtypes are kept exactly; the card has fp64 and int64, so there
is no 64→32 canonicalisation.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.graph.utils import MethodNotDefined
from aesara_tpu_torch.link.basic import resolve_device


__all__ = ["TorchLinker", "fgraph_to_torch"]


def _is_host(value) -> bool:
    return isinstance(value, (np.ndarray, np.generic))


def fgraph_to_torch(fgraph, device, n_user_inputs: int) -> Callable:
    """Compose per-node lowerings into ``fn(*user_inputs) -> tuple``;
    the graph inputs after the first ``n_user_inputs`` are shared
    variables, read at every call."""
    import torch

    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.dispatch import torch_funcify
    from aesara_tpu_torch.link.torch.kernels.elemwise import torch_dtype
    from aesara_tpu_torch.link.torch.sparse_dispatch import csr_plan

    plan = csr_plan(fgraph)
    order = fgraph.toposort()
    fns = [torch_funcify(node.op, node=node) for node in order]
    foldable = [node.op.do_constant_folding(fgraph, node) for node in order]
    host_inputs = [frozenset(getattr(fn, "host_inputs", ())) for fn in fns]
    user_inputs = fgraph.inputs[:n_user_inputs]
    shared_inputs = fgraph.inputs[n_user_inputs:]
    device_constants: dict = {}
    csr_memo: dict = {}

    def host_to_device(value):
        value = np.asarray(value)
        if value.size == 1:
            # a fill kernel takes the value as an argument: unlike a copy
            # from pageable memory, it does not make the host wait for the
            # work already queued on the device
            return torch.full(value.shape, value.item(), dtype=torch_dtype(value.dtype.name),
                              device=device)
        return torch.as_tensor(value, device=device)

    def to_device(value, var):
        if isinstance(var, Constant):
            if var not in device_constants:
                device_constants[var] = host_to_device(value)
            return device_constants[var]
        return host_to_device(value)

    def to_csr(pos, var, value):
        """A sparse input as a CSRMat on the device, uploaded once per value
        object."""
        hit = csr_memo.get(pos)
        if hit is None or hit[0] is not value:
            csr = CSRMat.from_scipy(var.type.filter(value), device, with_transpose=plan[pos]["transpose"])
            hit = csr_memo[pos] = (value, csr)
        return hit[1]

    def admit(pos, var, value):
        """A user argument as a tensor (a CSRMat when sparse) on the device,
        checked against the variable's type."""
        if plan[pos] is not None:
            return to_csr(pos, var, value)
        if isinstance(value, torch.Tensor):
            if value.device != device:
                raise ValueError(f"input {var} is on {value.device}; this function runs on {device}")
            if value.dtype != torch_dtype(var.type.dtype):
                raise TypeError(f"input {var} has dtype {value.dtype}, expected {var.type.dtype}")
            var.type.check_shape(tuple(value.shape))
            return value
        return torch.as_tensor(np.asarray(var.type.filter(value), order="C"), device=device)

    def run(*args):
        env = {}
        for pos, (var, value) in enumerate(zip(user_inputs, args)):
            env[var] = admit(pos, var, value)
        for pos, var in enumerate(shared_inputs, start=n_user_inputs):
            value = var.value
            where = value.device if plan[pos] is None else var.device
            if where != device:
                raise ValueError(f"shared variable {var} lives on {where}; "
                                 f"this function runs on {device}")
            env[var] = value if plan[pos] is None else to_csr(pos, var, value)
        with torch.no_grad():
            for node, fn, fold, keep in zip(order, fns, foldable, host_inputs):
                ins = [env[i] if i in env else i.data for i in node.inputs]
                if fold and all(_is_host(a) for a in ins):
                    storage = [[None] for _ in node.outputs]
                    try:
                        node.op.perform(node, ins, storage)
                    except MethodNotDefined:
                        storage = None
                    if storage is not None:
                        for o, s in zip(node.outputs, storage):
                            env[o] = np.asarray(s[0])
                        continue
                ins = [a if (k in keep or not _is_host(a)) else to_device(a, i)
                       for k, (a, i) in enumerate(zip(ins, node.inputs))]
                outs = fn(*ins)
                if len(node.outputs) == 1:
                    outs = (outs,)
                for o, v in zip(node.outputs, outs):
                    env[o] = v
        results = []
        for o in fgraph.outputs:
            v = env[o] if o in env else o.data
            if isinstance(v, CSRMat):
                v = v.to_scipy(o.type.format)
            results.append(to_device(v, o) if _is_host(v) else v)
        return tuple(results)

    return run


class TorchLinker:
    """Links a FunctionGraph to a callable on ``device`` (a
    ``torch.device`` or its name; None means ``config.device`` when the
    function is compiled)."""

    def __init__(self, device=None):
        self.device = device

    def make_function(self, fgraph, n_user_inputs: int) -> Callable:
        import torch

        device = resolve_device(self.device)
        if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            # Dot must be a full-fp32 product, as in the reference; the
            # process-wide switch is the caller's to set, not the linker's
            raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: Dot would round "
                               "its fp32 inputs to TF32; set it to False before compiling")
        return fgraph_to_torch(fgraph, device, n_user_inputs)

    def __str__(self):
        return f"TorchLinker(device={self.device})"
