"""Content keys of graphs, for the linker's memo of lowered programs (a
copy of ``aesara_tpu/link/cache.py``, which the port cannot import).

Two FunctionGraphs with the same key compute the same function of their
inputs by position: the same ops (by type and props), the same wiring,
the same variable types and the same constants.  ``TorchLinker`` lowers
a graph once per key and device, so a second function of an identical
graph reuses the lowering and its generated kernels.

Two departures from the JAX package's copy: a constant is hashed by all of
its bytes (the JAX package hashes only the shape of one over 65,536
entries, so two graphs differing in such a constant share a key), a
``Composite`` by its scalar graph (the port's Composite has no ``fgraph``),
and a ``Scan`` by its inner graph.
"""

from __future__ import annotations

import hashlib

import numpy as np

from aesara_tpu_torch.graph.ir import Constant, io_toposort


__all__ = ["fgraph_key"]


def _graph_key(inputs, nodes, outputs) -> str:
    """The key of the graph from ``inputs`` through ``nodes`` (in
    topological order) to ``outputs``: ops, variable types, constant
    payloads and the wiring."""
    h = hashlib.sha256()
    index: dict = {}

    def vid(var) -> str:
        if var not in index:
            index[var] = f"v{len(index)}"
        return index[var]

    def constant(var):
        data = np.asarray(var.data)
        h.update(f"const:{var.type}:{data.shape}:".encode())
        h.update(np.ascontiguousarray(data).tobytes())

    for i, inp in enumerate(inputs):
        h.update(f"in{i}:{vid(inp)}:{inp.type}".encode())
    for node in nodes:
        h.update(_op_key(node.op).encode())
        for inp in node.inputs:
            if isinstance(inp, Constant):
                constant(inp)
            else:
                h.update(vid(inp).encode())
        for out in node.outputs:
            h.update(f"->{vid(out)}:{out.type}".encode())
    for i, out in enumerate(outputs):
        h.update(f"out{i}:".encode())
        # a constant output passes through no node's inputs above
        if isinstance(out, Constant):
            constant(out)
        else:
            h.update(vid(out).encode())
    return h.hexdigest()


def fgraph_key(fgraph) -> str:
    """The content key of a FunctionGraph."""
    return _graph_key(fgraph.inputs, fgraph.toposort(), fgraph.outputs)


def _prop_key(v) -> str:
    from aesara_tpu_torch.graph.op import Op
    from aesara_tpu_torch.scalar.ops import ScalarOp

    if isinstance(v, (Op, ScalarOp)):
        return _op_key(v)   # ops nested in props (Elemwise.scalar_op, ...)
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_prop_key(e) for e in v) + ")"
    return repr(v)


def _op_key(op) -> str:
    from aesara_tpu_torch.scalar.composite import Composite

    base = f"{type(op).__module__}.{type(op).__name__}"
    props = getattr(op, "__props__", None)
    if props:
        base += "(" + ",".join(_prop_key(getattr(op, p, None)) for p in props) + ")"
    if isinstance(op, Composite):
        # by its scalar graph: display names alias across distinct graphs
        base += _graph_key(op.inputs, io_toposort(op.inputs, op.outputs), op.outputs)
    inner = getattr(op, "fgraph", None)
    if inner is not None:
        # an op with an inner graph (Scan, OpFromGraph): by its structure
        # and that graph
        base += f"{getattr(op, 'info', '')}:{getattr(op, 'truncate_gradient', '')}:" + fgraph_key(inner)
    return base
