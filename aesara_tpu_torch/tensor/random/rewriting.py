"""Random-variable rewrites (the counterpart of
``aesara_tpu/tensor/random/rewriting.py:46-218``): ``local_rv_size_lift``,
``local_dimshuffle_rv_lift`` and ``local_subtensor_rv_lift`` in
``random_rewrites_db`` (opt-in, as there: the lifts change which bits a
draw reads), and ``local_remove_useless_specify_shape_rv`` in
``FAST_RUN`` at optdb position 48.9.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import optdb
from aesara_tpu_torch.graph.ir import Constant
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, in2out, node_rewriter
from aesara_tpu_torch.graph.rewriting.db import LocalGroupDB
from aesara_tpu_torch.tensor.basic import as_tensor_variable, constant
from aesara_tpu_torch.tensor.elemwise import DimShuffle
from aesara_tpu_torch.tensor.random.op import RandomVariable
from aesara_tpu_torch.tensor.shape import SpecifyShape
from aesara_tpu_torch.tensor.subtensor import AdvancedSubtensor, AdvancedSubtensor1, Subtensor


__all__ = ["local_rv_size_lift", "local_dimshuffle_rv_lift", "local_subtensor_rv_lift",
           "local_remove_useless_specify_shape_rv", "random_rewrites_db"]


def _is_empty_size(size_var) -> bool:
    from aesara_tpu_torch.tensor.basic import get_vector_length

    try:
        return get_vector_length(size_var) == 0
    except ValueError:
        return False


@node_rewriter([RandomVariable])
def local_rv_size_lift(fgraph, node):
    """An explicit ``size`` that restates the broadcast of the params'
    batch shapes becomes the implicit form (``size=()``)."""
    op = node.op
    rng, size, *params = node.inputs
    if _is_empty_size(size):
        return False
    out_shape = node.outputs[1].type.shape
    if any(s is None for s in out_shape):
        return False
    batch = out_shape[: len(out_shape) - op.ndim_supp]
    dims = [p.type.shape[: p.type.ndim - nd] if p.type.ndim > nd else () for p, nd in zip(params, op.ndims_params)]
    if not dims:
        return False
    maxlen = max((len(d) for d in dims), default=0)
    if maxlen != len(batch):
        return False
    bc = []
    for i in range(maxlen):
        vals = []
        for d in dims:
            off = maxlen - len(d)
            if i >= off:
                v = d[i - off]
                if v is None:
                    return False
                vals.append(v)
        known = [v for v in vals if v != 1]
        bc.append(known[0] if known else 1)
    if tuple(bc) != tuple(batch):
        return False
    new_out = op.make_node(rng, constant(np.asarray([], dtype="int64")), *params)
    copy_stack_trace(node.outputs[1], new_out.outputs[1])
    return dict(zip(node.outputs, new_out.outputs))


@node_rewriter([DimShuffle])
def local_dimshuffle_rv_lift(fgraph, node):
    """A pure transpose of a scalar-support draw with scalar params becomes
    a permuted ``size``: the draw is made in the transposed layout."""
    rv_out = node.inputs[0]
    rv_node = rv_out.owner
    if rv_node is None or not isinstance(rv_node.op, RandomVariable):
        return False
    rv_op = rv_node.op
    if rv_op.ndim_supp != 0:
        return False
    order = node.op.new_order
    if any(o == "x" for o in order) or sorted(order) != list(range(len(order))):
        return False
    rng, size, *params = rv_node.inputs
    if _is_empty_size(size):
        return False
    if any(p.type.ndim != 0 for p in params):
        return False
    if len(fgraph.clients.get(rv_out, [])) > 1:
        return False
    # a constant size permutes on the host, so the new draw keeps its
    # static shape (the replacement must keep the output's type)
    if isinstance(size, Constant):
        perm_size = constant(np.asarray(size.data)[list(order)])
    else:
        perm_size = as_tensor_variable([size[i] for i in order])
    new_node = rv_op.make_node(rng, perm_size, *params)
    copy_stack_trace(node.outputs[0], new_node.outputs[1])
    return {node.outputs[0]: new_node.outputs[1], rv_node.outputs[0]: new_node.outputs[0]}


@node_rewriter([Subtensor, AdvancedSubtensor1, AdvancedSubtensor])
def local_subtensor_rv_lift(fgraph, node):
    """Draw only the indexed part: ``normal(mu, sd)[i]`` becomes
    ``normal(mu[i], sd[i])`` for a draw over its params' batch dims (a
    boolean mask of batch dims too)."""
    rv_out = node.inputs[0]
    rv_node = rv_out.owner
    if rv_node is None or not isinstance(rv_node.op, RandomVariable):
        return False
    rv_op = rv_node.op
    if rv_op.ndim_supp != 0:
        return False
    rng, size, *params = rv_node.inputs
    if not _is_empty_size(size):
        return False
    if len(fgraph.clients.get(rv_out, [])) > 1:
        return False
    batch_ndim = max((p.type.ndim - nd for p, nd in zip(params, rv_op.ndims_params)), default=0)
    if batch_ndim == 0:
        return False
    sub_op = node.op
    if isinstance(sub_op, AdvancedSubtensor1):
        idx, consumed = (node.inputs[1],), 1
    elif isinstance(sub_op, AdvancedSubtensor):
        if len(node.inputs) != 2:
            return False
        mask = node.inputs[1]
        if mask.type.dtype != "bool":
            return False
        idx, consumed = (mask,), mask.type.ndim
    else:
        from aesara_tpu_torch.tensor.subtensor import indices_from_subtensor

        idx = tuple(indices_from_subtensor(node.inputs[1:], sub_op.idx_list))
        consumed = len(idx)
    if consumed > batch_ndim:
        return False
    new_params = []
    for p, nd in zip(params, rv_op.ndims_params):
        if p.type.ndim - nd == batch_ndim:
            new_params.append(p[idx])
        elif p.type.ndim - nd == 0:
            new_params.append(p)
        else:
            return False
    new_node = rv_op.make_node(rng, constant(np.asarray([], dtype="int64")), *new_params)
    copy_stack_trace(node.outputs[0], new_node.outputs[1])
    return {node.outputs[0]: new_node.outputs[1], rv_node.outputs[0]: new_node.outputs[0]}


@node_rewriter([SpecifyShape])
def local_remove_useless_specify_shape_rv(fgraph, node):
    """A SpecifyShape of a draw whose static shape already proves it."""
    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, RandomVariable):
        return False
    out = node.outputs[0]
    if x.type.shape != out.type.shape or any(s is None for s in x.type.shape):
        return False
    copy_stack_trace(out, x)
    return {out: x}


random_rewrites_db = LocalGroupDB()
random_rewrites_db.name = "random_rewrites_db"
random_rewrites_db.register("local_rv_size_lift", local_rv_size_lift, "basic")
random_rewrites_db.register("local_dimshuffle_rv_lift", local_dimshuffle_rv_lift, "basic")
random_rewrites_db.register("local_subtensor_rv_lift", local_subtensor_rv_lift, "basic")

optdb.register("local_remove_useless_specify_shape_rv",
               in2out(local_remove_useless_specify_shape_rv, name="local_remove_useless_specify_shape_rv"),
               "fast_run", "random", position=48.9)
