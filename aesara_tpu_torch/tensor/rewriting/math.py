"""Algebraic rewrites of the optimizers' graphs (the counterparts of
``local_pow_specialize`` and ``local_useless_switch`` in
``aesara_tpu/tensor/rewriting/math.py:692,1059``):

- ``local_pow_specialize`` (specialize): ``pow`` by the constant 2, 0.5,
  -1, -0.5 or -2 becomes ``sqr``, ``sqrt`` or a division, one cheap
  op in place of libdevice's ``pow``.
- ``local_useless_switch`` (canonicalize): ``switch(c, x, x)`` is x
  broadcast against c, and a switch on a constant condition is the
  branch it takes.
- ``local_sumsqr2dot`` (specialize, ``math.py:1286``): the full sum of a
  square, ``sum(sqr(x))``, is ``dot(x.flatten(), x.flatten())``, one
  product in place of a square and a reduction (the AdamW clip's global
  norm).
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.mode import register_canonicalize, register_specialize
from aesara_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.scalar.ops import discrete_dtypes
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import cast, constant, zeros_like
from aesara_tpu_torch.tensor.elemwise import Elemwise
from aesara_tpu_torch.tensor.rewriting.basic import _const_val, _keep_type


def _is_elemwise(node, scalar_cls) -> bool:
    return isinstance(node.op, Elemwise) and isinstance(node.op.scalar_op, scalar_cls)


@node_rewriter([Elemwise])
def local_pow_specialize(fgraph, node):
    """pow(x, 2) → sqr(x); pow(x, 0.5) → sqrt(x); pow(x, -1) → 1 / x;
    pow(x, -0.5) → 1 / sqrt(x); pow(x, -2) → 1 / sqr(x)"""
    if not _is_elemwise(node, aes.Pow):
        return False
    x, p = node.inputs
    v = _const_val(p)
    out = node.outputs[0]
    if v is None or (out.type.dtype in discrete_dtypes and float(v) < 0):
        return False
    v = float(v)
    one = constant(1, dtype="int8")
    table = {2.0: lambda: tm.sqr(x), 0.5: lambda: tm.sqrt(x), -1.0: lambda: tm.true_div(one, x),
             -0.5: lambda: tm.true_div(one, tm.sqrt(x)), -2.0: lambda: tm.true_div(one, tm.sqr(x))}
    if v not in table:
        return False
    res = _keep_type(out, table[v]())
    return False if res is None else [copy_stack_trace(out, res)]


@node_rewriter([Elemwise])
def local_useless_switch(fgraph, node):
    """switch(c, x, x) → x (broadcast against c); switch(constant, a, b)
    → the branch the constant picks"""
    if not _is_elemwise(node, aes.Switch):
        return False
    cond, ift, iff = node.inputs
    out = node.outputs[0]
    if ift is iff:
        res = ift + zeros_like(cond, dtype=ift.type.dtype)
    else:
        v = _const_val(cond)
        if v is None:
            return False
        res = ift if np.all(v) else iff
    res = _keep_type(out, res)
    return False if res is None else [copy_stack_trace(out, res)]


register_specialize(local_pow_specialize)
register_canonicalize(local_useless_switch)


@node_rewriter([tm.Sum])
def local_sumsqr2dot(fgraph, node):
    """sum(sqr(x)) over every axis → dot(x.flatten(), x.flatten()), where
    the square has no other reader and the sum accumulates in no wider a
    type than x's (bf16 and f16 products accumulate in f32)."""
    inner = node.inputs[0].owner
    if (node.op.axis is not None or inner is None or not _is_elemwise(inner, aes.Sqr)
            or len(fgraph.clients.get(node.inputs[0], ())) != 1):
        return False
    x = inner.inputs[0]
    if x.type.dtype in discrete_dtypes or x.type.ndim == 0:
        return False
    out = node.outputs[0]
    out_dt = np.dtype(out.type.dtype)
    acc_dt = np.dtype(node.op.acc_dtype) if node.op.acc_dtype else out_dt
    x_dt = np.dtype(x.type.dtype)
    eff_acc = 4 if x.type.dtype in ("float16", "bfloat16") else x_dt.itemsize
    if out_dt.itemsize > x_dt.itemsize or acc_dt.itemsize > eff_acc:
        return False
    flat = x.flatten()
    res = tm.dot(flat, flat)
    if res.type.dtype != out.type.dtype:
        res = cast(res, out.type.dtype)
    conv = out.type.convert_variable(res)
    return False if conv is None else [copy_stack_trace(out, conv)]


register_specialize(local_sumsqr2dot)
