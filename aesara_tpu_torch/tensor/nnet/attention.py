"""Fused scaled-dot-product attention (reference
``aesara_tpu/tensor/nnet/attention.py``).

``FusedAttention`` maps (q, k, v), each (BH, T, D), to
softmax(q kᵀ · scale [+ causal mask]) v with scale = 1/sqrt(D).  Its
gradient is one ``FusedAttentionGrad`` node, (q, k, v, dout) → (dq, dk,
dv).  Each op's ``perform`` is the NumPy formula; on the card they lower
to the hand-written flash forward and backward
(``link/torch/kernels/attention.py``).
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.scalar.ops import to_host
from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["FusedAttention", "FusedAttentionGrad", "fused_attention", "attention_ref_numpy",
           "attention_grads_ref_numpy"]


def _probs(q, k, causal: bool, scale: float):
    s = np.einsum("btd,bsd->bts", q, k) * scale
    if causal:
        T = q.shape[1]
        s = np.where(np.tril(np.ones((T, T), dtype=bool))[None], s, -np.inf)
    p = np.exp(s - np.max(s, axis=-1, keepdims=True))
    return p / np.sum(p, axis=-1, keepdims=True)


def attention_ref_numpy(q, k, v, causal: bool, scale: float):
    """softmax(q kᵀ · scale [+ causal mask]) v over (BH, T, D) panels."""
    return np.einsum("bts,bsd->btd", _probs(q, k, causal, scale), v)


def attention_grads_ref_numpy(q, k, v, do, causal: bool, scale: float):
    """(dq, dk, dv) of ``attention_ref_numpy`` for the output gradient
    ``do``: with P the probabilities, dV = Pᵀ dO, dS = P ⊙ (dO Vᵀ − D)
    where D = rowsum(dO ⊙ O), dQ = scale · dS K, dK = scale · dSᵀ Q."""
    p = _probs(q, k, causal, scale)
    o = np.einsum("bts,bsd->btd", p, v)
    dv = np.einsum("bts,btd->bsd", p, do)
    ds = p * (np.einsum("btd,bsd->bts", do, v) - np.sum(do * o, axis=-1, keepdims=True))
    dq = np.einsum("bts,bsd->btd", ds, k) * scale
    dk = np.einsum("bts,btd->bsd", ds, q) * scale
    return dq, dk, dv


class FusedAttention(Op):
    """(q, k, v) each (BH, T, D) → (BH, T, Dv)."""

    __props__ = ("causal",)

    def __init__(self, causal: bool = False):
        self.causal = bool(causal)

    def make_node(self, q, k, v):
        q, k, v = (as_tensor_variable(a) for a in (q, k, v))
        if not (q.type.ndim == k.type.ndim == v.type.ndim == 3):
            raise TypeError("fused_attention expects (batch*heads, T, D) 3-d q, k, v")
        out_shape = (q.type.shape[0], q.type.shape[1], v.type.shape[2])
        return Apply(self, [q, k, v], [TensorType(q.type.dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        q, k, v = inputs
        res = attention_ref_numpy(q, k, v, self.causal, 1.0 / float(np.sqrt(q.shape[-1])))
        output_storage[0][0] = to_host(res, node.outputs[0].type.dtype)

    def L_op(self, inputs, outputs, output_grads):
        return FusedAttentionGrad(self.causal)(*inputs, output_grads[0])


class FusedAttentionGrad(Op):
    """(q, k, v, dout) → (dq, dk, dv), the gradient of FusedAttention.  It
    takes no saved forward state: the kernel recomputes what it needs."""

    __props__ = ("causal",)

    def __init__(self, causal: bool = False):
        self.causal = bool(causal)

    def make_node(self, q, k, v, gz):
        q, k, v, gz = (as_tensor_variable(a) for a in (q, k, v, gz))
        if not all(a.type.ndim == 3 for a in (q, k, v, gz)):
            raise TypeError("FusedAttentionGrad expects 3-d (batch*heads, T, D) q, k, v and dout")
        return Apply(self, [q, k, v, gz], [q.type(), k.type(), v.type()])

    def perform(self, node, inputs, output_storage):
        q, k, v, gz = inputs
        grads = attention_grads_ref_numpy(q, k, v, gz.astype(q.dtype), self.causal,
                                          1.0 / float(np.sqrt(q.shape[-1])))
        for storage, g, var in zip(output_storage, grads, node.outputs):
            storage[0] = to_host(g, var.type.dtype)


def fused_attention(q, k, v, causal: bool = False):
    """Scaled-dot-product attention over (batch*heads, T, d_head) panels."""
    return FusedAttention(causal)(q, k, v)
