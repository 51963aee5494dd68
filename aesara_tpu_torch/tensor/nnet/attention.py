"""Fused scaled-dot-product attention (reference
``aesara_tpu/tensor/nnet/attention.py``).

``FusedAttention`` maps (q, k, v), each (BH, T, D), to
softmax(q kᵀ · scale [+ causal mask]) v with scale = 1/sqrt(D).  Its
``perform`` is the NumPy formula; on the card it lowers to the
hand-written flash forward (``link/torch/kernels/attention.py``).  The
gradient op comes with training.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.graph.ir import Apply
from aesara_tpu_torch.graph.op import Op
from aesara_tpu_torch.tensor.basic import as_tensor_variable
from aesara_tpu_torch.tensor.type import TensorType


__all__ = ["FusedAttention", "fused_attention", "attention_ref_numpy"]


def attention_ref_numpy(q, k, v, causal: bool, scale: float):
    """softmax(q kᵀ · scale [+ causal mask]) v over (BH, T, D) panels."""
    s = np.einsum("btd,bsd->bts", q, k) * scale
    if causal:
        T = q.shape[1]
        s = np.where(np.tril(np.ones((T, T), dtype=bool))[None], s, -np.inf)
    p = np.exp(s - np.max(s, axis=-1, keepdims=True))
    p = p / np.sum(p, axis=-1, keepdims=True)
    return np.einsum("bts,bsd->btd", p, v)


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
        output_storage[0][0] = np.asarray(res, dtype=node.outputs[0].type.dtype)


def fused_attention(q, k, v, causal: bool = False):
    """Scaled-dot-product attention over (batch*heads, T, d_head) panels."""
    return FusedAttention(causal)(q, k, v)
