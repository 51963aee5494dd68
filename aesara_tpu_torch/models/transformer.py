"""Transformer encoder layer built from the symbolic primitives
(reference ``aesara_tpu/models/transformer.py:24-108``, without tensor
parallelism): multi-head attention through ``fused_attention``, layer
norm from elemwise and reduce primitives."""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.misc.safe_asarray import _asarray
from aesara_tpu_torch.models.base import Model, glorot, zeros
from aesara_tpu_torch.tensor import math as tm


def layer_norm(x, gain, bias, eps: float = 1e-5):
    mu = tm.mean(x, axis=-1, keepdims=True)
    var = tm.mean(tm.sqr(x - mu), axis=-1, keepdims=True)
    return gain * (x - mu) / tm.sqrt(var + eps) + bias


class TransformerEncoderLayer(Model):
    """Pre-LN encoder layer: x + MHA(LN(x)), then x + FFN(LN(x)).

    Input (B, T, D); heads split D."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, seed: int = 0):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of n_heads {n_heads}")
        rng = np.random.default_rng(seed)
        self.d_model, self.n_heads = d_model, n_heads
        self.d_head = d_model // n_heads
        self.wq = self._register(glorot(rng, d_model, d_model, "wq"))
        self.wk = self._register(glorot(rng, d_model, d_model, "wk"))
        self.wv = self._register(glorot(rng, d_model, d_model, "wv"))
        self.wo = self._register(glorot(rng, d_model, d_model, "wo"))
        self.w1 = self._register(glorot(rng, d_model, d_ff, "w1"))
        self.b1 = self._register(zeros((d_ff,), "b1"))
        self.w2 = self._register(glorot(rng, d_ff, d_model, "w2"))
        self.b2 = self._register(zeros((d_model,), "b2"))
        self.ln1_g = self._register(zeros((d_model,), "ln1_g"))
        self.ln1_b = self._register(zeros((d_model,), "ln1_b"))
        self.ln2_g = self._register(zeros((d_model,), "ln2_g"))
        self.ln2_b = self._register(zeros((d_model,), "ln2_b"))
        # gains start at 1
        self.ln1_g.set_value(_asarray(np.ones(d_model), self.ln1_g.type.dtype))
        self.ln2_g.set_value(_asarray(np.ones(d_model), self.ln2_g.type.dtype))

    def _split_heads(self, x, B, T):
        # (B, T, D) -> (H*B, T, d_head), head-major
        h = x.reshape((B, T, self.n_heads, self.d_head))
        h = h.dimshuffle(2, 0, 1, 3)
        return h.reshape((self.n_heads * B, T, self.d_head))

    def attention(self, x, causal: bool = False):
        from aesara_tpu_torch.tensor.nnet.attention import fused_attention

        B, T = x.shape[0], x.shape[1]
        q = self._split_heads(tm.dot(x, self.wq), B, T)
        k = self._split_heads(tm.dot(x, self.wk), B, T)
        v = self._split_heads(tm.dot(x, self.wv), B, T)
        ctx = fused_attention(q, k, v, causal=causal)       # (H*B, T, d_head)
        ctx = ctx.reshape((self.n_heads, B, T, self.d_head))
        ctx = ctx.dimshuffle(1, 2, 0, 3).reshape((B, T, self.d_model))
        return tm.dot(ctx, self.wo)

    def __call__(self, x):
        h = x + self.attention(layer_norm(x, self.ln1_g, self.ln1_b))
        z = layer_norm(h, self.ln2_g, self.ln2_b)
        ffn = tm.dot(tm.maximum(tm.dot(z, self.w1) + self.b1, 0.0), self.w2) + self.b2
        return h + ffn

    def loss(self, x):
        """Mean-square activation magnitude: a smoke-train objective."""
        return tm.mean(tm.sqr(self(x)))
