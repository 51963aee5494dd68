"""Multi-layer perceptron (reference ``aesara_tpu/models/mlp.py``): dense
layers with ``tanh``, ``relu`` or ``sigmoid`` between them, and the mean
negative log-likelihood of integer targets through ``log_softmax`` (K4)
and advanced indexing."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from aesara_tpu_torch.models.base import Model, glorot, zeros
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import arange
from aesara_tpu_torch.tensor.special import log_softmax


__all__ = ["MLP"]


class MLP(Model):
    def __init__(self, n_in: int, hidden: Sequence[int], n_out: int, activation: str = "tanh", seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.activation = {"tanh": tm.tanh, "relu": lambda v: tm.maximum(v, 0.0),
                           "sigmoid": tm.sigmoid}[activation]
        dims = [n_in] + list(hidden) + [n_out]
        self.ws, self.bs = [], []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.ws.append(self._register(glorot(rng, a, b, f"w{i}")))
            self.bs.append(self._register(zeros((b,), f"b{i}")))

    def logits(self, x):
        h = x
        for i, (w, b) in enumerate(zip(self.ws, self.bs)):
            h = tm.dot(h, w) + b
            if i < len(self.ws) - 1:
                h = self.activation(h)
        return h

    def predict(self, x):
        return tm.argmax(self.logits(x), axis=1)

    def loss(self, x, y):
        logp = log_softmax(self.logits(x), axis=-1)
        return -tm.mean(logp[arange(y.shape[0]), y])
