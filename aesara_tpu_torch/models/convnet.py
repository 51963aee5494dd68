"""Small conv net (the counterpart of ``aesara_tpu/models/convnet.py``:
the tutorial LeNet, conv -> ReLU -> max-pool stages and a dense
classifier).  Convolutions run on cuDNN and pooling over ``unfold`` views
(``link/torch/nnet_dispatch.py``); ReLU and its gradient fuse into K1, the
log-softmax is K4."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import shared
from aesara_tpu_torch.config import config
from aesara_tpu_torch.misc.safe_asarray import _asarray
from aesara_tpu_torch.models.base import Model, glorot, zeros
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import arange
from aesara_tpu_torch.tensor.nnet.abstract_conv import conv2d
from aesara_tpu_torch.tensor.nnet.pool import pool_2d
from aesara_tpu_torch.tensor.special import log_softmax


__all__ = ["ConvNet"]


class ConvNet(Model):
    """conv(3x3, "half") -> ReLU -> max-pool(2) stages, then a dense
    classifier; NCHW input.  Parameters ``f0``, ``f1``, ..., ``w_out``,
    ``b_out``."""

    def __init__(self, in_channels: int, image_hw: Tuple[int, int], channels: Sequence[int], n_out: int,
                 seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.filters = []
        c_prev = in_channels
        h, w = image_hw
        for i, c in enumerate(channels):
            fan_in, fan_out = c_prev * 9, c * 9
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            f = _asarray(rng.uniform(-limit, limit, size=(c, c_prev, 3, 3)), config.floatX)
            self.filters.append(self._register(shared(f, name=f"f{i}")))
            c_prev = c
            h, w = h // 2, w // 2  # a "half" conv keeps HW; the pool halves it
        self.flat_dim = c_prev * h * w
        self.w_out = self._register(glorot(rng, self.flat_dim, n_out, "w_out"))
        self.b_out = self._register(zeros((n_out,), "b_out"))

    def logits(self, x):
        h = x
        for f in self.filters:
            h = conv2d(h, f, border_mode="half")
            h = tm.maximum(h, 0.0)
            h = pool_2d(h, ws=(2, 2), ignore_border=True)
        flat = h.reshape((h.shape[0], self.flat_dim))
        return tm.dot(flat, self.w_out) + self.b_out

    def predict(self, x):
        return tm.argmax(self.logits(x), axis=1)

    def loss(self, x, y):
        logp = log_softmax(self.logits(x), axis=-1)
        return -tm.mean(logp[arange(y.shape[0]), y])
