"""Linear models (reference ``aesara_tpu/models/linear.py``).

``x`` may be dense or sparse: ``tm.dot`` routes a sparse ``x`` to the
sparse ``Dot``, which the rewrites turn into ``Usmm`` / ``StructuredDot``
on the CSR kernels, gradient included.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.models.base import Model, glorot, zeros
from aesara_tpu_torch.tensor import math as tm
from aesara_tpu_torch.tensor.basic import arange
from aesara_tpu_torch.tensor.special import log_softmax


__all__ = ["LinearRegression", "LogisticRegression"]


class LinearRegression(Model):
    def __init__(self, n_in: int, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.w = self._register(glorot(rng, n_in, 1, "w"))
        self.b = self._register(zeros((), "b"))

    def predict(self, x):
        # the reference's [:, 0]: dim 1 of x @ w is statically 1, so
        # dropping it is a DimShuffle (basic indexing is not ported yet)
        return tm.dot(x, self.w).dimshuffle(0) + self.b

    def loss(self, x, y):
        d = self.predict(x) - y
        return tm.mean(d * d)


class LogisticRegression(Model):
    """Multinomial logistic regression: softmax(xW + b)."""

    def __init__(self, n_in: int, n_out: int, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.w = self._register(glorot(rng, n_in, n_out, "w"))
        self.b = self._register(zeros((n_out,), "b"))

    def logits(self, x):
        return tm.dot(x, self.w) + self.b

    def predict(self, x):
        return tm.argmax(self.logits(x), axis=1)

    def loss(self, x, y):
        """Mean negative log-likelihood of the integer targets ``y``."""
        logp = log_softmax(self.logits(x), axis=-1)
        return -tm.mean(logp[arange(y.shape[0]), y])
