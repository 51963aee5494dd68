"""Shared plumbing for the model builders (reference
``aesara_tpu/models/base.py``).  Weights are drawn from an explicit
``np.random.Generator``; nothing reads global random state."""

from __future__ import annotations

from typing import List

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import shared
from aesara_tpu_torch.config import config
from aesara_tpu_torch.misc.safe_asarray import _asarray


def glorot(rng: np.random.Generator, n_in: int, n_out: int, name: str):
    limit = np.sqrt(6.0 / (n_in + n_out))
    # in floatX as the JAX package's .astype(config.floatX) (bfloat16: the
    # same bits, rounded by torch, _asarray)
    return shared(_asarray(rng.uniform(-limit, limit, size=(n_in, n_out)), config.floatX), name=name)


def zeros(shape, name: str):
    return shared(_asarray(np.zeros(shape), config.floatX), name=name)


class Model:
    """Parameter registry."""

    def __init__(self):
        self.params: List = []

    def _register(self, *ps):
        self.params.extend(ps)
        return ps if len(ps) > 1 else ps[0]

    def get_values(self):
        return [p.get_value() for p in self.params]
