"""Shared plumbing for the model builders (reference
``aesara_tpu/models/base.py``).  Weights are drawn from an explicit
``np.random.Generator``; nothing reads global random state."""

from __future__ import annotations

from typing import List

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import shared
from aesara_tpu_torch.config import config


def glorot(rng: np.random.Generator, n_in: int, n_out: int, name: str):
    limit = np.sqrt(6.0 / (n_in + n_out))
    w = rng.uniform(-limit, limit, size=(n_in, n_out)).astype(config.floatX)
    return shared(w, name=name)


def zeros(shape, name: str):
    return shared(np.zeros(shape, dtype=config.floatX), name=name)


class Model:
    """Parameter registry."""

    def __init__(self):
        self.params: List = []

    def _register(self, *ps):
        self.params.extend(ps)
        return ps if len(ps) > 1 else ps[0]

    def get_values(self):
        return [p.get_value() for p in self.params]
