"""Optimizer update builders: (cost, params) → the ``updates`` list of
``function()`` (reference ``aesara_tpu/models/optim.py``).  Only ``sgd``
is ported; momentum, RMSProp and the Adam family wait for their ops."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from aesara_tpu_torch.gradient import grad


def sgd(cost, params: Sequence, lr: float = 0.01) -> List[Tuple]:
    """Plain stochastic gradient descent: p ← p − lr · d cost / d p."""
    return [(p, p - lr * g) for p, g in zip(params, grad(cost, list(params)))]
