"""``RandomStream``: the user API of random graphs (the counterpart of
``aesara_tpu/tensor/random/utils.py:21-75``).

Each distribution call makes a shared PRNG state, a threefry key folded
off the stream's master key by a counter (as the JAX package folds it),
whose ``default_update`` is the draw's next key: a compiled function draws
new values every call.  The stream has a method for each distribution the
port draws; ``gen(op, *params)`` makes any other (one the port does not
draw yet raises when its function is compiled).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from aesara_tpu_torch.tensor.random import basic as rb
from aesara_tpu_torch.tensor.random.op import default_rng, fold_in, normalize_size_param  # noqa: F401
from aesara_tpu_torch.tensor.random.var import key_shared

__all__ = ["RandomStream", "RandomStreams"]


class RandomStream:
    """A factory of seeded random variables."""

    def __init__(self, seed: Optional[int] = None, namespace=None):
        self._master = np.asarray(default_rng(seed), dtype=np.uint32)
        self._counter = 0
        self.state_updates = []      # (shared rng, new rng) pairs
        self.gen_seedgen = self
        self.default_instance_seed = seed

    def _next_key(self) -> np.ndarray:
        key = fold_in(self._master, self._counter)
        self._counter += 1
        return key

    def seed(self, seed: Optional[int] = None):
        """Re-seed the stream and every key it made, in the order made."""
        self._master = np.asarray(default_rng(seed), dtype=np.uint32)
        self._counter = 0
        for shared_rng, _ in self.state_updates:
            shared_rng.set_value(self._next_key())

    def gen(self, op, *args, size=None, **kwargs):
        rng = key_shared(self._next_key(), name=f"{op.name}_rng")
        out = op(*args, size=size, rng=rng, **kwargs)
        next_rng = out.owner.outputs[0]
        rng.default_update = next_rng
        self.state_updates.append((rng, next_rng))
        out.rng = rng
        out.update = (rng, next_rng)
        return out

    def updates(self):
        return list(self.state_updates)

    # -- the distributions the port draws ------------------------------------
    def uniform(self, low=0.0, high=1.0, size=None, **kw):
        return self.gen(rb.uniform, low, high, size=size, **kw)

    def normal(self, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.normal, loc, scale, size=size, **kw)

    def standard_normal(self, size=None, **kw):
        return self.gen(rb.standard_normal, size=size, **kw)

    def lognormal(self, mean=0.0, sigma=1.0, size=None, **kw):
        return self.gen(rb.lognormal, mean, sigma, size=size, **kw)

    def halfnormal(self, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.halfnormal, loc, scale, size=size, **kw)

    def bernoulli(self, p=0.5, size=None, **kw):
        return self.gen(rb.bernoulli, p, size=size, **kw)

    def exponential(self, scale=1.0, size=None, **kw):
        return self.gen(rb.exponential, scale, size=size, **kw)

    def weibull(self, shape, size=None, **kw):
        # the np.random convention: the standard Weibull; scale by multiplying
        return self.gen(rb.weibull, shape, size=size, **kw)

    def laplace(self, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.laplace, loc, scale, size=size, **kw)

    def logistic(self, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.logistic, loc, scale, size=size, **kw)

    def cauchy(self, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.cauchy, loc, scale, size=size, **kw)

    def halfcauchy(self, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.halfcauchy, loc, scale, size=size, **kw)

    def gumbel(self, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.gumbel, loc, scale, size=size, **kw)

    def standard_exponential(self, size=None, **kw):
        return self.gen(rb.exponential, 1.0, size=size, **kw)

    def standard_cauchy(self, size=None, **kw):
        return self.gen(rb.cauchy, 0.0, 1.0, size=size, **kw)

    def random(self, size=None, **kw):
        return self.gen(rb.uniform, 0.0, 1.0, size=size, **kw)


#: the reference's name
RandomStreams = RandomStream
