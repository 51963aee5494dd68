"""``RandomStream``: the user API of random graphs (the counterpart of
``aesara_tpu/tensor/random/utils.py:21-75``).

Each distribution call makes a shared PRNG state, a threefry key folded
off the stream's master key by a counter (as the JAX package folds it),
whose ``default_update`` is the draw's next key: a compiled function draws
new values every call.  The stream has a method for each distribution of
the JAX package's stream; ``gen(op, *params)`` makes any other (one the
port has no draw of raises when its function is compiled).
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

    # -- the distributions ----------------------------------------------------
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

    def binomial(self, n=1, p=0.5, size=None, **kw):
        return self.gen(rb.binomial, n, p, size=size, **kw)

    def beta(self, a, b, size=None, **kw):
        return self.gen(rb.beta, a, b, size=size, **kw)

    def gamma(self, shape, scale=1.0, size=None, **kw):
        return self.gen(rb.gamma, shape, scale, size=size, **kw)

    def chisquare(self, df, size=None, **kw):
        return self.gen(rb.chisquare, df, size=size, **kw)

    def poisson(self, lam=1.0, size=None, **kw):
        return self.gen(rb.poisson, lam, size=size, **kw)

    def geometric(self, p, size=None, **kw):
        return self.gen(rb.geometric, p, size=size, **kw)

    def randint(self, low, high=None, size=None, **kw):
        if high is None:
            low, high = 0, low
        return self.gen(rb.randint, low, high, size=size, **kw)

    def integers(self, low, high=None, size=None, **kw):
        if high is None:
            low, high = 0, low
        return self.gen(rb.integers, low, high, size=size, **kw)

    def categorical(self, p, size=None, **kw):
        return self.gen(rb.categorical, p, size=size, **kw)

    def choice(self, a, size=None, replace=True, p=None, **kw):
        op = rb.choice if replace else rb.ChoiceRV(replace=False)
        if p is not None:
            return self.gen(op, a, p, size=size, **kw)
        return self.gen(op, a, size=size, **kw)

    def permutation(self, x, size=None, **kw):
        return self.gen(rb.permutation, x, size=size, **kw)

    def dirichlet(self, alpha, size=None, **kw):
        return self.gen(rb.dirichlet, alpha, size=size, **kw)

    def multivariate_normal(self, mean, cov, size=None, **kw):
        return self.gen(rb.multivariate_normal, mean, cov, size=size, **kw)

    def multinomial(self, n, pvals, size=None, **kw):
        return self.gen(rb.multinomial, n, pvals, size=size, **kw)

    def truncated_normal(self, lower=-2.0, upper=2.0, size=None, **kw):
        return self.gen(rb.truncated_normal, lower, upper, size=size, **kw)

    def pareto(self, b, size=None, **kw):
        return self.gen(rb.pareto, b, size=size, **kw)

    def standard_t(self, df, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.studentt, df, loc, scale, size=size, **kw)

    t = standard_t

    def vonmises(self, mu=0.0, kappa=1.0, size=None, **kw):
        return self.gen(rb.vonmises, mu, kappa, size=size, **kw)

    def rayleigh(self, scale=1.0, size=None, **kw):
        return self.gen(rb.rayleigh, scale, size=size, **kw)

    def invgamma(self, shape, scale=1.0, size=None, **kw):
        return self.gen(rb.invgamma, shape, scale, size=size, **kw)

    def wald(self, mean=1.0, scale=1.0, size=None, **kw):
        return self.gen(rb.wald, mean, scale, size=size, **kw)

    def triangular(self, left, mode, right, size=None, **kw):
        return self.gen(rb.triangular, left, mode, right, size=size, **kw)

    def truncexpon(self, b, loc=0.0, scale=1.0, size=None, **kw):
        return self.gen(rb.truncexpon, b, loc, scale, size=size, **kw)

    def power(self, a, size=None, **kw):
        return self.gen(rb.power, a, size=size, **kw)

    def f(self, dfn, dfd, size=None, **kw):
        return self.gen(rb.f, dfn, dfd, size=size, **kw)

    def gengamma(self, alpha=1.0, p=1.0, lambd=1.0, size=None, **kw):
        return self.gen(rb.gengamma, alpha, p, lambd, size=size, **kw)

    def negative_binomial(self, n, p, size=None, **kw):
        return self.gen(rb.nbinom, n, p, size=size, **kw)

    nbinom = negative_binomial

    def betabinom(self, n, a, b, size=None, **kw):
        return self.gen(rb.betabinom, n, a, b, size=size, **kw)

    def zipf(self, a, size=None, **kw):
        return self.gen(rb.zipf, a, size=size, **kw)


#: the reference's name
RandomStreams = RandomStream
