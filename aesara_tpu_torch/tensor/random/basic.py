"""The distributions (the counterpart of ``aesara_tpu/tensor/random/basic.py``).

Each class keeps the JAX package's name, support rank, parameter ranks
and dtype.  The port draws those whose ``jax.random`` form is a closed
transform of uniform or normal bits: ``uniform``, ``normal``,
``standard_normal``, ``lognormal``, ``halfnormal``, ``bernoulli``,
``exponential``, ``weibull``, ``laplace``, ``logistic``, ``cauchy``,
``halfcauchy`` and ``gumbel``.  A draw is ``jax.random.uniform``'s floats
from the threefry kernel (on the range :meth:`uniform_range` names, as
JAX's ``_uniform`` computes it: ``max(lo, u * (hi - lo) + lo)``), then the
transform of ``jax/_src/random.py`` (``_normal_real``, ``_bernoulli``,
``_cauchy``, ``_exponential``, ``_gumbel``, ``_laplace``, ``_logistic``)
and the JAX package's ``rng_fn`` as torch ops, in the dtype JAX computes
with 64-bit mode on (float64 floats; bernoulli in its ``p``'s dtype).
XLA contracts each ``a * b + c`` of those formulas into one fused
multiply-add, so the port computes each as ``torch.addcmul`` (fused on
the CPU and on the card), which keeps float64 draws bit for bit.
The others keep their classes and raise when a function holding one is
compiled: they wait for the remaining distributions (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import math

import numpy as np

from aesara_tpu_torch.tensor.random.op import RandomVariable


def _normal(u):
    """``_normal_real``: sqrt(2) * erfinv(u), u on (nextafter(-1, 0), 1)."""
    import torch

    return torch.erfinv(u) * float(np.sqrt(np.asarray(2.0, dtype=str(u.dtype).split(".")[-1])))


def _normal_range(dtype):
    return np.nextafter(np.asarray(-1.0, dtype), np.asarray(0.0, dtype)), np.asarray(1.0, dtype)


def _promoted(*params):
    """The params in JAX's common dtype of two arrays (float beats int;
    the wider of each kind wins), which torch does not give where one of
    them is 0-d."""
    import torch

    floats = [p.dtype for p in params if p.dtype.is_floating_point]
    pool = floats or [p.dtype for p in params]
    dtype = max(pool, key=lambda d: torch.finfo(d).bits if d.is_floating_point else torch.iinfo(d).bits)
    return [p.to(dtype) for p in params]


def fma(a, b, c):
    """``a * b + c`` rounded once, in the operands' common dtype, as XLA
    contracts it."""
    import torch

    a, b, c = _promoted(a, b, c)
    return torch.addcmul(c, a, b)


class UniformRV(RandomVariable):
    def __init__(self):
        super().__init__("uniform", 0, (0, 0), "floatX")

    def sample(self, u, low, high):
        low, high = _promoted(low, high)
        return fma(u, high - low, low)


class NormalRV(RandomVariable):
    def __init__(self):
        super().__init__("normal", 0, (0, 0), "floatX")

    uniform_range = staticmethod(_normal_range)

    def sample(self, u, loc, scale):
        return fma(_normal(u), scale, loc)


class StandardNormalRV(RandomVariable):
    def __init__(self):
        super().__init__("standard_normal", 0, (), "floatX")

    uniform_range = staticmethod(_normal_range)

    def sample(self, u):
        return _normal(u)


class LogNormalRV(RandomVariable):
    def __init__(self):
        super().__init__("lognormal", 0, (0, 0), "floatX")

    uniform_range = staticmethod(_normal_range)

    def sample(self, u, mean, sigma):
        import torch

        return torch.exp(fma(_normal(u), sigma, mean))


class HalfNormalRV(RandomVariable):
    def __init__(self):
        super().__init__("halfnormal", 0, (0, 0), "floatX")

    uniform_range = staticmethod(_normal_range)

    def sample(self, u, loc, scale):
        return fma(_normal(u).abs(), scale, loc)


class BernoulliRV(RandomVariable):
    def __init__(self):
        super().__init__("bernoulli", 0, (0,), "int64")

    def draw_dtype(self, param_dtypes) -> str:
        # jax.random.bernoulli draws in p's dtype, which must be a float
        (dtype,) = param_dtypes
        if not np.issubdtype(np.dtype(dtype), np.floating):
            raise TypeError(f"bernoulli probability p must have a floating dtype, got {dtype}")
        return dtype

    def sample(self, u, p):
        return u < p


class ExponentialRV(RandomVariable):
    def __init__(self):
        super().__init__("exponential", 0, (0,), "floatX")

    def sample(self, u, scale):
        import torch

        return -torch.log1p(-u) * scale


class WeibullRV(RandomVariable):
    def __init__(self):
        super().__init__("weibull", 0, (0,), "floatX")

    def uniform_range(self, dtype):
        return np.asarray(1e-7, dtype), np.asarray(1.0, dtype)

    def sample(self, u, shape_p):
        import torch

        return torch.pow(-torch.log(u), 1.0 / shape_p)


class LaplaceRV(RandomVariable):
    def __init__(self):
        super().__init__("laplace", 0, (0, 0), "floatX")

    def uniform_range(self, dtype):
        return np.asarray(-1.0 + float(np.finfo(dtype).epsneg), dtype), np.asarray(1.0, dtype)

    def sample(self, u, loc, scale):
        import torch

        return fma(torch.sign(u) * torch.log1p(-u.abs()), scale, loc)


class LogisticRV(RandomVariable):
    def __init__(self):
        super().__init__("logistic", 0, (0, 0), "floatX")

    def uniform_range(self, dtype):
        return np.asarray(np.finfo(dtype).tiny, dtype), np.asarray(1.0, dtype)

    def sample(self, u, loc, scale):
        import torch

        return fma(torch.log(u) - torch.log1p(-u), scale, loc)


class CauchyRV(RandomVariable):
    def __init__(self):
        super().__init__("cauchy", 0, (0, 0), "floatX")

    def uniform_range(self, dtype):
        return np.asarray(np.finfo(dtype).eps, dtype), np.asarray(1.0, dtype)

    def sample(self, u, loc, scale):
        return fma(_cauchy(u), scale, loc)


def _cauchy(u):
    import torch

    return torch.tan(math.pi * (u - 0.5))


class HalfCauchyRV(RandomVariable):
    def __init__(self):
        super().__init__("halfcauchy", 0, (0, 0), "floatX")

    uniform_range = CauchyRV.uniform_range

    def sample(self, u, loc, scale):
        return fma(_cauchy(u).abs(), scale, loc)


class GumbelRV(RandomVariable):
    def __init__(self):
        super().__init__("gumbel", 0, (0, 0), "floatX")

    def uniform_range(self, dtype):
        return np.asarray(np.finfo(dtype).tiny, dtype), np.asarray(1.0, dtype)

    def sample(self, u, loc, scale):
        import torch

        return fma(-torch.log(-torch.log(u)), scale, loc)


# -- distributions the port does not draw yet ---------------------------------

class BinomialRV(RandomVariable):
    def __init__(self):
        super().__init__("binomial", 0, (0, 0), "int64")


class BetaRV(RandomVariable):
    def __init__(self):
        super().__init__("beta", 0, (0, 0), "floatX")


class GammaRV(RandomVariable):
    def __init__(self):
        super().__init__("gamma", 0, (0, 0), "floatX")


class ChiSquareRV(RandomVariable):
    def __init__(self):
        super().__init__("chisquare", 0, (0,), "floatX")


class ParetoRV(RandomVariable):
    def __init__(self):
        super().__init__("pareto", 0, (0,), "floatX")


class PoissonRV(RandomVariable):
    def __init__(self):
        super().__init__("poisson", 0, (0,), "int64")


class GeometricRV(RandomVariable):
    def __init__(self):
        super().__init__("geometric", 0, (0,), "int64")


class StudentTRV(RandomVariable):
    def __init__(self):
        super().__init__("t", 0, (0, 0, 0), "floatX")


class TruncNormalRV(RandomVariable):
    def __init__(self):
        super().__init__("truncated_normal", 0, (0, 0), "floatX")


class VonMisesRV(RandomVariable):
    def __init__(self):
        super().__init__("vonmises", 0, (0, 0), "floatX")


class RandIntRV(RandomVariable):
    def __init__(self, name="randint"):
        super().__init__(name, 0, (0, 0), "int64")


class IntegersRV(RandIntRV):
    def __init__(self):
        super().__init__("integers")


class CategoricalRV(RandomVariable):
    """Index draws from a probability vector (last axis)."""

    def __init__(self):
        super().__init__("categorical", 0, (1,), "int64")


class ChoiceRV(RandomVariable):
    __props__ = RandomVariable.__props__ + ("replace",)

    def __init__(self, replace: bool = True):
        super().__init__("choice", 0, (1,), None)
        self.replace = bool(replace)

    def __call__(self, *dist_params, replace=None, **kwargs):
        if replace is not None and bool(replace) != self.replace:
            return ChoiceRV(replace=replace)(*dist_params, **kwargs)
        return super().__call__(*dist_params, **kwargs)

    def make_node(self, rng, size, a, *rest):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable

        a = as_tensor_variable(a)
        op = ChoiceRV(replace=self.replace)
        op.dtype = a.type.dtype
        return RandomVariable.make_node(op, rng, size, a, *rest)


class PermutationRV(RandomVariable):
    def __init__(self):
        super().__init__("permutation", 1, (1,), None)

    def make_node(self, rng, size, x):
        from aesara_tpu_torch.tensor.basic import as_tensor_variable, get_scalar_constant_value

        x = as_tensor_variable(x)
        if x.type.ndim == 0:
            # permutation(n) is a shuffled arange(n): n must be a constant
            try:
                n = int(get_scalar_constant_value(x))
            except Exception:
                raise NotImplementedError("permutation(n) needs a constant n: the output length is n's value "
                                          "(pass an explicit arange otherwise)")
            x = as_tensor_variable(np.arange(n, dtype=x.type.dtype))
        op = PermutationRV()
        op.dtype = x.type.dtype
        return RandomVariable.make_node(op, rng, size, x)

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        return (dist_params[0].type.shape[-1],)


class DirichletRV(RandomVariable):
    def __init__(self):
        super().__init__("dirichlet", 1, (1,), "floatX")

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        return (dist_params[0].type.shape[-1],)


class MultivariateNormalRV(RandomVariable):
    def __init__(self):
        super().__init__("multivariate_normal", 1, (1, 2), "floatX")

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        return (dist_params[0].type.shape[-1],)


class MultinomialRV(RandomVariable):
    def __init__(self):
        super().__init__("multinomial", 1, (0, 1), "int64")

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        return (dist_params[1].type.shape[-1],)


uniform = UniformRV()
normal = NormalRV()
standard_normal = StandardNormalRV()
lognormal = LogNormalRV()
halfnormal = HalfNormalRV()
bernoulli = BernoulliRV()
binomial = BinomialRV()
beta = BetaRV()
gamma = GammaRV()
exponential = ExponentialRV()
weibull = WeibullRV()
laplace = LaplaceRV()
logistic = LogisticRV()
cauchy = CauchyRV()
halfcauchy = HalfCauchyRV()
chisquare = ChiSquareRV()
gumbel = GumbelRV()
pareto = ParetoRV()
poisson = PoissonRV()
geometric = GeometricRV()
t = StudentTRV()
studentt = t
truncated_normal = TruncNormalRV()
vonmises = VonMisesRV()
randint = RandIntRV()
integers = IntegersRV()
categorical = CategoricalRV()
choice = ChoiceRV()
permutation = PermutationRV()
dirichlet = DirichletRV()
multivariate_normal = MultivariateNormalRV()
multinomial = MultinomialRV()


def standard_exponential(size=None, rng=None, **kw):
    return exponential(1.0, size=size, rng=rng, **kw)


def standard_cauchy(size=None, rng=None, **kw):
    return cauchy(0.0, 1.0, size=size, rng=rng, **kw)


def standard_gamma(shape, size=None, rng=None, **kw):
    return gamma(shape, 1.0, size=size, rng=rng, **kw)


standard_t = t


def random(size=None, rng=None, **kw):
    """U[0, 1) (the reference's alias of uniform with its defaults)."""
    return uniform(0.0, 1.0, size=size, rng=rng, **kw)
