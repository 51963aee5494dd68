"""The distributions (the counterpart of ``aesara_tpu/tensor/random/basic.py``).

Each class keeps the JAX package's name, support rank, parameter ranks
and dtype, and every one draws what the JAX package's ``rng_fn`` draws
with ``jax.random`` (64-bit mode on, as the JAX package runs on the CPU).

- **A transform of one uniform draw** (:meth:`sample`): ``uniform``,
  ``normal``, ``standard_normal``, ``lognormal``, ``halfnormal``,
  ``bernoulli``, ``exponential``, ``weibull``, ``laplace``, ``logistic``,
  ``cauchy``, ``halfcauchy`` and ``gumbel``.  The draw is
  ``jax.random.uniform``'s floats from the threefry kernel (on the range
  :meth:`uniform_range` names, as JAX's ``_uniform`` computes it: ``max(lo,
  u * (hi - lo) + lo)``), then the transform of ``jax/_src/random.py``.
- **A draw from the key** (:meth:`sample_key`, the rest): the JAX package's
  ``rng_fn`` line for line on ``jax.random``'s functions as written here
  (``_jr_uniform``, ``_jr_split``, ``_jr_gamma``, ...): the threefry
  kernel without its split for uniforms, bits and keys, and the loop
  kernels of ``link/torch/kernels/random_loops.py`` for gamma (TG, and
  beta, dirichlet, chisquare, t, invgamma, f, gengamma on it), Poisson (TP)
  and binomial (TB, and multinomial as its scan); nbinom and betabinom mix
  them.  Integers are ``_randint``'s uint64 arithmetic on int64 words,
  permutations its rounds of stable sorts.

XLA contracts each ``a * b + c`` of those formulas into one fused
multiply-add, so the port computes each as ``torch.addcmul`` (fused on
the CPU and on the card), and ``float / tensor`` as a division (PyTorch's
multiplies by the reciprocal).
"""

from __future__ import annotations

import math

import numpy as np

from aesara_tpu_torch.link.torch.kernels.random_loops import rdiv
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


# -- jax.random's functions, as the draws from a key call them ---------------

def _tdt(name: str):
    import torch

    return getattr(torch, name)


def _mode(dtype) -> str:
    return str(dtype).split(".")[-1]


def _jr_split(key, num: int = 2):
    """``jax.random.split(key, num)``: an (num, 2) torch.uint32 tensor."""
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw

    return threefry_draw(key, (num,), "keys", split=False)[1]


def _jr_bits(key, shape, width: int):
    """``jax.random.bits``: int32 or int64 bit patterns of uint32/uint64."""
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw

    return threefry_draw(key, tuple(shape), f"bits{width}", split=False)[1]


def _jr_uniform(key, shape, dtype, minval=0.0, maxval=1.0):
    """``jax.random.uniform``: ``max(lo, u * (hi - lo) + lo)`` in ``dtype``
    (tensors or floats for the bounds)."""
    import torch

    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw

    u = threefry_draw(key, tuple(shape), _mode(dtype), split=False)[1]
    if not isinstance(minval, torch.Tensor) and not isinstance(maxval, torch.Tensor):
        lo, hi = np.asarray(minval, _mode(dtype)), np.asarray(maxval, _mode(dtype))
        if lo == 0 and hi == 1:
            return u
        return torch.clamp_min(fma(u, torch.full((), float(hi - lo), dtype=u.dtype, device=u.device),
                                   torch.full((), float(lo), dtype=u.dtype, device=u.device)), float(lo))
    lo = minval.to(u.dtype) if isinstance(minval, torch.Tensor) else torch.full((), float(minval), dtype=u.dtype,
                                                                                 device=u.device)
    hi = maxval.to(u.dtype) if isinstance(maxval, torch.Tensor) else torch.full((), float(maxval), dtype=u.dtype,
                                                                                  device=u.device)
    return torch.maximum(lo, fma(u, hi - lo, lo))


def _jr_normal(key, shape, dtype):
    lo, hi = _normal_range(_mode(dtype))
    return _normal(_jr_uniform(key, shape, dtype, float(lo), float(hi)))


def _flat(x, shape, dtype):
    return x.to(dtype).broadcast_to(shape).reshape(-1).contiguous()


def _jr_gamma(key, a, shape, dtype, log_space: bool = False):
    """``jax.random.gamma`` (``loggamma``): TG, element ``i`` from
    ``split(key, n)[i]``."""
    from aesara_tpu_torch.link.torch.kernels.random_loops import gamma_draw

    shape = tuple(shape)
    return gamma_draw(key, _flat(a, shape, dtype), log_space).reshape(shape)


def _jr_poisson(key, lam, shape):
    """``jax.random.poisson`` (int64): TP, with λ in float32 as JAX takes it."""
    import torch

    from aesara_tpu_torch.link.torch.kernels.random_loops import poisson_draw

    shape = tuple(shape)
    return poisson_draw(key, _flat(lam, shape, torch.float32)).reshape(shape)


def _inexact(x):
    """``promote_dtypes_inexact`` of one array: floats stay, the rest float64."""
    import torch

    return x if x.dtype.is_floating_point else x.to(torch.float64)


def _jr_binomial(key, count, prob, shape):
    """``jax.random.binomial`` in the probabilities' float dtype: TB."""
    from aesara_tpu_torch.link.torch.kernels.random_loops import binomial_draw

    prob = _inexact(prob)
    shape = tuple(shape)
    return binomial_draw(key, _flat(count, shape, prob.dtype), _flat(prob, shape, prob.dtype)).reshape(shape)


def _jr_gumbel(key, shape, dtype):
    import torch

    tiny = float(np.finfo(_mode(dtype)).tiny)
    return -torch.log(-torch.log(_jr_uniform(key, shape, dtype, tiny, 1.0)))


def _jr_categorical(key, logits, shape):
    """``jax.random.categorical`` over the last axis: the argmax of Gumbel
    noise plus the logits."""
    import torch

    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(shape)
    prefix = shape[:len(shape) - len(batch)]
    g = _jr_gumbel(key, (*prefix, *shape[len(shape) - len(batch):], logits.shape[-1]), logits.dtype)
    return torch.argmax(g + logits.reshape((1,) * len(prefix) + tuple(logits.shape)), dim=-1)


# uint64 arithmetic on int64 carriers (two's complement words): PyTorch has
# no unsigned 64-bit remainder, on the card least of all
_SIGN = -(1 << 63)


def _u64_ge(a, b):
    return (a ^ _SIGN) >= (b ^ _SIGN)


def _u64_rem(x, s):
    """``x % s`` of uint64 words, by binary long division."""
    import torch

    x, s = torch.broadcast_tensors(x, s)
    r = torch.zeros_like(x)
    for bit in range(63, -1, -1):
        carry = r < 0                                   # r >= 2**63: the shift leaves 64 bits
        r = (r << 1) | ((x >> bit) & 1)
        r = torch.where(carry | _u64_ge(r, s), r - s, r)
    return r


def _jr_randint(key, shape, minval, maxval):
    """``jax.random.randint`` into int64: two 64-bit draws, combined modulo
    the span in uint64 arithmetic with wraparound, as ``_randint`` computes."""
    import torch

    shape = tuple(shape)
    minval, maxval = (v if not v.dtype.is_floating_point else v.to(torch.int64) for v in (minval, maxval))
    minval, maxval = minval.to(torch.int64), maxval.to(torch.int64)
    k = _jr_split(key, 2)
    higher, lower = _jr_bits(k[0], shape, 64), _jr_bits(k[1], shape, 64)
    span = torch.where(maxval <= minval, torch.ones_like(maxval), maxval - minval)
    multiplier = _u64_rem(torch.full_like(span, 1 << 32), span)
    multiplier = _u64_rem(multiplier * multiplier, span)
    offset = _u64_rem(_u64_rem(higher, span) * multiplier + _u64_rem(lower, span), span)
    return minval + offset


def _shuffle(key, x):
    """``jax.random``'s ``_shuffle`` along axis 0: rounds of a stable sort
    keyed by 32 fresh bits an element."""
    import torch

    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k = _jr_split(key, 2)
        key = k[0]
        bits = _jr_bits(k[1], (n,), 32).to(torch.int64) & 0xFFFFFFFF
        x = x[torch.sort(bits, stable=True).indices]
    return x


def _jr_permutation(key, x):
    import torch

    if x.dim() == 1:
        return _shuffle(key, x)
    return x[_shuffle(key, torch.arange(x.shape[0], device=x.device))]


def _bshape(size, *params):
    """The draw's shape: ``size``, else the params' broadcast."""
    if size is not None:
        return tuple(size)
    return tuple(np.broadcast_shapes(*(tuple(p.shape) for p in params))) if params else ()


def _f64(*params):
    """The params in float64, ``jax.random``'s default float with 64-bit
    mode on."""
    import torch

    return [p.to(torch.float64) for p in params]


# -- the draws from a key -----------------------------------------------------

class BinomialRV(RandomVariable):
    def __init__(self):
        super().__init__("binomial", 0, (0, 0), "int64")

    def sample_key(self, key, size, n, p):
        import torch

        return _jr_binomial(key, n.to(torch.float32), p, _bshape(size, n, p))


class BetaRV(RandomVariable):
    def __init__(self):
        super().__init__("beta", 0, (0, 0), "floatX")

    def sample_key(self, key, size, a, b):
        return _jr_beta(key, *_f64(a, b), _bshape(size, a, b))


def _jr_beta(key, a, b, shape):
    """``jax.random.beta``: two loggamma draws from the key's two halves."""
    import torch

    k = _jr_split(key, 2)
    la = _jr_gamma(k[0], a, shape, a.dtype, True)
    lb = _jr_gamma(k[1], b, shape, b.dtype, True)
    log_max = torch.maximum(la, lb)
    ga, gb = torch.exp(la - log_max), torch.exp(lb - log_max)
    return ga / (ga + gb)


class GammaRV(RandomVariable):
    def __init__(self):
        super().__init__("gamma", 0, (0, 0), "floatX")

    def sample_key(self, key, size, shape_p, scale):
        import torch

        return _jr_gamma(key, shape_p, _bshape(size, shape_p, scale), torch.float64) * _f64(scale)[0]


class ChiSquareRV(RandomVariable):
    def __init__(self):
        super().__init__("chisquare", 0, (0,), "floatX")

    def sample_key(self, key, size, df):
        return _jr_chisquare(key, _f64(df)[0], _bshape(size, df))


def _jr_chisquare(key, df, shape):
    import torch

    return torch.exp(_jr_gamma(key, df / 2.0, shape, df.dtype, True)) * 2.0


class ParetoRV(RandomVariable):
    def __init__(self):
        super().__init__("pareto", 0, (0,), "floatX")

    def sample_key(self, key, size, b):
        import torch

        (b,) = _f64(b)
        e = -torch.log1p(-_jr_uniform(key, _bshape(size, b), torch.float64))
        return torch.exp(e / b)


class PoissonRV(RandomVariable):
    def __init__(self):
        super().__init__("poisson", 0, (0,), "int64")

    def sample_key(self, key, size, lam):
        return _jr_poisson(key, lam, _bshape(size, lam))


class GeometricRV(RandomVariable):
    def __init__(self):
        super().__init__("geometric", 0, (0,), "int64")

    def sample_key(self, key, size, p):
        import torch

        p = _inexact(p)
        shape = _bshape(size, p)
        log_u = torch.log(_jr_uniform(key, shape, p.dtype))
        return torch.floor(log_u / torch.log1p(-p).broadcast_to(shape)) + 1.0


class StudentTRV(RandomVariable):
    def __init__(self):
        super().__init__("t", 0, (0, 0, 0), "floatX")

    def sample_key(self, key, size, df, loc, scale):
        import torch

        (df,) = _f64(df)
        shape = _bshape(size, df, loc, scale)
        k = _jr_split(key, 2)
        n = _jr_normal(k[0], shape, torch.float64)
        half = df / 2.0
        g = _jr_gamma(k[1], half, shape, torch.float64)
        return fma(n * torch.sqrt(half / g), scale, loc)


class TruncNormalRV(RandomVariable):
    def __init__(self):
        super().__init__("truncated_normal", 0, (0, 0), "floatX")

    def sample_key(self, key, size, lower, upper):
        import torch

        lower, upper = _f64(lower, upper)
        sqrt2 = float(np.sqrt(2))
        a, b = torch.special.erf(lower / sqrt2), torch.special.erf(upper / sqrt2)
        u = _jr_uniform(key, _bshape(size, lower, upper), torch.float64, a, b)
        out = sqrt2 * torch.erfinv(u)
        return torch.clamp(out, torch.nextafter(lower, torch.full_like(lower, math.inf)),
                           torch.nextafter(upper, torch.full_like(upper, -math.inf)))


class VonMisesRV(RandomVariable):
    """Best and Fisher's rejection with 16 proposals an element, the first
    accepted kept (the JAX package's fixed-round form)."""

    def __init__(self):
        super().__init__("vonmises", 0, (0, 0), "floatX")

    def sample_key(self, key, size, mu, kappa):
        import torch

        mu, kappa_in = _f64(mu, kappa)
        shape = _bshape(size, mu, kappa)
        kappa = torch.clamp_min(kappa_in, 1e-2)
        u = _jr_uniform(key, (16, 3) + shape, torch.float64)
        tau = 1.0 + torch.sqrt(fma(torch.full_like(kappa, 4.0), kappa * kappa, torch.ones_like(kappa)))
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa)
        r = fma(rho, rho, torch.ones_like(rho)) / (2.0 * rho)
        z = torch.cos(math.pi * u[:, 0])
        f = fma(r, z, torch.ones_like(z)) / (r + z)
        c = kappa * (r - f)
        accept = (fma(c, 2.0 - c, -u[:, 1]) > 0.0) | (torch.log(c / torch.clamp_min(u[:, 1], 1e-30)) + 1.0 - c >= 0.0)
        first = torch.argmax(accept.to(torch.int8), dim=0, keepdim=True)
        f_sel = torch.take_along_dim(f, first, 0)[0]
        u3 = torch.take_along_dim(u[:, 2], first, 0)[0]
        out = mu + torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f_sel, -1.0, 1.0))
        uniform_draw = fma(2.0 * u[0, 0] - 1.0, torch.full_like(mu, math.pi), mu)
        out = torch.where(kappa_in < 1e-2, uniform_draw, out)
        return torch.remainder(out + math.pi, 2.0 * math.pi) - math.pi


class RandIntRV(RandomVariable):
    def __init__(self, name="randint"):
        super().__init__(name, 0, (0, 0), "int64")

    def sample_key(self, key, size, low, high):
        return _jr_randint(key, _bshape(size, low, high), low, high)


class IntegersRV(RandIntRV):
    def __init__(self):
        super().__init__("integers")


class CategoricalRV(RandomVariable):
    """Index draws from a probability vector (last axis)."""

    def __init__(self):
        super().__init__("categorical", 0, (1,), "int64")

    def sample_key(self, key, size, p):
        import torch

        return _jr_categorical(key, torch.log(p), size)


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

    def sample_key(self, key, size, a, p=None):
        """The JAX package's three routes: with replacement, ``randint`` (no
        ``p``) or ``categorical`` of log p; without, ``jax.random.choice``:
        a shuffle's head (no ``p``) or the top of Gumbel noise plus log p."""
        import torch

        shape = tuple(size) if size is not None else ()
        if not self.replace:
            if a.dim() == 0:
                raise NotImplementedError("choice without replacement needs an array population (jax.random.choice "
                                          "reads a scalar population's size on the host)")
            n_draws = math.prod(shape)
            if n_draws > a.shape[0]:
                raise ValueError(f"Cannot take a larger sample (size {n_draws}) than population (size {a.shape[0]}) "
                                 "when 'replace=False'")
            if p is None:
                return _jr_permutation(key, a)[:n_draws].reshape(shape + tuple(a.shape[1:]))
            p = _inexact(p)
            g = _jr_gumbel(key, (a.shape[0],), p.dtype) + torch.log(p)
            ind = torch.sort(g, descending=True, stable=True).indices[:n_draws]
            return a[ind].reshape(shape + tuple(a.shape[1:]))
        if p is None:
            if a.dim() == 0:
                return _jr_randint(key, shape, torch.zeros_like(a), a)
            return a[_jr_randint(key, shape, torch.zeros((), dtype=torch.int64, device=a.device),
                                 torch.full((), a.shape[0], dtype=torch.int64, device=a.device))]
        idx = _jr_categorical(key, torch.log(p), shape)
        return idx.to(a.dtype) if a.dim() == 0 else a[idx]


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

    def sample_key(self, key, size, x):
        # the JAX package's rng_fn shuffles x and ignores size
        return _jr_permutation(key, x)


class DirichletRV(RandomVariable):
    def __init__(self):
        super().__init__("dirichlet", 1, (1,), "floatX")

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        return (dist_params[0].type.shape[-1],)

    def sample_key(self, key, size, alpha):
        """loggamma draws, then a softmax over the last axis (K4)."""
        from aesara_tpu_torch.link.torch.kernels.softmax import softmax_rows

        (alpha,) = _f64(alpha)
        shape = (tuple(size) if size is not None else tuple(alpha.shape[:-1])) + tuple(alpha.shape[-1:])
        return softmax_rows(_jr_gamma(key, alpha, shape, alpha.dtype, True))


class MultivariateNormalRV(RandomVariable):
    def __init__(self):
        super().__init__("multivariate_normal", 1, (1, 2), "floatX")

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        return (dist_params[0].type.shape[-1],)

    def sample_key(self, key, size, mean, cov):
        """``jax.random.multivariate_normal``'s Cholesky method."""
        import torch

        mean, cov = (x.to(torch.promote_types(_inexact(mean).dtype, _inexact(cov).dtype)) for x in (mean, cov))
        shape = tuple(size) if size is not None else tuple(np.broadcast_shapes(mean.shape[:-1], cov.shape[:-2]))
        factor = torch.linalg.cholesky_ex(cov, check_errors=False).L
        z = _jr_normal(key, shape + tuple(mean.shape[-1:]), mean.dtype)
        return mean + torch.einsum("...ij,...j->...i", factor, z)


class MultinomialRV(RandomVariable):
    def __init__(self):
        super().__init__("multinomial", 1, (0, 1), "int64")

    def _supp_shape_from_params(self, dist_params, param_shapes=None):
        return (dist_params[1].type.shape[-1],)

    def sample_key(self, key, size, n, p):
        """``jax.random.multinomial``: a scan of binomials (TB) over the
        categories, each of the remaining count at p_j over the remaining
        mass."""
        import torch

        n = n.to(torch.float32)
        dt = torch.promote_types(n.dtype, _inexact(p).dtype)
        n, p = n.to(dt), p.to(dt)
        shape = tuple(p.shape) if size is None else tuple(size) + (p.shape[-1],)
        remainder = n.broadcast_to(shape[:-1])
        p = p.broadcast_to(shape).movedim(-1, 0)
        remaining = torch.flip(torch.cumsum(torch.flip(p, (0,)), 0), (0,))
        ratios = p / torch.where(remaining == 0, torch.ones_like(remaining), remaining)
        keys = _jr_split(key, ratios.shape[0])
        counts = []
        for j in range(ratios.shape[0]):
            ratio = ratios[j].clamp(0, 1)
            count = _jr_binomial(keys[j], remainder, ratio, np.broadcast_shapes(remainder.shape, ratio.shape))
            remainder = remainder - count
            counts.append(count)
        return torch.stack(counts, dim=-1)


class RayleighRV(RandomVariable):
    def __init__(self):
        super().__init__("rayleigh", 0, (0,), "floatX")

    def sample_key(self, key, size, scale):
        import torch

        u = _jr_uniform(key, _bshape(size, scale), torch.float64, 1e-7, 1.0)
        return scale * torch.sqrt(-2.0 * torch.log(u))


class InvGammaRV(RandomVariable):
    def __init__(self):
        super().__init__("invgamma", 0, (0, 0), "floatX")

    def sample_key(self, key, size, shape_p, scale):
        import torch

        return scale / _jr_gamma(key, shape_p, _bshape(size, shape_p, scale), torch.float64)


class WaldRV(RandomVariable):
    """Michael, Schucany and Haas's inverse-Gaussian transform: a normal
    and a uniform from the key's two halves."""

    def __init__(self):
        super().__init__("wald", 0, (0, 0), "floatX")

    def sample_key(self, key, size, mean, scale):
        import torch

        shape = _bshape(size, mean, scale)
        k = _jr_split(key, 2)
        mu, lam = _f64(mean, scale)
        nu = _jr_normal(k[0], shape, torch.float64)
        y = nu * nu
        root = torch.sqrt(fma((4.0 * mu) * lam, y, ((mu * mu) * y) * y))
        x = fma(-(mu / (2.0 * lam)), root, mu + (mu * mu) * y / (2.0 * lam))
        z = _jr_uniform(k[1], shape, torch.float64)
        return torch.where(z <= mu / (mu + x), x, (mu * mu) / x)


class TriangularRV(RandomVariable):
    def __init__(self):
        super().__init__("triangular", 0, (0, 0, 0), "floatX")

    def sample_key(self, key, size, left, mode, right):
        import torch

        lo, m, r = _f64(left, mode, right)
        u = _jr_uniform(key, _bshape(size, left, mode, right), torch.float64)
        fc = (m - lo) / (r - lo)
        return torch.where(u < fc, lo + torch.sqrt((u * (r - lo)) * (m - lo)),
                           r - torch.sqrt(((1.0 - u) * (r - lo)) * (r - m)))


class TruncExponRV(RandomVariable):
    def __init__(self):
        super().__init__("truncexpon", 0, (0, 0, 0), "floatX")

    def sample_key(self, key, size, b, loc, scale):
        import torch

        u = _jr_uniform(key, _bshape(size, b, loc, scale), torch.float64)
        x = -torch.log1p(-u * (1.0 - torch.exp(-_f64(b)[0])))
        return fma(scale, x, loc)


class PowerRV(RandomVariable):
    def __init__(self):
        super().__init__("power", 0, (0,), "floatX")

    def sample_key(self, key, size, a):
        import torch

        u = _jr_uniform(key, _bshape(size, a), torch.float64, 1e-7, 1.0)
        return torch.pow(u, rdiv(1.0, _f64(a)[0]))


class FRV(RandomVariable):
    """The ratio of two scaled gamma draws (the JAX package's form)."""

    def __init__(self):
        super().__init__("f", 0, (0, 0), "floatX")

    def sample_key(self, key, size, dfn, dfd):
        import torch

        shape = _bshape(size, dfn, dfd)
        k = _jr_split(key, 2)
        hn, hd = (x / 2.0 for x in _f64(dfn, dfd))
        num = _jr_gamma(k[0], hn, shape, torch.float64) / hn
        den = _jr_gamma(k[1], hd, shape, torch.float64) / hd
        return num / den


class GenGammaRV(RandomVariable):
    def __init__(self):
        super().__init__("gengamma", 0, (0, 0, 0), "floatX")

    def sample_key(self, key, size, alpha, p, lambd):
        import torch

        alpha, p = _f64(alpha, p)
        g = _jr_gamma(key, alpha / p, _bshape(size, alpha, p, lambd), torch.float64)
        return lambd * torch.pow(g, rdiv(1.0, p))


class NegBinomialRV(RandomVariable):
    """The gamma-Poisson mixture: TG, then TP."""

    def __init__(self):
        super().__init__("nbinom", 0, (0, 0), "int64")

    def sample_key(self, key, size, n, p):
        import torch

        shape = _bshape(size, n, p)
        k = _jr_split(key, 2)
        (pp,) = _f64(p)
        lam = _jr_gamma(k[0], n, shape, torch.float64) * (1.0 - pp) / pp
        return _jr_poisson(k[1], lam, shape)


class BetaBinomialRV(RandomVariable):
    """A beta draw, then a binomial at it: TG twice, then TB."""

    def __init__(self):
        super().__init__("betabinom", 0, (0, 0, 0), "int64")

    def sample_key(self, key, size, n, a, b):
        import torch

        shape = _bshape(size, n, a, b)
        k = _jr_split(key, 2)
        p = _jr_beta(k[0], *_f64(a, b), shape)
        return _jr_binomial(k[1], n.to(torch.float32), p, shape)


class ZipfRV(RandomVariable):
    """Devroye's rejection with 32 proposals an element, the first accepted
    kept (the JAX package's fixed-round form)."""

    def __init__(self):
        super().__init__("zipf", 0, (0,), "int64")

    def sample_key(self, key, size, a):
        import torch

        (aa,) = _f64(a)
        shape = _bshape(size, a)
        u = _jr_uniform(key, (32, 2) + shape, torch.float64, 1e-12, 1.0)
        am1 = aa - 1.0
        b = torch.pow(torch.full_like(am1, 2.0), am1)
        x = torch.floor(torch.pow(u[:, 0], rdiv(-1.0, am1)))
        t = torch.pow(1.0 + rdiv(1.0, x), am1)
        accept = ((u[:, 1] * x) * (t - 1.0) / (b - 1.0) <= t / b) & torch.isfinite(x)
        first = torch.argmax(accept.to(torch.int8), dim=0, keepdim=True)
        xs = torch.take_along_dim(x, first, 0)[0]
        return torch.clamp(xs, 1.0, 2.0 ** 62)


class HyperGeometricRV(RandomVariable):
    """ngood, nbad, nsample → the count of good draws without replacement:
    a sequential urn over ``max(nsample)`` steps, one key a step (the step
    count is read on the host)."""

    host_params = (4,)

    def __init__(self):
        super().__init__("hypergeometric", 0, (0, 0, 0), "int64")

    def sample_key(self, key, size, ngood, nbad, nsample):
        import torch

        nsample = np.asarray(nsample.cpu() if isinstance(nsample, torch.Tensor) else nsample)
        steps = int(np.max(nsample))
        shape = _bshape(size, ngood, nbad, nsample)
        good = ngood.to(torch.float32).broadcast_to(shape)
        bad = nbad.to(torch.float32).broadcast_to(shape)
        # one count (the usual case) stays a host value: a copy to the card
        # inside a captured step would be refused
        ns = int(nsample) if nsample.size == 1 else torch.as_tensor(nsample, device=key.device).broadcast_to(shape)
        cnt = torch.zeros(shape, dtype=torch.int32, device=key.device)
        keys = _jr_split(key, steps) if steps else None
        for t in range(steps):
            p = good / torch.clamp_min(good + bad, 1.0)
            u = _jr_uniform(keys[t], shape, torch.float64)
            active = t < ns
            take_good = (u < p) & active
            good = good - take_good.to(good.dtype)
            bad = bad - ((u >= p) & active).to(bad.dtype)
            cnt = cnt + take_good.to(cnt.dtype)
        return cnt


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
rayleigh = RayleighRV()
invgamma = InvGammaRV()
wald = WaldRV()
triangular = TriangularRV()
truncexpon = TruncExponRV()
power = PowerRV()
f = FRV()
gengamma = GenGammaRV()
nbinom = NegBinomialRV()
negative_binomial = nbinom
betabinom = BetaBinomialRV()
zipf = ZipfRV()
hypergeometric = HyperGeometricRV()


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
