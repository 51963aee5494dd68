"""The special functions of the scalar algebra (reference
``aesara_tpu/scalar/math.py``), cut to those a libdevice function or a
short formula of them computes on the card: Erf, Erfc, Erfinv, Erfcinv,
Erfcx, Gamma, GammaLn, J0, J1, I0, I1, Sigmoid, Softplus and Log1mexp.

Each holds to the JAX package's lowering, not to its SciPy ``impl``:
Softplus is ``logaddexp(x, 0)``, Gamma the reflection through
``gammaln``, Erfcinv ``erfinv(1 - x)``, Erfcx a three-term asymptotic
series from 8 on (``link/torch/kernels/elemwise.py`` has the formulas).

``Psi`` and ``TriGamma`` are here because the gradients of Gamma and
GammaLn build them; they have a plain form but no form in the fused
kernel yet, so a graph that reaches the card with one raises when it is
compiled.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special as _sp

from aesara_tpu_torch.scalar.ops import (
    UnaryScalarOp, constant, exp, expm1, mul, neg, sqr, sub, true_div, upgrade_to_float_no_complex,
)


class _Special(UnaryScalarOp):
    output_types_preference = staticmethod(upgrade_to_float_no_complex)


class Erf(_Special):
    nfunc = staticmethod(_sp.erf)

    def grad(self, inputs, output_grads):
        c = constant(2.0 / math.sqrt(math.pi))
        return [mul(output_grads[0], mul(c, exp(neg(sqr(inputs[0])))))]


class Erfc(_Special):
    nfunc = staticmethod(_sp.erfc)

    def grad(self, inputs, output_grads):
        c = constant(-2.0 / math.sqrt(math.pi))
        return [mul(output_grads[0], mul(c, exp(neg(sqr(inputs[0])))))]


class Erfinv(_Special):
    nfunc = staticmethod(_sp.erfinv)

    def grad(self, inputs, output_grads):
        c = constant(math.sqrt(math.pi) / 2.0)
        return [mul(output_grads[0], mul(c, exp(sqr(erfinv(inputs[0])))))]


class Erfcinv(_Special):
    nfunc = staticmethod(_sp.erfcinv)

    def grad(self, inputs, output_grads):
        c = constant(-math.sqrt(math.pi) / 2.0)
        return [mul(output_grads[0], mul(c, exp(sqr(erfcinv(inputs[0])))))]


class Erfcx(_Special):
    """exp(x**2) * erfc(x), without its overflow."""

    nfunc = staticmethod(_sp.erfcx)

    def grad(self, inputs, output_grads):
        # d/dx erfcx = 2 x erfcx(x) - 2/sqrt(pi)
        (x,) = inputs
        two_over_sqrt_pi = constant(2.0 / np.sqrt(np.pi))
        return [mul(output_grads[0], sub(mul(constant(2.0), mul(x, erfcx(x))), two_over_sqrt_pi))]


class Gamma(_Special):
    nfunc = staticmethod(_sp.gamma)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        return [mul(output_grads[0], mul(gamma(x), psi(x)))]


class GammaLn(_Special):
    nfunc = staticmethod(_sp.gammaln)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], psi(inputs[0]))]


class Psi(_Special):
    """digamma."""

    nfunc = staticmethod(_sp.psi)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], tri_gamma(inputs[0]))]


class TriGamma(_Special):
    nfunc = staticmethod(lambda x: _sp.polygamma(1, x))

    def grad(self, inputs, output_grads):
        from aesara_tpu_torch.gradient import grad_not_implemented

        return [grad_not_implemented(self, 0, inputs[0])]


class J0(_Special):
    nfunc = staticmethod(_sp.j0)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], neg(j1(inputs[0])))]


class J1(_Special):
    nfunc = staticmethod(_sp.j1)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        return [mul(output_grads[0], sub(j0(x), true_div(j1(x), x)))]


class I0(_Special):
    nfunc = staticmethod(_sp.i0)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], i1(inputs[0]))]


class I1(_Special):
    nfunc = staticmethod(_sp.i1)

    def grad(self, inputs, output_grads):
        (x,) = inputs
        return [mul(output_grads[0], sub(i0(x), true_div(i1(x), x)))]


class Sigmoid(_Special):
    nfunc = staticmethod(_sp.expit)

    def grad(self, inputs, output_grads):
        s = sigmoid(inputs[0])
        return [mul(output_grads[0], mul(s, sub(constant(1.0), s)))]


class Softplus(_Special):
    """log(1 + exp(x)), stable."""

    def impl(self, x):
        xf = np.asarray(x, dtype=np.float64)
        return np.logaddexp(xf, 0.0)

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], sigmoid(inputs[0]))]


class Log1mexp(_Special):
    """log(1 - exp(x)) for x <= 0, stable on both sides of log(1/2)."""

    def impl(self, x):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(x < math.log(0.5), np.log1p(-np.exp(x)), np.log(-np.expm1(x)))

    def grad(self, inputs, output_grads):
        return [mul(output_grads[0], true_div(constant(-1.0), expm1(neg(inputs[0]))))]


erf = Erf(name="erf")
erfc = Erfc(name="erfc")
erfinv = Erfinv(name="erfinv")
erfcinv = Erfcinv(name="erfcinv")
erfcx = Erfcx(name="erfcx")
gamma = Gamma(name="gamma")
gammaln = GammaLn(name="gammaln")
psi = Psi(name="psi")
tri_gamma = TriGamma(name="tri_gamma")
j0 = J0(name="j0")
j1 = J1(name="j1")
i0 = I0(name="i0")
i1 = I1(name="i1")
sigmoid = Sigmoid(name="sigmoid")
softplus = Softplus(name="softplus")
log1mexp = Log1mexp(name="log1mexp")
