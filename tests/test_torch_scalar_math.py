"""The rest of the port's real scalar table (``scalar/ops.py``) and its
special functions (``scalar/math.py``) against the JAX package, on the CPU.

For every op of ``tests/torch_scalar_cases.py``:

- its plain form (``scalar_torch_impl``, what K1 computes on CPU tensors)
  against the JAX package's XLA closure (``scalar_jax_impl``; InRange and
  Mean have none there, so against their NumPy ``impl``) on seeded values
  with each op's edges;
- a Composite holding it: K1's plain version against ``composite_pallas_fn``
  in interpret mode (the JAX package's Pallas kernel; for J0/J1 its XLA
  closure, see below);
- its generated Triton source parses and calls the form it should;
- its gradient: the scalar ``grad`` gives the same kinds (a variable, an
  undefined or a disconnected gradient) in both packages, and ``grad`` of
  a sum of the op compiled by each (``FAST_RUN`` / ``TORCH``) gives the
  same values.

Tolerances: integer results, roundings, comparisons and the floor
division are exact.  float32 rtol 1e-5, atol 1e-6 (the two libraries'
transcendental functions differ by an ulp or two); float64 1e-12.  Stated
exceptions: the JAX package's J0/J1 (a ``bessel_jn`` recurrence over the
whole array) are NaN in float32 for every entry up to |x| = 3 of an array
that holds a negative value (a fault of the reference), and in float64
NaN at 0 and off by up to 4e-7; PyTorch's own float64 J0/J1 are off by as
much: the port is held to SciPy at atol 1e-6, and to the JAX package in
float64 only, where it is finite, at atol 1e-6; Gamma through exp(gammaln) multiplies
gammaln's rounding by its size (rtol 2e-5 in float32); gammaln near its
zero crossings on the negative axis, atol 5e-6 in float32.  Integer floor
division and modulo by zero give 0 as NumPy does, where the JAX package
gives -2/-1 (a fault of the reference); the float ones by zero give
NumPy's +-inf/NaN where the JAX package gives NaN: both are held to NumPy.
"""

import ast
import warnings

import numpy as np
import pytest
import scipy.special as sps
import torch

import jax.numpy as jnp

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.link.jax.dispatch import composite_jax_impl, scalar_jax_impl
from aesara_tpu.link.jax.pallas_kernels import composite_pallas_fn
from aesara_tpu.scalar import math as jmath, ops as jops
from aesara_tpu.scalar.composite import Composite as JComposite
from aesara_tpu.tensor.elemwise import Elemwise as JElemwise

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels.elemwise import ElemwiseKernel, apply_scalar_node, composite_plain
from aesara_tpu_torch.scalar import ops as pops
from aesara_tpu_torch.scalar.composite import Composite as PComposite
from aesara_tpu_torch.tensor.elemwise import Elemwise as PElemwise

from tests.torch_scalar_cases import BY_NAME, CASES, NAMES, case_values, port_op, scalar_op


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


CPU_DTYPES = {"int": ["int32", "int64", "float32", "float64"], "bits": ["int32", "int64", "uint8"],
              "float": ["float32", "float64"]}
#: ops the JAX package does not lower (its Python fallback runs ``impl``)
NO_JAX_LOWERING = {"in_range", "mean_scalar"}


def _jax_op(name):
    return scalar_op(jops, jmath, name)


def _tol(name, dtype):
    """(rtol, atol) of the plain form against the JAX package's."""
    if dtype == "float64":
        return (1e-12, 1e-12) if name not in ("j0", "j1") else (0.0, 1e-6)
    return {"gamma": (2e-5, 1e-6), "gammaln": (1e-5, 5e-6), "j0": (0.0, 1e-6), "j1": (0.0, 1e-6)}.get(
        name, (1e-5, 1e-6))


def _out_dtype(name, dtype):
    nin = BY_NAME[name][2]
    return port_op(name)(*[pops.ScalarType(dtype)() for _ in range(nin)]).type.dtype


def _jax_values(name, vals, out_dtype):
    jop = _jax_op(name)
    if name in NO_JAX_LOWERING:
        return np.asarray(np.vectorize(jop.impl)(*vals)).astype(out_dtype)
    return np.asarray(scalar_jax_impl(jop)(*[jnp.asarray(v) for v in vals])).astype(out_dtype)


def _numpy(name, vals):
    """NumPy's (and SciPy's) value of the ops the JAX package does not
    hold to NumPy on some inputs."""
    with np.errstate(all="ignore"):
        if name == "int_div":
            return np.floor_divide(*vals)
        if name == "mod":
            return np.mod(*vals)
        if name in ("j0", "j1"):
            return getattr(sps, name)(vals[0].astype("float64"))
    raise KeyError(name)


@pytest.mark.parametrize("name,dtype", [(c[0], d) for c in CASES for d in CPU_DTYPES[c[4]]])
def test_plain_form_matches_jax(name, dtype):
    vals = case_values(name, dtype, 512, np.random.default_rng(NAMES.index(name)))
    out_dtype = _out_dtype(name, dtype)
    got = apply_scalar_node(port_op(name), out_dtype, [torch.from_numpy(v) for v in vals]).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jax_values(name, vals, out_dtype)
    assert got.dtype == want.dtype == np.dtype(out_dtype) and got.shape == want.shape
    keep = np.ones(got.shape, dtype=bool)
    if name in ("int_div", "mod"):
        # the zero divisors are held to NumPy: the JAX package errs there
        np.testing.assert_array_equal(got, _numpy(name, vals))
        keep = vals[1] != 0
    if name in ("j0", "j1"):
        np.testing.assert_allclose(got, _numpy(name, vals), rtol=0, atol=1e-6)
        if dtype == "float32":
            return
        keep = np.isfinite(want)    # the JAX package's series is NaN at 0
    if out_dtype == "bool" or np.dtype(out_dtype).kind in "iu":
        np.testing.assert_array_equal(got[keep], want[keep])
    else:
        rtol, atol = _tol(name, dtype)
        np.testing.assert_allclose(got[keep], want[keep], rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["int8", "int32", "int64"])
def test_integer_floor_division_by_zero_is_zero(dtype):
    """The math, not the JAX package: NumPy's 0 for a zero divisor (with
    a warning), MIN // -1 wraps to MIN, the quotient rounds toward -inf
    and the remainder takes the divisor's sign; the tensor functions
    compiled by the port give the same."""
    info = np.iinfo(dtype)
    x = np.array([5, 0, -5, info.min, -7, 7, -7, 7], dtype=dtype)
    y = np.array([0, 0, 0, -1, 2, -2, -2, 2], dtype=dtype)
    div = [0, 0, 0, info.min, -4, -4, 3, 3]
    mod = [0, 0, 0, 0, 1, -1, -1, 1]
    xs, ys = pat.TensorType(dtype, (None,))("x"), pat.TensorType(dtype, (None,))("y")
    f = aesara_tpu_torch.function([xs, ys], [pat.int_div(xs, ys), pat.mod(xs, ys), xs // ys, xs % ys])
    for got, want in zip(f(x, y), (div, mod, div, mod)):
        assert got.numpy().tolist() == want
    with np.errstate(all="ignore"):
        assert np.floor_divide(x, y).tolist() == div and np.mod(x, y).tolist() == mod


def _composites(name, dtype):
    """One Composite of ``name`` over ``dtype`` operands in each package."""
    nin = BY_NAME[name][2]
    outs = []
    for ops, math, Composite in ((jops, jmath, JComposite), (pops, None, PComposite)):
        ins = [ops.ScalarType(dtype)() for _ in range(nin)]
        op = _jax_op(name) if math is not None else port_op(name)
        outs.append(Composite(ins, [op(*ins)]))
    return outs


@pytest.mark.parametrize("name", NAMES)
def test_composite_matches_pallas_interpret(name):
    """K1's plain version of a Composite holding the op against the JAX
    package's Pallas kernel in interpret mode, same-shape float32 (int32
    for the bitwise ops, float64 for J0/J1) operands."""
    from jax.experimental.pallas import tpu as pltpu

    kind = BY_NAME[name][4]
    dtype = "int32" if kind == "bits" else "float64" if name in ("j0", "j1") else "float32"
    jcomp, pcomp = _composites(name, dtype)
    out_dtype = pcomp.outputs[0].type.dtype
    vals = [v.reshape(16, 32) for v in case_values(name, dtype, 512, np.random.default_rng(7))]
    got = composite_plain(pcomp, out_dtype, *[torch.from_numpy(v) for v in vals]).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name in NO_JAX_LOWERING:
            want = np.asarray(np.vectorize(jcomp.impl)(*vals)).astype(out_dtype)
        elif name in ("j0", "j1"):
            # Pallas's interpret mode gives 1e-80s for this float64 series:
            # the Composite's XLA closure instead, where it is finite
            want = np.asarray(composite_jax_impl(jcomp)(*[jnp.asarray(v) for v in vals]))
        else:
            with pltpu.force_tpu_interpret_mode():
                want = np.asarray(composite_pallas_fn(jcomp, np.dtype(out_dtype))(*[jnp.asarray(v) for v in vals]))
    assert got.shape == want.shape == (16, 32) and got.dtype == want.dtype
    keep = np.isfinite(want) if name in ("j0", "j1") else np.ones(got.shape, dtype=bool)
    if name in ("int_div", "mod"):
        keep = vals[1] != 0
    if np.dtype(out_dtype).kind in "biu":
        np.testing.assert_array_equal(got[keep], want[keep])
    else:
        rtol, atol = _tol(name, dtype)
        np.testing.assert_allclose(got[keep], want[keep], rtol=rtol, atol=atol)


#: what each op's Triton form calls
TRITON_FORMS = {
    "int_div": "floordiv(", "mod": "floordiv(", "ceil": "libdevice.ceil(", "floor": "libdevice.floor(",
    "trunc": "libdevice.trunc(", "round_half_to_even": "libdevice.rint(",
    "round_half_away_from_zero": "libdevice.copysign(", "xor": " ^ ", "shift_left": "ishift(",
    "shift_right": "ishift(", "exp2": "libdevice.exp2(", "expm1": "libdevice.expm1(", "log2": "libdevice.log2(",
    "log10": "libdevice.log10(", "log1p": "libdevice.log1p(", "deg2rad": "0.017453292519943295",
    "rad2deg": "57.29577951308232", "tan": "libdevice.tan(", "arccos": "libdevice.acos(",
    "arcsin": "libdevice.asin(", "arctan": "libdevice.atan(", "arctan2": "libdevice.atan2(",
    "cosh": "libdevice.cosh(", "sinh": "libdevice.sinh(", "tanh": "libdevice.tanh(",
    "arccosh": "libdevice.acosh(", "arcsinh": "libdevice.asinh(", "arctanh": "libdevice.atanh(",
    "in_range": " <= ", "mean_scalar": "tl.math.div_rn(", "reciprocal": "tl.math.div_rn(",
    "true_div": "tl.math.div_rn(", "sqrt": "tl.sqrt",
    "erf": "libdevice.erf(", "erfc": "libdevice.erfc(", "erfinv": "libdevice.erfinv(",
    "erfcinv": "libdevice.erfinv(", "erfcx": "libdevice.erfc(", "gamma": "libdevice.lgamma(",
    "gammaln": "libdevice.lgamma(", "j0": "libdevice.j0(", "j1": "libdevice.j1(",
    "i0": "libdevice.cyl_bessel_i0(", "i1": "libdevice.cyl_bessel_i1(", "sigmoid": "libdevice.exp(",
    "softplus": "libdevice.log1p(", "log1mexp": "libdevice.expm1(",
}


@pytest.mark.parametrize("name,dtype", [(c[0], d) for c in CASES for d in CPU_DTYPES[c[4]] + ["bfloat16"]
                                        if c[4] != "bits" or d != "bfloat16"])
def test_triton_form_parses(name, dtype):
    _, pcomp = _composites(name, dtype)
    kernel = ElemwiseKernel(pcomp, [dtype] * pcomp.nin, pcomp.outputs[0].type.dtype)
    for ndim in (0, 2):
        src = kernel.source(ndim)
        ast.parse(src)
    integer = np.dtype(dtype).kind in "iu" if dtype != "bfloat16" else False
    if integer and name in ("ceil", "floor", "trunc", "round_half_to_even", "round_half_away_from_zero"):
        assert "libdevice.trunc" not in src and "(x0.to(tl." in src    # an integer is its own rounding
    else:
        form = TRITON_FORMS[name]
        if dtype == "float64" and form == "tl.math.div_rn(":
            form = " / "                       # div_rn takes fp32 only
        assert form in src, src


def test_ops_without_triton_form_raise_when_compiled():
    """Psi and TriGamma (the gradients of Gamma and GammaLn build them)
    have a plain form but no Triton form yet, nor do the floor division of
    uint64 and the shifts of bools: the kernel generator refuses them."""
    from aesara_tpu_torch.scalar import math as pmath

    for op, dtype in ((pmath.psi, "float32"), (pmath.tri_gamma, "float32"), (pops.int_div, "uint64"),
                      (pops.shift_left, "bool")):
        ins = [pops.ScalarType(dtype)() for _ in range(op.nin)]
        with pytest.raises(NotImplementedError):
            ElemwiseKernel(PComposite(ins, [op(*ins)]), [dtype] * op.nin, op(*ins).type.dtype)


def _grad_kinds(ops, op, dtype, nin):
    """The kind of each gradient the scalar ``grad`` gives (or the
    exception it raises)."""
    ins = [ops.ScalarType(dtype)() for _ in range(nin)]
    out = op(*ins)
    try:
        grads = op.grad(ins, [out.type()])
    except Exception as exc:    # no gradient defined at all
        return type(exc).__name__ in ("MethodNotDefined", "NotImplementedError", "AttributeError")
    return [type(g.type).__name__ for g in grads]


@pytest.mark.parametrize("name", NAMES)
def test_gradient_kinds_match_jax(name):
    """Each op's scalar gradient is a variable, undefined or disconnected
    for the same inputs in both packages (ops without a gradient raise in
    both)."""
    nin, kind = BY_NAME[name][2], BY_NAME[name][4]
    dtype = "int32" if kind == "bits" else "float32"
    assert _grad_kinds(pops, port_op(name), dtype, nin) == _grad_kinds(jops, _jax_op(name), dtype, nin)


#: the ops with a float gradient, and where it is evaluated: inside each
#: op's domain, away from its edges
GRADIENT_DOMAINS = {
    "exp2": (-3, 3), "expm1": (-3, 3), "log2": (0.2, 5), "log10": (0.2, 5), "log1p": (-0.5, 5),
    "deg2rad": (-3, 3), "rad2deg": (-3, 3), "tan": (-1.2, 1.2), "arccos": (-0.9, 0.9), "arcsin": (-0.9, 0.9),
    "arctan": (-3, 3), "arctan2": (0.3, 3), "cosh": (-3, 3), "sinh": (-3, 3), "tanh": (-3, 3),
    "arccosh": (1.2, 5), "arcsinh": (-3, 3), "arctanh": (-0.9, 0.9), "reciprocal": (0.3, 3), "mod": (0.3, 3),
    "erf": (-2, 2), "erfc": (-2, 2), "erfinv": (-0.9, 0.9), "erfcinv": (0.1, 1.9), "erfcx": (-1, 10),
    "j0": (-4, 4), "j1": (0.5, 4), "i0": (-4, 4), "i1": (0.5, 4), "sigmoid": (-4, 4), "softplus": (-4, 4),
    "log1mexp": (-4, -0.05),
}


@pytest.mark.parametrize("name", sorted(GRADIENT_DOMAINS))
def test_gradient_matches_jax(name):
    """grad(sum(op(x, ...)), x) compiled by each package (JAX FAST_RUN, the
    port's TORCH) on the same seeded values: float32 (float64 for J0/J1,
    see the module's note), rtol 1e-4 (the gradient graphs are rewritten
    by each package's own rules), atol 1e-5.  Mod's divisor has no
    gradient; the others' every input is taken."""
    nin = BY_NAME[name][2]
    lo, hi = GRADIENT_DOMAINS[name]
    dtype = "float64" if name in ("j0", "j1") else "float32"
    vals = [np.random.default_rng(11 + k).uniform(lo, hi, size=(4, 5)).astype(dtype) for k in range(nin)]
    results = []
    for pkg, at, op, mode in ((aesara_tpu, jat, _jax_op(name), "FAST_RUN"),
                              (aesara_tpu_torch, pat, port_op(name), "TORCH")):
        xs = [at.matrix(f"x{k}", dtype=dtype) for k in range(nin)]
        Elemwise = JElemwise if pkg is aesara_tpu else PElemwise
        cost = at.sum(Elemwise(op)(*xs))
        wrt = xs[:1] if name == "mod" else xs
        f = pkg.function(xs, pkg.grad(cost, wrt), mode=mode)
        results.append([np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g) for g in f(*vals)])
    for want, got in zip(*results):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gamma_gradients_build_psi():
    """Gamma's and GammaLn's gradients build Psi, which has a plain form
    but no K1 form yet (ROADMAP item 4b): GammaLn's lone ``psi`` runs as a
    plain Elemwise and matches JAX's; Gamma's fuses Psi into a Composite,
    which refuses to compile, as an op without a Triton form must."""
    x = np.random.default_rng(5).uniform(0.5, 4.0, size=(6,)).astype("float32")
    results = []
    for pkg, at, mode in ((aesara_tpu, jat, "FAST_RUN"), (aesara_tpu_torch, pat, "TORCH")):
        v = at.vector("v")
        f = pkg.function([v], pkg.grad(at.sum(at.gammaln(v)), v), mode=mode)
        out = f(x)
        results.append(np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out))
    np.testing.assert_allclose(results[1], results[0], rtol=1e-5, atol=1e-6)
    v = pat.vector("v")
    with pytest.raises(NotImplementedError, match="psi"):
        aesara_tpu_torch.function([v], aesara_tpu_torch.grad(pat.sum(pat.gamma(v)), v))
