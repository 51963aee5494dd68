"""The scalar ops of the port's real table and special functions, as test
cases shared by ``test_torch_scalar_math.py`` (the CPU, against the JAX
package) and ``test_torch_cuda.py`` (K1's Triton form against the plain
form on the card).  Imports torch, NumPy and the port only.

Each case: (name, module, arity, domain, kind).  ``module`` is where the
op instance lives in both packages ("ops" or "math"), ``domain`` names the
values ``case_values`` draws, each with the edges of its op (negative
values, zero divisors, +-inf and NaN, shift counts at and beyond the
width, Erfcx's switch at 8, Gamma's poles), and ``kind`` is "int" for the
ops that run on integers (then also on floats where NumPy's does) and
"float" for the functions of the reals.
"""

import numpy as np

from aesara_tpu_torch.scalar import math as pmath, ops as pops


CASES = [
    ("int_div", "ops", 2, "divide", "int"),
    ("mod", "ops", 2, "divide", "int"),
    ("ceil", "ops", 1, "halves", "int"),
    ("floor", "ops", 1, "halves", "int"),
    ("trunc", "ops", 1, "halves", "int"),
    ("round_half_to_even", "ops", 1, "halves", "int"),
    ("round_half_away_from_zero", "ops", 1, "halves", "int"),
    ("xor", "ops", 2, "bits", "bits"),
    ("shift_left", "ops", 2, "shift", "bits"),
    ("shift_right", "ops", 2, "shift", "bits"),
    ("exp2", "ops", 1, "real", "float"),
    ("expm1", "ops", 1, "real", "float"),
    ("log2", "ops", 1, "positive", "float"),
    ("log10", "ops", 1, "positive", "float"),
    ("log1p", "ops", 1, "above_minus_one", "float"),
    ("deg2rad", "ops", 1, "real", "float"),
    ("rad2deg", "ops", 1, "real", "float"),
    ("tan", "ops", 1, "real", "float"),
    ("arccos", "ops", 1, "unit", "float"),
    ("arcsin", "ops", 1, "unit", "float"),
    ("arctan", "ops", 1, "real", "float"),
    ("arctan2", "ops", 2, "real", "float"),
    ("cosh", "ops", 1, "real", "float"),
    ("sinh", "ops", 1, "real", "float"),
    ("tanh", "ops", 1, "real", "float"),
    ("arccosh", "ops", 1, "above_one", "float"),
    ("arcsinh", "ops", 1, "real", "float"),
    ("arctanh", "ops", 1, "unit", "float"),
    ("in_range", "ops", 3, "range", "float"),
    ("mean_scalar", "ops", 3, "real", "float"),
    ("reciprocal", "ops", 1, "real", "float"),
    # two ops of the first slices, here for their float64 forms
    ("true_div", "ops", 2, "real", "float"),
    ("sqrt", "ops", 1, "positive", "float"),
    ("erf", "math", 1, "real", "float"),
    ("erfc", "math", 1, "real", "float"),
    ("erfinv", "math", 1, "unit", "float"),
    ("erfcinv", "math", 1, "zero_two", "float"),
    ("erfcx", "math", 1, "erfcx", "float"),
    ("gamma", "math", 1, "gamma", "float"),
    ("gammaln", "math", 1, "gamma", "float"),
    ("j0", "math", 1, "real", "float"),
    ("j1", "math", 1, "real", "float"),
    ("i0", "math", 1, "bessel_i", "float"),
    ("i1", "math", 1, "bessel_i", "float"),
    ("sigmoid", "math", 1, "real", "float"),
    ("softplus", "math", 1, "real", "float"),
    ("log1mexp", "math", 1, "nonpositive", "float"),
]
NAMES = [c[0] for c in CASES]
BY_NAME = {c[0]: c for c in CASES}

#: the dtypes each kind runs in (K1's on the card; the CPU tests take the
#: first float and int ones)
DTYPES = {"int": ["int32", "int64", "int8", "float32", "float64"], "bits": ["int32", "int64", "uint8"],
          "float": ["float32", "float64", "bfloat16"]}


def scalar_op(pkg_ops, pkg_math, name):
    """The op instance ``name`` of a package (``InRange`` has none: the
    case is the closed range)."""
    if name == "in_range":
        return pkg_ops.InRange(False, False)
    return getattr(pkg_ops if BY_NAME[name][1] == "ops" else pkg_math, name)


def port_op(name):
    return scalar_op(pops, pmath, name)


_NONFINITE = [np.nan, np.inf, -np.inf]


def _float_values(domain, n, rng):
    """(n,) float64 values of ``domain`` with its edges in front."""
    if domain == "positive":
        edges, v = [0.0, 1.0, np.inf, np.nan, 1e-30], rng.uniform(1e-3, 50.0, n)
    elif domain == "above_minus_one":
        edges, v = [-1.0, 0.0, -0.5, np.inf, np.nan], rng.uniform(-0.999, 20.0, n)
    elif domain == "unit":
        edges, v = [-1.0, 1.0, 0.0, np.nan], rng.uniform(-0.999, 0.999, n)
    elif domain == "above_one":
        edges, v = [1.0, np.inf, np.nan], rng.uniform(1.0, 30.0, n)
    elif domain == "zero_two":
        edges, v = [1.0, 0.5, 1.5, np.nan], rng.uniform(0.01, 1.99, n)
    elif domain == "erfcx":
        # both sides of the switch at 8, and where exp(x**2) overflows
        edges, v = [8.0, np.nextafter(8.0, 0.0), 7.5, 30.0, -3.0, np.inf, np.nan], rng.uniform(-3.0, 40.0, n)
    elif domain == "gamma":
        # poles at 0 and the negative integers, both signs between them
        edges, v = [1.0, 2.0, 0.5, -0.5, -1.5, -2.5, 3.7, np.inf, np.nan], rng.uniform(-5.5, 20.0, n)
    elif domain == "bessel_i":
        edges, v = [0.0, -1.0, 5.0, np.nan], rng.uniform(-15.0, 15.0, n)
    elif domain == "nonpositive":
        # both sides of log(1/2), the switch
        edges, v = [0.0, -np.inf, np.log(0.5), -1e-8, -30.0, np.nan], -rng.exponential(2.0, n)
    elif domain == "halves":
        edges, v = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, -0.0, np.inf, -np.inf, np.nan], np.round(
            rng.normal(0.0, 4.0, n) * 4) / 4
    else:
        edges, v = [0.0, -0.0, 1.0, -1.0] + _NONFINITE, rng.normal(0.0, 3.0, n)
    v[:len(edges)] = edges[:n]
    return v


def case_values(name, dtype, n, rng):
    """The operands of case ``name`` in ``dtype``: a list of (n,) arrays
    (a shape the CPU and card tests broadcast as they need)."""
    _, _, nin, domain, kind = BY_NAME[name]
    if dtype in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32"):
        info = np.iinfo(dtype)
        lo, hi = max(info.min, -1000), min(info.max, 1000)
        vals = [rng.integers(lo, hi + 1, n).astype(dtype) for _ in range(nin)]
        if domain == "divide":
            # zero divisors, MIN // -1, and every sign pair
            y = vals[1]
            y[:6] = [0, 0, -1, 1, -3, 3]
            x = vals[0]
            x[:6] = [5, -5, info.min, info.min, 7, -7]
        elif domain == "shift":
            bits = 8 * np.dtype(dtype).itemsize
            x, y = vals
            counts = [0, 1, bits - 1, bits, bits + 8, 40, 3]
            x[:7] = [1, -8 if info.min < 0 else 8, 3, 1, -8 if info.min < 0 else 5, 1, info.max]
            y[:] = rng.integers(0, bits + 10, n)
            y[:7] = counts
            if info.min < 0:
                y[7] = -1
        return vals
    vals = [_float_values(domain, n, rng) for _ in range(nin)]
    if domain == "divide":
        vals[1][:4] = [0.0, -0.0, 0.0, np.inf]
        vals[0][:4] = [1.0, 1.0, 0.0, 3.0]
    if domain == "range":
        vals[1] = np.minimum(vals[1], vals[2])
        vals[0][:3] = [vals[1][0], vals[2][1], np.nan]
    if dtype == "bfloat16":
        return vals          # the card test rounds them itself
    return [v.astype(dtype) for v in vals]
