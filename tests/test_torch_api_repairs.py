"""Two faults of the port against the JAX package, repaired, and the
``FAST_RUN`` mode's name.

- ``aesara_tpu_torch.scan``, ``aesara_tpu_torch.tensor.var``, ``.shape``
  and ``.sort`` are the functions, as in the JAX package, and compute
  what the JAX package's names compute on the same float64 inputs
  (``shape``, ``sort`` and ``scan`` exactly, ``var`` to 1e-14 relative: a
  mean's sum may round an ulp apart); the modules of those names stay
  importable by path.
- A float converted to an integer type truncates toward zero, saturates
  at the type's bounds and gives 0 for NaN, as XLA's ``convert`` does in
  the JAX package: every integer width, from float64, float32, float16
  and bfloat16, alone and inside a fused Composite (of ``x * 2``), exactly
  equal.  The Triton form (``_saturate_expr``) parses and names both
  bounds; the card holds it to the plain form (``tests/test_torch_cuda.py
  -k cast``).
- ``function(..., mode="FAST_RUN")`` compiles through the port's ``TORCH``
  mode, so ``benchmarks/bench_decode.py``'s calls run verbatim.
"""

import ast
import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels.elemwise import ElemwiseKernel
from aesara_tpu_torch.misc.safe_asarray import _asarray
from aesara_tpu_torch.scalar.composite import Composite


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


def _host(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


X = np.random.default_rng(21).normal(size=(4, 5))


@pytest.mark.parametrize("name", ["scan", "var", "shape", "sort"])
def test_the_four_names_are_the_jax_packages_functions(name):
    results = []
    for pkg, at in ((aesara_tpu, jat), (aesara_tpu_torch, pat)):
        x = at.matrix("x", dtype="float64")
        if name == "scan":
            out, _ = pkg.scan(lambda row, acc: acc + 2.0 * row, sequences=[x],
                              outputs_info=[at.zeros((5,), dtype="float64")])
        elif name == "var":
            out = [at.var(x), at.var(x, axis=0, ddof=1), at.var(x, axis=1, keepdims=True)]
        elif name == "shape":
            out = at.shape(x)
        else:
            out = [at.sort(x), at.sort(x, axis=0), at.sort(x, axis=None)]
        assert callable(getattr(pkg if name == "scan" else at, name))
        results.append([_host(v) for v in pkg.function([x], out)(X)] if isinstance(out, list)
                       else [_host(pkg.function([x], out)(X))])
    want, got = results
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if name == "var":
            np.testing.assert_allclose(g, w, rtol=1e-14, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


def test_the_shadowed_modules_stay_importable_by_path():
    for mod, attr in (("aesara_tpu_torch.scan.basic", "scan"), ("aesara_tpu_torch.tensor.shape", "specify_shape"),
                      ("aesara_tpu_torch.tensor.sort", "SortOp"), ("aesara_tpu_torch.tensor.var", "TensorVariable")):
        assert hasattr(importlib.import_module(mod), attr)
    from aesara_tpu_torch.tensor.shape import specify_shape  # noqa: F401
    from aesara_tpu_torch.tensor.sort import argsort  # noqa: F401
    import aesara_tpu_torch.scan.op  # noqa: F401
    assert callable(aesara_tpu_torch.scan) and callable(pat.shape)


INTS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"]
#: the edges: past each width's bounds, NaN, the infinities, fractions either side
EDGES = np.array([300.0, -1.9, 3e9, np.nan, np.inf, -np.inf, -300.0, 1e19, 2e19, -3e9, 127.9, -128.9, 255.5,
                  65535.7, 1e30, 0.0, -0.0, 0.99, -0.99, 2147483520.0, -2147483648.0, 4294967040.0])


def _jax_input(dtype):
    return EDGES.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else EDGES.astype(dtype)


def _port_input(dtype):
    return _asarray(EDGES.astype("float32"), dtype) if dtype == "bfloat16" else EDGES.astype(dtype)


@pytest.mark.filterwarnings("ignore:overflow encountered in cast")
@pytest.mark.parametrize("fused", [False, True], ids=["alone", "fused"])
@pytest.mark.parametrize("src", ["float64", "float32", "float16", "bfloat16"])
def test_a_float_to_integer_cast_saturates_as_the_jax_packages(src, fused):
    """Exactly the JAX package's values: int8(300.0) = 127, uint8(-1.9) = 0,
    int32(3e9) = 2,147,483,647, int32(nan) = 0, and so on for each width;
    ``fused`` casts ``x * 2`` (one Composite of Mul and Cast) where the
    other casts ``x`` alone."""
    for dst in INTS:
        results = []
        for pkg, at, xv in ((aesara_tpu, jat, _jax_input(src)), (aesara_tpu_torch, pat, _port_input(src))):
            x = at.vector("x", dtype=src)
            y = at.cast(x * np.asarray(2.0, dtype="float32" if src == "bfloat16" else src), dst) if fused \
                else at.cast(x, dst)
            f = pkg.function([x], y)
            results.append(_host(f(xv)))
            if pkg is aesara_tpu_torch:
                comps = [n for n in f.maker.fgraph.apply_nodes if isinstance(getattr(n.op, "scalar_op", None),
                                                                              Composite)]
                assert len(comps) == int(fused), dst
        want, got = results
        assert got.dtype == np.dtype(dst), dst
        np.testing.assert_array_equal(got, want, err_msg=f"{src} -> {dst}")
        if not fused and dst in ("int8", "uint8", "int32"):
            assert (got[0], got[1], got[2], got[3]) == {"int8": (127, -1, 127, 0), "uint8": (255, 0, 255, 0),
                                                         "int32": (300, -1, 2**31 - 1, 0)}[dst]


@pytest.mark.parametrize("dst", INTS)
def test_the_triton_form_of_a_saturating_cast_parses(dst):
    x = pat.vector("x", dtype="float32")
    f = aesara_tpu_torch.function([x], pat.cast(pat.exp(x), dst))
    node = next(n for n in f.maker.fgraph.apply_nodes if isinstance(getattr(n.op, "scalar_op", None), Composite))
    src = ElemwiseKernel(node.op.scalar_op, ["float32"], dst).source(1)
    ast.parse(src)
    lo, hi = np.iinfo(dst).min, np.iinfo(dst).max
    assert f"{float(hi + 1)!r}" in src and f"tl.full([BLOCK], {hi}," in src and f"tl.full([BLOCK], {lo}," in src


def test_fast_run_is_the_torch_mode():
    x = pat.vector("x", dtype="float64")
    f = aesara_tpu_torch.function([x], pat.exp(x) * 2.0, mode="FAST_RUN")
    np.testing.assert_array_equal(_host(f(np.arange(3.0))), np.exp(np.arange(3.0)) * 2.0)
    from aesara_tpu_torch.compile.mode import FAST_COMPILE, TORCH, get_mode

    assert get_mode("FAST_RUN") is TORCH
    assert get_mode("FAST_COMPILE") is FAST_COMPILE
    # the JAX package's PY mode has no counterpart: the port has no fallback
    with pytest.raises(ValueError, match="unknown mode"):
        get_mode("PY")
