"""K1, the fused-Composite kernel: its plain PyTorch version against the
JAX package's Pallas kernel (interpret mode) and its XLA closure, on the
three Composites the encoder forward builds and on those of the
optimizers (the AdamW update, the global-norm clip, the warmup-cosine
schedule, Adam's bias correction, the loss scale's finite test and
skip); and the generated Triton source of each, and of a Composite of
every scalar op K1 takes, parses.  fp32 tolerance: rtol 1e-5, atol 1e-6.
A Composite with a bool operand or output is held against the XLA
closure alone: the JAX package runs only Composites whose operands all
have the output's dtype through Pallas (``link/jax/dispatch.py:602``)."""

import ast

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aesara_tpu.graph.fg import FunctionGraph as JFunctionGraph
from aesara_tpu.link.jax.dispatch import composite_jax_impl
from aesara_tpu.link.jax.pallas_kernels import composite_pallas_fn
from aesara_tpu.tensor import basic as jtb, math as jtm
from aesara_tpu.tensor.rewriting.elemwise import FusionOptimizer as JFusion
from aesara_tpu.tensor.type import TensorType as JTensorType

from aesara_tpu_torch.graph.fg import FunctionGraph as PFunctionGraph
from aesara_tpu_torch.link.torch.kernels.elemwise import (
    ElemwiseKernel, composite_plain, fused_elemwise, launch_plan,
)
from aesara_tpu_torch.scalar.composite import Composite as PComposite
from aesara_tpu_torch.scalar import ops as aes
from aesara_tpu_torch.tensor import basic as ptb, math as ptm
from aesara_tpu_torch.tensor.rewriting.elemwise import FusionOptimizer as PFusion
from aesara_tpu_torch.tensor.type import TensorType as PTensorType
from aesara_tpu_torch.config import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


def _graph(TensorType, tm, which):
    """One of the encoder's or the optimizers' Composites as a small graph:
    (inputs, output)."""
    full = TensorType("float32", (None, None, None))
    col = TensorType("float32", (None, None, 1))
    one = TensorType("float32", (1, 1, 1))
    row = TensorType("float32", (1, 1, None))
    flag = TensorType("bool", (None, None, None))
    switch = (jtb if tm is jtm else ptb).switch

    def c(v):   # a constant of the graph's rank, so that it needs no DimShuffle
        return np.full((1, 1, 1), v, dtype="float32")

    if which == "adamw_param":          # p - lr (m / bc1) / (sqrt(v / bc2) + eps) - lr wd p
        p, m, v, bc1, bc2, lr = full("p"), full("m"), full("v"), one("bc1"), one("bc2"), one("lr")
        step = lr * tm.true_div(m, bc1) / (tm.sqrt(tm.true_div(v, bc2)) + c(1e-8))
        return [p, m, v, bc1, bc2, lr], p - step - lr * c(0.01) * p
    if which == "clip_scale":           # g * minimum(1, max_norm / maximum(norm, 1e-12))
        g, norm = full("g"), one("norm")
        return [g, norm], g * tm.minimum(c(1.0), c(1.0) / tm.maximum(norm, c(1e-12)))
    if which == "warmup_cosine":        # the schedule at every step s
        s = full("s")
        warm = c(1e-3) * s / c(2.0)
        progress = tm.minimum((s - c(2.0)) / c(11.0), c(1.0))
        cos = c(0.5e-3) * (c(1.0) + tm.cos(c(np.pi) * progress))
        return [s], switch(tm.lt(s, c(2.0)), warm, cos)
    if which == "bias_pow":             # m / (1 - pow(b1, t))
        m, t = full("m"), one("t")
        return [m, t], m / (c(1.0) - tm.pow(c(0.9), t))
    if which == "nonfinite":            # isnan(g) | isinf(g) of an unscaled gradient: a bool output
        g = full("g")
        return [g], tm.or_(tm.isnan(g), tm.isinf(g))
    if which == "skip":                 # switch(finite, p - lr g, p) on bool operands
        a, b, p, g, lr = flag("a"), flag("b"), full("p"), full("g"), one("lr")
        finite = tm.and_(tm.eq(a, np.zeros((1, 1, 1), dtype="int8")), tm.eq(b, np.zeros((1, 1, 1), dtype="int8")))
        return [a, b, p, g, lr], switch(finite, p - lr * g, p)
    if which == "ln_centre":            # x - sum / n
        x, s, n = full("x"), col("s"), one("n")
        return [x, s, n], tm.sub(x, tm.true_div(s, n))
    if which == "ln_scale":             # g * xc / sqrt(ss / n + eps) + b
        g, xc, ss, n, b = row("g"), full("xc"), col("ss"), one("n"), row("b")
        var = tm.add(tm.true_div(ss, n), np.full((1, 1, 1), 1e-5, dtype="float32"))
        return [g, xc, ss, n, b], tm.add(tm.true_div(tm.mul(g, xc), tm.sqrt(var)), b)
    y, b = full("y"), row("b")          # maximum(y + b, 0)
    return [y, b], tm.maximum(tm.add(y, b), np.zeros((1, 1, 1), dtype="float32"))


def _fused_node(FunctionGraph, Fusion, inputs, out):
    fg = FunctionGraph(inputs, [out], clone=False)
    Fusion().rewrite(fg)
    (node,) = fg.toposort()
    assert type(node.op.scalar_op).__name__ == "Composite"
    return node


def _values(which, shape, rng):
    B, T, D = shape
    full, one = (B, T, D), (1, 1, 1)
    shapes = {
        "ln_centre": [(B, T, D), (B, T, 1), (1, 1, 1)],
        "ln_scale": [(1, 1, D), (B, T, D), (B, T, 1), (1, 1, 1), (1, 1, D)],
        "bias_relu": [(B, T, D), (1, 1, D)],
        "adamw_param": [full, full, full, one, one, one],
        "clip_scale": [full, one],
        "warmup_cosine": [full],
        "bias_pow": [full, one],
        "nonfinite": [full],
        "skip": [full, full, full, full, one],
    }[which]
    vals = [rng.normal(size=s).astype("float32") for s in shapes]
    if which == "adamw_param":
        vals[2] = np.abs(vals[2]) * 1e-4                 # second moments
        vals[3:] = [np.full(one, c, dtype="float32") for c in (0.271, 0.002997, 1e-3)]
    if which == "clip_scale":
        vals[1] = np.full(one, 3.5, dtype="float32")
    if which == "warmup_cosine":
        vals[0] = rng.integers(0, 20, size=full).astype("float32")
    if which == "bias_pow":
        vals[1] = np.full(one, 3.0, dtype="float32")
    if which == "nonfinite":
        vals[0].reshape(-1)[:5] = [np.nan, np.inf, -np.inf, 3e38, -0.0]
    if which == "skip":
        vals[0], vals[1] = vals[0] > 1.0, vals[1] > 1.0
    if which == "ln_scale":
        vals[2] = np.abs(vals[2]) * D + 0.5   # a sum of squares
        vals[3] = np.full((1, 1, 1), D, dtype="float32")
    if which == "ln_centre":
        vals[2] = np.full((1, 1, 1), D, dtype="float32")
    return vals


CASES = ["ln_centre", "ln_scale", "bias_relu"]
OPTIMIZER_CASES = ["adamw_param", "clip_scale", "warmup_cosine", "bias_pow", "nonfinite", "skip"]


@pytest.mark.parametrize("shape", [(2, 16, 64), (3, 7, 37)], ids=["even", "ragged"])
@pytest.mark.parametrize("which", CASES + OPTIMIZER_CASES)
def test_plain_k1_matches_pallas_interpret_and_xla(which, shape):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(7)
    vals = _values(which, shape, rng)
    jnode = _fused_node(JFunctionGraph, JFusion, *_graph(JTensorType, jtm, which))
    pnode = _fused_node(PFunctionGraph, PFusion, *_graph(PTensorType, ptm, which))
    # leaves come out in the same order from both fusion passes
    assert [v.name for v in jnode.inputs] == [v.name for v in pnode.inputs]

    out_dtype = pnode.outputs[0].type.dtype
    kernel = ElemwiseKernel(pnode.op.scalar_op, [i.type.dtype for i in pnode.inputs], out_dtype)
    before = fused_elemwise.plain_calls
    got = fused_elemwise(kernel, *[torch.from_numpy(v) for v in vals]).numpy()
    assert fused_elemwise.plain_calls == before + 1

    comp = jnode.op.scalar_op
    want_xla = np.asarray(composite_jax_impl(comp)(*[jnp.asarray(v) for v in vals]))
    out_shape = np.broadcast_shapes(*[v.shape for v in vals])
    assert got.shape == want_xla.shape == out_shape
    assert got.dtype == np.dtype(out_dtype) == want_xla.dtype
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-6)
    if all(v.dtype == np.dtype(out_dtype) for v in vals):
        with pltpu.force_tpu_interpret_mode():
            fn = composite_pallas_fn(comp, np.dtype(out_dtype))
            want_pallas = np.asarray(fn(*[jnp.asarray(np.broadcast_to(v, out_shape)) for v in vals]))
        assert want_pallas.shape == out_shape
        np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)
    else:
        assert which in ("nonfinite", "skip")


@pytest.mark.parametrize("which", CASES + OPTIMIZER_CASES)
def test_generated_triton_source_parses(which):
    pnode = _fused_node(PFunctionGraph, PFusion, *_graph(PTensorType, ptm, which))
    out_dtype = pnode.outputs[0].type.dtype
    kernel = ElemwiseKernel(pnode.op.scalar_op, [i.type.dtype for i in pnode.inputs], out_dtype)
    for ndim, wide in [(0, False), (1, False), (2, False), (3, False), (2, True)]:
        src = kernel.source(ndim, wide)
        assert ("pid.to(tl.int64)" in src) == wide
        tree = ast.parse(src)
        (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
        assert fn.name == "kernel"
        n_args = 1 + len(pnode.inputs) + 1 + ndim + ndim * len(pnode.inputs) + 1
        assert len(fn.args.args) == n_args
    src = kernel.source(2)
    forms = {"ln_centre": ["tl.math.div_rn"], "ln_scale": ["tl.math.div_rn", "tl.sqrt_rn"],
             "bias_relu": ["tl.where"], "adamw_param": ["tl.math.div_rn", "tl.sqrt_rn"],
             "clip_scale": ["tl.where", "tl.math.div_rn"], "warmup_cosine": ["libdevice.cos", "tl.where"],
             "bias_pow": ["libdevice.pow"], "nonfinite": ["float('inf')", "tl.store(out_ptr + offs, "
                                                          "result.to(tl.int1)"],
             "skip": ["tl.where(", " & "]}[which]
    for form in forms:
        assert form in src, form


def _one_op_composite(name):
    """A Composite of one scalar op K1 takes, over float32 operands (bool
    ones for the logical ops)."""
    f, b = aes.ScalarType("float32"), aes.ScalarType("bool")
    x, y, z = f(), f(), f()
    p, q = b(), b()
    ops = {
        "pow": ([x, y], aes.pow(x, y)), "abs": ([x], aes.abs_(x)), "sgn": ([x], aes.sgn(x)),
        "minimum": ([x, y], aes.minimum(x, y)), "gt": ([x, y], aes.gt(x, y)), "le": ([x, y], aes.le(x, y)),
        "eq": ([x, y], aes.eq(x, y)), "neq": ([x, y], aes.neq(x, y)), "isnan": ([x], aes.isnan(x)),
        "isinf": ([x], aes.isinf(x)), "and": ([p, q], aes.and_(p, q)), "or": ([p, q], aes.or_(p, q)),
        "invert": ([p], aes.invert(p)), "switch": ([p, x, y], aes.switch(p, x, y)),
        "identity": ([x], aes.identity(x)), "log": ([x], aes.log(x)), "cos": ([x], aes.cos(x)),
        "sin": ([x], aes.sin(x)), "clip": ([x, y, z], aes.clip_scalar(x, y, z)),
    }
    ins, out = ops[name]
    return PComposite(ins, [out])


SCALAR_FORMS = {
    "pow": "libdevice.pow(", "abs": "tl.abs(", "sgn": "!= x0", "minimum": " < ", "gt": " > ", "le": " <= ",
    "eq": " == ", "neq": " != ", "isnan": "x0.to(tl.float32) != x0.to(tl.float32)", "isinf": "float('inf')",
    "and": " & ", "or": " | ", "invert": "== 0", "switch": "tl.where(x0.to(tl.int1)", "identity": "v0 = (x0",
    "log": "libdevice.log(", "cos": "libdevice.cos(", "sin": "libdevice.sin(", "clip": "tl.where(",
}


@pytest.mark.parametrize("name", sorted(SCALAR_FORMS))
def test_every_scalar_op_has_a_triton_form_that_parses(name):
    comp = _one_op_composite(name)
    out_dtype = comp.outputs[0].type.dtype
    kernel = ElemwiseKernel(comp, [i.type.dtype for i in comp.inputs], out_dtype)
    for ndim in (0, 1, 3):
        src = kernel.source(ndim)
        ast.parse(src)
        assert SCALAR_FORMS[name] in src
        assert f"result.to({'tl.int1' if out_dtype == 'bool' else 'tl.float32'})" in src


def _emulate_launch(kernel, args):
    """What the generated kernel computes, from its launch plan: every
    output element's operand offsets by the kernel's own index math."""
    shape, n, sizes, strides, wide = launch_plan(args)
    ndim = len(sizes)
    offs = np.arange(n)
    idx, rem = [], offs
    for d in reversed(range(ndim)):
        idx.insert(0, rem % sizes[d] if d else rem)
        rem = rem // sizes[d]
    operands = []
    for i, a in enumerate(args):
        st = strides[i]
        off = sum((ix * s for ix, s in zip(idx, st)), np.zeros(n, dtype=np.int64))
        assert a.is_contiguous()
        operands.append(torch.from_numpy(a.flatten().numpy()[off]))
    flat = composite_plain(kernel.composite, kernel.out_dtype, *operands)
    return flat.reshape(shape)


@pytest.mark.parametrize("which", CASES)
def test_launch_plan_reads_the_right_elements(which):
    pnode = _fused_node(PFunctionGraph, PFusion, *_graph(PTensorType, ptm, which))
    kernel = ElemwiseKernel(pnode.op.scalar_op, [i.type.dtype for i in pnode.inputs], "float32")
    vals = [torch.from_numpy(v) for v in _values(which, (3, 5, 7), np.random.default_rng(2))]
    shape, n, sizes, _, wide = launch_plan(vals)
    assert shape == (3, 5, 7) and n == 105 and not wide
    assert sizes == [15, 7]     # (3, 5) merge for every operand, the last dim does not
    want = composite_plain(kernel.composite, "float32", *vals)
    np.testing.assert_array_equal(_emulate_launch(kernel, vals).numpy(), want.numpy())


def test_generator_rejects_an_op_without_triton_form():
    from aesara_tpu_torch.scalar.ops import ScalarOp, ScalarType

    class Erf(ScalarOp):
        nin = 1

    x = ScalarType("float32")()
    comp = PComposite([x], [Erf()(x)])
    with pytest.raises(NotImplementedError, match="erf"):
        ElemwiseKernel(comp, ["float32"], "float32")


def test_runtime_broadcast_of_unknown_dim_raises():
    import aesara_tpu_torch as ptp

    x = PTensorType("float32", (None, None))("x")
    y = PTensorType("float32", (None, None))("y")
    f = ptp.function([x, y], ptm.maximum(ptm.add(x, y), 0.0))
    ok = f(np.ones((2, 3), "float32"), np.ones((2, 3), "float32"))
    assert ok.shape == (2, 3)
    with pytest.raises(ValueError, match="runtime broadcasting"):
        f(np.ones((2, 3), "float32"), np.ones((1, 3), "float32"))


# ---------------------------------------------------------------------------
# integer pow, wide unsigned types and non-finite constants: each compiled
# by both packages (JAX FAST_RUN against the port on the CPU, exact), and
# the port's generated Triton source checked to parse and name only what
# it defines
# ---------------------------------------------------------------------------

def _function(m, inputs, out):
    import aesara_tpu
    import aesara_tpu_torch

    if m == "jax":
        return aesara_tpu.function(inputs, out, mode="FAST_RUN")
    return aesara_tpu_torch.function(inputs, out)


def _both(build, *vals):
    """(JAX's result, the port's result, the port's fused Elemwise node)."""
    jf = _function("jax", *build(JTensorType, jtm, jtb))
    pf = _function("port", *build(PTensorType, ptm, ptb))
    (pnode,) = [n for n in pf.maker.fgraph.toposort() if type(n.op).__name__ == "Elemwise"]
    return np.asarray(jf(*vals)), pf(*vals).numpy(), pnode


def _source_names_resolve(src):
    """Every name the generated module reads is defined in it, is a
    function's parameter or local, or is a Python builtin."""
    import builtins

    tree = ast.parse(src)
    module = {a.asname or a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
              for a in n.names}
    module |= {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    for fn in [n for n in tree.body if isinstance(n, ast.FunctionDef)]:
        local = {a.arg for a in fn.args.args} | {n.id for n in ast.walk(fn)
                                                 if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
        for n in ast.walk(fn):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                assert n.id in module | local or hasattr(builtins, n.id), (fn.name, n.id)


def _kernel_source(node, ndim=1):
    kernel = ElemwiseKernel(node.op.scalar_op, [i.type.dtype for i in node.inputs], node.outputs[0].type.dtype)
    src = kernel.source(ndim)
    _source_names_resolve(src)
    return src


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64", "uint8", "uint32"])
@pytest.mark.parametrize("exponent", ["tensor", "constant"])
def test_integer_pow_matches_jax(dtype, exponent):
    rng = np.random.default_rng(11)
    lo = 0 if dtype.startswith("uint") else -7
    xv = rng.integers(lo, 101, size=40).astype(dtype)
    yv = rng.integers(0, 10, size=40).astype(dtype)
    xv[:6] = [0, 1, 2, 3, 100, 7]       # 100 ** 9 wraps in every type here
    yv[:6] = [0, 5, 31, 3, 9, 0]

    def build(T, tm, tb):
        x, y = T(dtype, (None,))("x"), T(dtype, (None,))("y")
        if exponent == "constant":
            return [x], tm.pow(x, np.asarray(3, dtype)) + np.asarray(1, dtype)
        return [x, y], tm.pow(x, y) + np.asarray(1, dtype)

    vals = (xv,) if exponent == "constant" else (xv, yv)
    want, got, node = _both(build, *vals)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    src = _kernel_source(node)
    assert "ipow(" in src and ("True)" in src) == (not dtype.startswith("uint"))


@pytest.mark.parametrize("dtype", ["int8", "int32", "int64"])
def test_negative_integer_pow_is_the_integer_result(dtype):
    import aesara_tpu_torch

    x, y = PTensorType(dtype, (None,))("x"), PTensorType(dtype, (None,))("y")
    f = aesara_tpu_torch.function([x, y], ptm.pow(x, y) * np.asarray(1, dtype))
    xv = np.asarray([1, -1, -1, 2, -3, 0, 5, 1], dtype)
    yv = np.asarray([-4, -3, -2, -1, -2, -1, 2, 0], dtype)
    # the exact integer: 1 for base 1, +-1 for base -1, 0 for any other
    # base; a non-negative exponent as usual
    np.testing.assert_array_equal(f(xv, yv).numpy(), [1, -1, 1, 0, 0, 0, 25, 1])
    a, b = aes.ScalarType(dtype)(), aes.ScalarType(dtype)()
    src = ElemwiseKernel(PComposite([a, b], [aes.pow(a, b)]), [dtype, dtype], dtype).source(1)
    _source_names_resolve(src)
    assert f"ipow(x0.to(tl.{dtype}), x1.to(tl.{dtype}), {8 * np.dtype(dtype).itemsize}, True)" in src
    with pytest.raises(ValueError, match="negative integer powers"):
        aesara_tpu_torch.function([x], ptm.pow(x, np.asarray(-2, dtype)) + np.asarray(1, dtype))
    with pytest.raises(ValueError, match="negative integer powers"):
        aesara_tpu_torch.function([x], ptm.pow(x, np.asarray([2, -1], dtype)))


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
@pytest.mark.parametrize("which", ["mul_add", "ordered", "casts"])
def test_wide_unsigned_chain_matches_jax(dtype, which):
    rng = np.random.default_rng(12)
    info = np.iinfo(dtype)
    xv = rng.integers(0, info.max, size=50, dtype=dtype, endpoint=True)
    yv = rng.integers(0, info.max, size=50, dtype=dtype, endpoint=True)
    xv[:4] = [0, 1, 2, info.max]
    yv[:4] = [0, 2, 1, info.max // 2 + 1]      # across the sign bit of the same width

    def build(T, tm, tb):
        x, y = T(dtype, (None,))("x"), T(dtype, (None,))("y")
        if which == "mul_add":
            return [x], x * x + x
        if which == "ordered":      # comparisons, maximum, minimum, abs and a wrapping negation
            return [x, y], tb.switch(tm.gt(x, y), tm.maximum(x, y) - y, -tm.abs(x)) + tm.minimum(x, y) * \
                tm.ge(x, y)
        return [x, y], tb.cast(tb.cast(x, "float64") * 0.5, dtype) + tb.cast(tm.lt(x, y), dtype)

    vals = (xv,) if which == "mul_add" else (xv, yv)
    want, got, node = _both(build, *vals)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    src = _kernel_source(node, ndim=2)
    assert f"tl.{dtype}" in src


@pytest.mark.parametrize("value", [-np.inf, np.inf, np.nan])
def test_nonfinite_constants_generate_a_source_whose_names_resolve(value):
    xv = np.asarray([1.0, np.nan, -2.0, np.inf], "float32")

    def build(T, tm, tb):
        x = T("float32", (None,))("x")
        return [x], tb.switch(tm.isnan(x), np.float32(value), x) * 2.0

    want, got, node = _both(build, xv)
    np.testing.assert_array_equal(got, want)
    src = _kernel_source(node)
    assert f"float('{float(value)}')" in src
