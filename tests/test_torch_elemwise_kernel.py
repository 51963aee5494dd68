"""K1, the fused-Composite kernel: its plain PyTorch version against the
JAX package's Pallas kernel (interpret mode) and its XLA closure, on the
three Composites the encoder forward builds; and the generated Triton
source of each parses.  fp32 tolerance: rtol 1e-5, atol 1e-6."""

import ast

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aesara_tpu.graph.fg import FunctionGraph as JFunctionGraph
from aesara_tpu.link.jax.dispatch import composite_jax_impl
from aesara_tpu.link.jax.pallas_kernels import composite_pallas_fn
from aesara_tpu.tensor import math as jtm
from aesara_tpu.tensor.rewriting.elemwise import FusionOptimizer as JFusion
from aesara_tpu.tensor.type import TensorType as JTensorType

from aesara_tpu_torch.graph.fg import FunctionGraph as PFunctionGraph
from aesara_tpu_torch.link.torch.kernels.elemwise import (
    ElemwiseKernel, composite_plain, fused_elemwise, launch_plan,
)
from aesara_tpu_torch.scalar.composite import Composite as PComposite
from aesara_tpu_torch.tensor import math as ptm
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
    """One of the encoder's Composites as a small graph: (inputs, output)."""
    full = TensorType("float32", (None, None, None))
    col = TensorType("float32", (None, None, 1))
    one = TensorType("float32", (1, 1, 1))
    row = TensorType("float32", (1, 1, None))
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
    shapes = {
        "ln_centre": [(B, T, D), (B, T, 1), (1, 1, 1)],
        "ln_scale": [(1, 1, D), (B, T, D), (B, T, 1), (1, 1, 1), (1, 1, D)],
        "bias_relu": [(B, T, D), (1, 1, D)],
    }[which]
    vals = [rng.normal(size=s).astype("float32") for s in shapes]
    if which == "ln_scale":
        vals[2] = np.abs(vals[2]) * D + 0.5   # a sum of squares
        vals[3] = np.full((1, 1, 1), D, dtype="float32")
    if which == "ln_centre":
        vals[2] = np.full((1, 1, 1), D, dtype="float32")
    return vals


CASES = ["ln_centre", "ln_scale", "bias_relu"]


@pytest.mark.parametrize("shape", [(2, 16, 64), (3, 7, 37)], ids=["even", "ragged"])
@pytest.mark.parametrize("which", CASES)
def test_plain_k1_matches_pallas_interpret_and_xla(which, shape):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(7)
    vals = _values(which, shape, rng)
    jnode = _fused_node(JFunctionGraph, JFusion, *_graph(JTensorType, jtm, which))
    pnode = _fused_node(PFunctionGraph, PFusion, *_graph(PTensorType, ptm, which))
    # leaves come out in the same order from both fusion passes
    assert [v.name for v in jnode.inputs] == [v.name for v in pnode.inputs]

    kernel = ElemwiseKernel(pnode.op.scalar_op, [i.type.dtype for i in pnode.inputs], "float32")
    before = fused_elemwise.plain_calls
    got = fused_elemwise(kernel, *[torch.from_numpy(v) for v in vals]).numpy()
    assert fused_elemwise.plain_calls == before + 1

    comp = jnode.op.scalar_op
    want_xla = np.asarray(composite_jax_impl(comp)(*[jnp.asarray(v) for v in vals]))
    out_shape = np.broadcast_shapes(*[v.shape for v in vals])
    with pltpu.force_tpu_interpret_mode():
        fn = composite_pallas_fn(comp, np.dtype("float32"))
        want_pallas = np.asarray(fn(*[jnp.asarray(np.broadcast_to(v, out_shape)) for v in vals]))
    assert got.shape == want_pallas.shape == out_shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", CASES)
def test_generated_triton_source_parses(which):
    pnode = _fused_node(PFunctionGraph, PFusion, *_graph(PTensorType, ptm, which))
    kernel = ElemwiseKernel(pnode.op.scalar_op, [i.type.dtype for i in pnode.inputs], "float32")
    for ndim, wide in [(0, False), (1, False), (2, False), (3, False), (2, True)]:
        src = kernel.source(ndim, wide)
        assert ("pid.to(tl.int64)" in src) == wide
        tree = ast.parse(src)
        (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
        assert fn.name == "kernel"
        n_args = 1 + len(pnode.inputs) + 1 + ndim + ndim * len(pnode.inputs) + 1
        assert len(fn.args.args) == n_args
    src = kernel.source(2)
    if which != "bias_relu":
        assert "tl.math.div_rn" in src
    if which == "ln_scale":
        assert "tl.sqrt_rn" in src


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
