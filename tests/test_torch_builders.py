"""``OpFromGraph``, ``RematBarrier`` and ``remat``: the port against the JAX
package on the CPU (``aesara_tpu/compile/builders.py``).

The subgraph op's forward, gradient, ``inline=True`` expansion, hidden
inputs (a shared variable the subgraph reads), ``connection_pattern``,
``infer_shape`` and a ``lop_overrides`` callable are held against the JAX
package within 1e-6 (float64 inputs: the two compute the same products).
``remat`` must give the gradients of the graph without it, bit for bit in
float32 and float64, keep its ``RematBarrier`` nodes (no two merged)
through the port's rewrites, and the 2-layer encoder step with ``remat``
on each layer in bfloat16 must agree with the JAX package's same step as
``test_torch_bf16.py`` holds the step without it, and so must its
gradients, which are also bit for bit those without ``remat``.
"""

import numpy as np
import pytest
import torch

import ml_dtypes

import aesara_tpu
import aesara_tpu.tensor as jt
from aesara_tpu.compile.builders import OpFromGraph as JOFG, remat as jremat
from aesara_tpu.compile.function import Out as JOut
from aesara_tpu.gradient import grad as jgrad
from aesara_tpu.models.optim import sgd as jsgd
from aesara_tpu.models.transformer import TransformerEncoderLayer as JLayer
from aesara_tpu.tensor import math as jtm

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch.compile.builders import OpFromGraph as POFG, Remat, RematBarrier, remat as premat
from aesara_tpu_torch.compile.io import Out as POut
from aesara_tpu_torch.config import config
from aesara_tpu_torch.gradient import grad as pgrad
from aesara_tpu_torch.link.torch.control_dispatch import fused_ofg_graph
from aesara_tpu_torch.misc.safe_asarray import _asarray
from aesara_tpu_torch.models.optim import sgd as psgd
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as PLayer
from aesara_tpu_torch.tensor import math as ptm
from tests.test_torch_bf16 import jax_flash


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, t=jt, tm=jtm, OFG=JOFG, grad=jgrad, remat=jremat)
PORT = dict(pkg=aesara_tpu_torch, t=pt, tm=ptm, OFG=POFG, grad=pgrad, remat=premat)
TOL = 1e-6


def f64(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().double().numpy()
    return np.asarray(v).astype(np.float64)


def _ofg_graph(m, inline=False, override=False):
    """(inputs, outputs) of a function over a two-output OpFromGraph whose
    subgraph also reads a shared variable (a hidden input)."""
    t, tm = m["t"], m["tm"]
    s = m["pkg"].shared(np.linspace(0.5, 1.5, 6).reshape(2, 3), name="s")
    x, y = t.dmatrix("x"), t.dmatrix("y")
    kwargs = {"inline": inline}
    if override:
        kwargs["lop_overrides"] = lambda inputs, gs: [gs[0] * 2.0, gs[1] * 3.0] + [
            t.zeros_like(i) for i in inputs[2:]]
    op = m["OFG"]([x, y], [tm.tanh(x) * y + s, tm.dot(x, y.T) * tm.sum(s)], **kwargs)
    a, b = t.dmatrix("a"), t.dmatrix("b")
    u, v = op(a, b)
    cost = tm.sum(tm.sqr(u)) + tm.sum(v)
    return op, [a, b], [u, v] + m["grad"](cost, [a, b])


INPUTS = [np.random.default_rng(1).normal(size=(2, 3)), np.random.default_rng(2).normal(size=(2, 3))]


@pytest.mark.parametrize("inline", [False, True], ids=["node", "inline"])
@pytest.mark.parametrize("override", [False, True], ids=["own_grad", "lop_overrides"])
def test_op_from_graph_forward_and_grad(inline, override):
    _, ins, outs = _ofg_graph(JAX, inline, override)
    want = aesara_tpu.function(ins, outs)(*INPUTS)
    op, ins, outs = _ofg_graph(PORT, inline, override)
    f = aesara_tpu_torch.function(ins, outs)
    got = f(*INPUTS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(f64(g), f64(w), rtol=TOL, atol=TOL)
    kept = [node for node in f.fn.program.order if isinstance(node.op, POFG)]
    # inline=True expands the node into the step's graph (specialize)
    assert len(kept) == (0 if inline else 1)


def test_op_from_graph_hidden_inputs_pattern_and_shapes():
    op, _, _ = _ofg_graph(PORT)
    jop, _, _ = _ofg_graph(JAX)
    assert op.n_explicit == 2 and op.n_extra == jop.n_extra == 1
    x = pt.dmatrix("x")
    node = op(x, x)[0].owner
    assert op.connection_pattern(node) == jop.connection_pattern(jop(jt.dmatrix("x"), jt.dmatrix("y"))[0].owner)
    assert op.connection_pattern(node) == [[True, True], [True, True], [True, True]]
    shapes = op.infer_shape(None, node, [None] * 3)
    f = aesara_tpu_torch.function([x], [d for shape in shapes for d in shape])
    assert [int(v) for v in f(np.zeros((2, 3)))] == [2, 3, 2, 2]
    # the op's own graph is left as built; the lowering rewrites a copy
    n_before = len(op.fgraph.apply_nodes)
    fused = fused_ofg_graph(op)
    assert len(op.fgraph.apply_nodes) == n_before
    assert any(type(n.op.scalar_op).__name__ == "Composite" for n in fused.apply_nodes
               if hasattr(n.op, "scalar_op"))


def _chain(m, dtype, use_remat):
    """A three-block chain through shared weights; with ``use_remat`` each
    block is a ``remat`` node.  Returns the cost's gradient function."""
    t, tm = m["t"], m["tm"]
    rng = np.random.default_rng(3)
    ws = [m["pkg"].shared(rng.normal(size=(8, 8)).astype(dtype) * 0.3, name=f"w{i}") for i in range(3)]
    x = t.matrix("x", dtype=dtype)
    h = x
    for w in ws:
        z = tm.tanh(tm.dot(h, w)) + h * 0.5
        h = m["remat"]([h, w], [z])(h, w) if use_remat else z
    cost = tm.sum(tm.sqr(h))
    return m["pkg"].function([x], [cost] + m["grad"](cost, [x] + ws))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_remat_gradients_are_bitwise_those_without_it(dtype):
    xv = np.random.default_rng(4).normal(size=(5, 8)).astype(dtype)
    plain = _chain(PORT, dtype, False)(xv)
    with_remat = _chain(PORT, dtype, True)(xv)
    for a, b in zip(plain, with_remat):
        assert torch.equal(a, b)
    ref = _chain(JAX, dtype, True)(xv)
    for a, r in zip(with_remat, ref):
        np.testing.assert_allclose(f64(a), f64(r), rtol=1e-5 if dtype == "float32" else 1e-12, atol=1e-6)


def test_remat_barriers_survive_the_rewrites_unmerged():
    f = _chain(PORT, "float64", True)
    order = f.fn.program.order
    barriers = [n for n in order if isinstance(n.op, RematBarrier)]
    # each block's two inputs fenced once, by a barrier of the block's nonce
    assert len(barriers) == 6
    assert len({n.op.nonce for n in barriers}) == 3
    assert sum(isinstance(n.op, Remat) for n in order) == 3
    # two barriers of one input are two nodes: the merge pass keeps both
    x = pt.dvector("x")
    f2 = aesara_tpu_torch.function([x], [RematBarrier(1)(x) * 2.0, RematBarrier(2)(x) * 2.0])
    assert sum(isinstance(n.op, RematBarrier) for n in f2.fn.program.order) == 2
    assert [f64(v).tolist() for v in f2(np.ones(2))] == [[2.0, 2.0], [2.0, 2.0]]


def _encoder_remat_step(m, layer_cls, shared, out, sgd, x_value):
    layers = [layer_cls(64, 4, 128, seed=i) for i in range(2)]
    x = shared(x_value, name="x")
    h = x
    for layer in layers:
        h = m["remat"]([h] + layer.params, [layer(h)])(h, *layer.params)
    loss = m["tm"].mean(m["tm"].sqr(h))
    params = [p for layer in layers for p in layer.params]
    return m["pkg"].function([], out(loss, borrow=True), updates=sgd(loss, params, lr=0.01)), params


def _encoder_remat_grads(m, layer_cls, x_value, use_remat=True, start=None):
    """The loss and the gradient of each parameter of the 2-layer encoder,
    each layer a ``remat`` node (or not), as the package returns them;
    ``start`` overrides the parameters."""
    layers = [layer_cls(64, 4, 128, seed=i) for i in range(2)]
    params = [p for layer in layers for p in layer.params]
    for p, v in zip(params, start or ()):
        p.set_value(v)
    h = m["pkg"].shared(x_value, name="x")
    for layer in layers:
        h = m["remat"]([h] + layer.params, [layer(h)])(h, *layer.params) if use_remat else layer(h)
    loss = m["tm"].mean(m["tm"].sqr(h))
    return m["pkg"].function([], [loss] + m["grad"](loss, params))(), ["loss"] + [p.name for p in params]


def test_encoder_gradients_with_remat_in_bfloat16():
    """The gradients themselves (an sgd step at lr 0.01 leaves most
    bfloat16 weights as they were, so the parameters after the steps
    below barely show them): bit for bit those of the graph without
    remat, and within 2e-2 of each gradient's scale plus the JAX
    package's own distance from the float64 gradients of the same
    bfloat16 start, against the JAX package's with remat, which runs its
    flash-attention kernels in interpret mode (they round where K2 and K3
    round, ``tests/test_torch_bf16.py::jax_flash``)."""
    x64 = np.random.default_rng(0).normal(size=(2, 16, 64)) * 0.1
    with aesara_tpu.config.change_flags(floatX="bfloat16"), jax_flash("bfloat16"):
        want, names = _encoder_remat_grads(JAX, JLayer, x64.astype(ml_dtypes.bfloat16))
    with config.change_flags(floatX="bfloat16"):
        got, _ = _encoder_remat_grads(PORT, PLayer, _asarray(x64, "bfloat16"))
        plain, _ = _encoder_remat_grads(PORT, PLayer, _asarray(x64, "bfloat16"), use_remat=False)
        start = [f64(q.get_value()) for i in range(2) for q in PLayer(64, 4, 128, seed=i).params]
    with config.change_flags(floatX="float64"):
        exact, _ = _encoder_remat_grads(PORT, PLayer, f64(_asarray(x64, "bfloat16")), start=start)
    for name, g, p, w, e in zip(names, got, plain, want, exact):
        assert g.dtype == torch.bfloat16 and torch.equal(g, p), name
        g, w, e = f64(g), f64(w), f64(e)
        err, own = np.abs(g - w).max(), np.abs(w - e).max()
        assert err <= 2e-2 * np.abs(w).max() + own, (name, err, own)


def test_encoder_step_with_remat_in_bfloat16_against_the_jax_package():
    """The bfloat16 graph of ``bench_transformer.run_model_scale_remat`` at
    2 layers of (64, 4, 128): both packages keep the Remat nodes, the
    barriers and the fused attention in their compiled graphs, and two
    steps' losses and parameters agree as ``test_torch_bf16.py`` holds the
    step without remat: within 2e-2 of each tensor's scale plus the JAX
    package's own distance from the float64 run of the same steps from the
    same bfloat16 start."""
    x64 = np.random.default_rng(0).normal(size=(2, 16, 64)) * 0.1
    with aesara_tpu.config.change_flags(floatX="bfloat16"):
        jstep, jparams = _encoder_remat_step(JAX, JLayer, aesara_tpu.shared, JOut, jsgd,
                                             x64.astype(ml_dtypes.bfloat16))
        jloss = [f64(jstep()) for _ in range(2)]
    with config.change_flags(floatX="bfloat16"):
        pstep, pparams = _encoder_remat_step(PORT, PLayer, aesara_tpu_torch.shared, POut, psgd,
                                             _asarray(x64, "bfloat16"))
        start = [f64(p.get_value()) for p in pparams]
        ploss = [f64(pstep()) for _ in range(2)]
    with config.change_flags(floatX="float64"):
        estep, eparams = _encoder_remat_step(PORT, PLayer, aesara_tpu_torch.shared, POut, psgd,
                                             f64(_asarray(x64, "bfloat16")))
        for p, v in zip(eparams, start):
            p.set_value(v)
        for _ in range(2):
            estep()
    names = [type(n.op).__name__ for n in pstep.fn.program.order]
    jnames = [type(n.op).__name__ for n in jstep.maker.fgraph.apply_nodes]
    for op in ("Remat", "RematBarrier", "FusedAttention", "FusedAttentionGrad"):
        assert names.count(op) == jnames.count(op), op
    assert names.count("RematBarrier") == 24
    for a, b in zip(ploss, jloss):
        assert abs(a - b) <= 2e-2 * abs(b)
    for p, r, e in zip(pparams, jparams, eparams):
        assert p.type.dtype == "bfloat16"
        got, want, exact = f64(p.get_value()), f64(r.get_value()), f64(e.get_value())
        err, own = np.abs(got - want).max(), np.abs(want - exact).max()
        assert err <= 2e-2 * np.abs(want).max() + own, (p.name, err, own)
