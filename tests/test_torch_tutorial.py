"""What a user writes first, on the port and on the JAX package, on the
CPU at a small size (the programs of ``chip_smoke.py`` path (m)):

- (m1) ``examples/custom_op.py``: the ``SoftShrink`` Op with ``make_node``,
  ``perform`` and ``grad``, lowered by ``torch_funcify.register`` in the
  port, ``function([x], [y, grad(y.sum(), x)])`` and the example's
  assertions;
- (m2) ``doc/tutorial.md``'s "Graphs", "Functions, shared state, updates"
  and "Gradients" snippets (the gradient snippet's target is a matrix of
  ``dot(x, w)``'s shape: the "Graphs" snippet's ``y`` is (32, 8));
- (m3) reference config 3 (``benchmarks/bench_reference_ratio.py:146-250``)
  built only through methods (``x.dot(W)``, ``.max``, ``.sum``,
  ``.mean``) beside the same model built through the functions: the same
  ``FAST_RUN`` op counts and bitwise the same steps, and the JAX package's
  graph and values; and its evaluation function on the log-softmax of the
  logits (accuracy through ``argmax`` and ``astype``, ``max_and_argmax``,
  each weight's ``norm(2)``, ``isclose``/``allclose`` of two forms of the
  loss).

float32 values are held to the JAX package's within 1e-5 (relative and
absolute), as ``tests/test_torch_mlp.py`` holds config 3.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.graph.ir import Apply as JApply
from aesara_tpu.graph.op import Op as JOp

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.ir import Apply as PApply
from aesara_tpu_torch.graph.op import Op as POp
from aesara_tpu_torch.link.torch.dispatch import torch_funcify

from tests.test_torch_rnn import op_counts


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, mode="TORCH")
TOL = dict(rtol=1e-5, atol=1e-5)
B, DIN, H, DOUT, NBATCH = 8, 12, 16, 10, 10


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def soft_shrink_class(Op, Apply, at):
    class SoftShrink(Op):
        """soft-shrinkage: sign(x) * max(|x| - lambda, 0)"""

        __props__ = ("lambd",)

        def __init__(self, lambd: float = 0.5):
            self.lambd = float(lambd)

        def make_node(self, x):
            x = at.as_tensor_variable(x)
            return Apply(self, [x], [x.type()])

        def perform(self, node, inputs, output_storage):
            (x,) = inputs
            output_storage[0][0] = np.sign(x) * np.maximum(np.abs(x) - self.lambd, 0.0).astype(x.dtype)

        def grad(self, inputs, output_grads):
            (x,) = inputs
            (gz,) = output_grads
            pass_through = at.math.gt(at.math.abs(x), self.lambd)
            return [gz * pass_through.astype(x.dtype)]

    return SoftShrink


PSoftShrink = soft_shrink_class(POp, PApply, pat)


@torch_funcify.register(PSoftShrink)
def _lower_softshrink(op, node):
    lam = op.lambd
    return lambda x: torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


def test_m1_the_custom_op_example_runs_on_the_port():
    x = pat.vector("x")
    y = PSoftShrink(0.5)(x)
    f = aesara_tpu_torch.function([x], [y, aesara_tpu_torch.grad(y.sum(), x)])
    out, g = (_host(v) for v in f(np.array([-2.0, -0.3, 0.1, 1.5], dtype="float32")))
    assert np.allclose(out, [-1.5, 0.0, 0.0, 1.0])
    assert np.allclose(g, [1.0, 0.0, 0.0, 1.0])
    assert out.dtype == g.dtype == np.float32


def tutorial(m, rng):
    """The three snippets' functions and their results for package ``m``."""
    pkg, at = m["pkg"], m["at"]
    x = at.matrix("x")
    y = at.tensor("y", shape=(32, 8))
    z = at.exp(x) @ y + 1.0
    graphs = pkg.function([x, y], z, mode=m["mode"])
    w = pkg.shared(np.zeros((8, 4), dtype="float32"), name="w")
    out = at.tanh(at.dot(x, w))
    f = pkg.function([x], out, mode=m["mode"])
    step = pkg.function([x], out.sum(), updates={w: w * 0.9}, mode=m["mode"])
    target = at.matrix("t")
    loss = ((at.dot(x, w) - target) ** 2).mean()
    gw = pkg.grad(loss, w)
    grads = pkg.function([x, target], [loss, gw], mode=m["mode"])
    xa = rng.normal(size=(16, 32)).astype("float32") * 0.1
    xb = rng.normal(size=(16, 8)).astype("float32")
    ya = rng.normal(size=(32, 8)).astype("float32")
    ta = rng.normal(size=(16, 4)).astype("float32")
    w.set_value(rng.normal(size=(8, 4)).astype("float32"))
    res = [graphs(xa, ya), f(xb), step(xb), w.get_value()] + list(grads(xb, ta))
    pkg.verify_grad(lambda mat: at.tanh(mat).sum(), [rng.standard_normal((3, 3))])
    return [_host(r) for r in res], [graphs, f, step, grads]


def test_m2_the_tutorial_snippets_give_the_jax_packages_values_and_graphs():
    (jv, jf), (pv, pf) = (tutorial(m, np.random.default_rng(0)) for m in (JAX, PORT))
    for got, want in zip(pv, jv):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(pf, jf):
        assert op_counts(a.maker.fgraph) == op_counts(b.maker.fgraph)


def config3(m, methods: bool, seed: int = 0):
    """Config 3 as the benchmark builds it, through the functions or only
    through methods (with ``.astype`` and ``argmax`` in its evaluation):
    (step, eval function, parameters)."""
    pkg, at = m["pkg"], m["at"]
    rng = np.random.default_rng(seed)
    f32 = "float32"
    x, y, idx = at.matrix("x", dtype=f32), at.lvector("y"), at.iscalar("idx")
    sizes = [(DIN, H), (H, H), (H, DOUT)]
    ws = [pkg.shared((rng.normal(size=s) * (1.0 / np.sqrt(s[0]))).astype(f32)) for s in sizes]
    bs = [pkg.shared(np.zeros(s[1], dtype=f32)) for s in sizes]
    h = x
    for i, (wi, bi) in enumerate(zip(ws, bs)):
        h = (h.dot(wi) if methods else at.dot(h, wi)) + bi
        if i < 2:
            h = at.tanh(h)
    if methods:
        hmax = h.max(axis=1, keepdims=True)
        lse = at.log(at.exp(h - hmax).sum(axis=1)) + h.max(axis=1)
        loss = (lse - h[at.arange(y.shape[0]), y]).mean()
    else:
        lse = at.log(at.sum(at.exp(h - at.max(h, axis=1, keepdims=True)), axis=1)) + at.max(h, axis=1)
        loss = at.mean(lse - h[at.arange(y.shape[0]), y])
    params = ws + bs
    grads = pkg.grad(loss, params)
    lr = np.asarray(0.01, f32)
    Xd = pkg.shared(rng.normal(size=(NBATCH * B, DIN)).astype(f32), name="Xd")
    Yd = pkg.shared(rng.integers(0, DOUT, size=NBATCH * B).astype("int64"), name="Yd")
    givens = {x: Xd[idx * B:(idx + 1) * B], y: Yd[idx * B:(idx + 1) * B]}
    step = pkg.function([idx], [], updates={p: p - lr * g for p, g in zip(params, grads)}, givens=givens,
                        mode=m["mode"])
    logp = import_module(f"{pkg.__name__}.tensor.special").log_softmax(h)
    accuracy = at.eq(logp.argmax(axis=1, keepdims=False), y).astype(f32).mean()
    best, best_at = at.max_and_argmax(logp, axis=1)
    other = -logp[at.arange(y.shape[0]), y].mean()
    evaluate = pkg.function([idx], [accuracy, best, best_at] + [w.norm(2) for w in ws]
                            + [at.isclose(loss, other, rtol=1e-5, atol=1e-6), at.allclose(loss, other)],
                            givens=givens, mode=m["mode"])
    return step, evaluate, params


def structural(fn):
    """``op_counts`` of a function's graph but its Elemwise and Composite
    nodes."""
    return {k: v for k, v in op_counts(fn.maker.fgraph)[0].items() if not k.startswith(("Elemwise", "Composite"))}


def test_m3_config3_built_by_methods_is_config3_built_by_functions_and_the_jax_packages():
    runs = {}
    for name, m, methods in (("port_methods", PORT, True), ("port_functions", PORT, False),
                             ("jax_methods", JAX, True)):
        step, evaluate, params = config3(m, methods)
        trace = []
        for i in range(3):
            step(np.int32(i))
            trace.extend(_host(p.get_value()) for p in params)
        runs[name] = (trace, [_host(v) for v in evaluate(np.int32(0))], step, evaluate)
    assert op_counts(runs["port_methods"][2].maker.fgraph) == op_counts(runs["port_functions"][2].maker.fgraph)
    assert op_counts(runs["port_methods"][2].maker.fgraph) == op_counts(runs["jax_methods"][2].maker.fgraph)
    # the evaluation graph: the elementwise ops fuse into other Composites
    # in the JAX package, whose merge misses a second abs(loss) of
    # isclose/allclose (ROADMAP Queue 3), so its other ops are compared
    assert structural(runs["port_methods"][3]) == structural(runs["jax_methods"][3])
    for got, want in zip(runs["port_methods"][0], runs["port_functions"][0]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(runs["port_methods"][0] + runs["port_methods"][1],
                         runs["jax_methods"][0] + runs["jax_methods"][1]):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    accuracy, _, _, *norms, close, allclose = runs["port_methods"][1]
    assert 0.0 <= accuracy <= 1.0 and all(n > 0 for n in norms) and close and allclose
