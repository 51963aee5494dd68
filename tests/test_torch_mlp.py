"""The repo's reference configurations 1-3 (``benchmarks/
bench_reference_ratio.py:146-250``: sigmoid logistic regression, the
softmax chain, the MNIST MLP over minibatch ``givens``), the ``MLP`` model
and the tutorial program ``examples/logistic_regression.py``, built by
the JAX package and by the port from the same code at small sizes, on
the CPU.

The port's ``TORCH`` graph has the JAX package's ``FAST_RUN`` count of
every op, and of every Composite's scalar ops; 3 steps (minibatches 0, 1,
2) give the same loss and parameters after each step, float32, atol and
rtol 1e-5 (the two packages sum in other orders).
"""

from collections import Counter

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.models import sgd as jsgd
from aesara_tpu.models.linear import LogisticRegression as JLogisticRegression
from aesara_tpu.models.mlp import MLP as JMLP

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models import MLP as PMLP, LogisticRegression as PLogisticRegression, load_params
from aesara_tpu_torch.models import sgd as psgd


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, MLP=JMLP, sgd=jsgd, LR=JLogisticRegression, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, MLP=PMLP, sgd=psgd, LR=PLogisticRegression, mode="TORCH")
TOL = dict(atol=1e-5, rtol=1e-5)
# the benchmark's shapes cut to size: config 1 n x d, config 2 n x d,
# config 3 B x din -> h -> h -> dout over NBATCH minibatches
N1, D1, N2, D2 = 64, 12, 32, 16
B, DIN, H, DOUT, NBATCH = 8, 12, 16, 10, 10


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def build(m, which):
    """Config ``which`` (1, 2, 3) or "mlp" with package ``m``, as the
    benchmark builds it (data from its seed, every dataset shared): (step,
    loss function or None, parameters, takes a minibatch index)."""
    pkg, at = m["pkg"], m["at"]
    rng = np.random.default_rng(0)
    f32 = "float32"
    if which == 1:
        X = pkg.shared(rng.normal(size=(N1, D1)).astype(f32), name="X")
        Y = pkg.shared((rng.random(N1) > 0.5).astype(f32), name="Y")
        w = pkg.shared(rng.normal(size=D1).astype(f32) * 0.01, name="w")
        b = pkg.shared(np.asarray(0.0, dtype=f32), name="b")
        p = at.sigmoid(at.dot(X, w) + b)
        eps = np.asarray(1e-7, dtype=f32)
        nll = -at.mean(Y * at.log(p + eps) + (1 - Y) * at.log(1 - p + eps))
        gw, gb = pkg.grad(nll, [w, b])
        lr = np.asarray(0.1, dtype=f32)
        step = pkg.function([], [], updates={w: w - lr * gw, b: b - lr * gb}, mode=m["mode"])
        return step, pkg.function([], nll, mode=m["mode"]), [w, b], False
    if which == 2:
        h = X = pkg.shared(rng.normal(size=(N2, D2)).astype(f32), name="X")
        for _ in range(4):
            e = at.exp(h - at.max(h, axis=1, keepdims=True))
            sm = e / at.sum(e, axis=1, keepdims=True)
            lse = at.log(at.sum(at.exp(sm), axis=1, keepdims=True))
            h = sm * np.asarray(1.1, f32) + at.tanh(lse)
        return pkg.function([], at.sum(h), mode=m["mode"]), None, [], False
    x, y, idx = at.matrix("x", dtype=f32), at.lvector("y"), at.iscalar("idx")
    if which == 3:
        sizes = [(DIN, H), (H, H), (H, DOUT)]
        ws = [pkg.shared((rng.normal(size=s) * (1.0 / np.sqrt(s[0]))).astype(f32)) for s in sizes]
        bs = [pkg.shared(np.zeros(s[1], dtype=f32)) for s in sizes]
        h = x
        for i, (wi, bi) in enumerate(zip(ws, bs)):
            h = at.dot(h, wi) + bi
            if i < 2:
                h = at.tanh(h)
        lse = at.log(at.sum(at.exp(h - at.max(h, axis=1, keepdims=True)), axis=1)) + at.max(h, axis=1)
        loss = at.mean(lse - h[at.arange(y.shape[0]), y])
        params = ws + bs
        grads = pkg.grad(loss, params)
        lr = np.asarray(0.01, f32)
        updates = {p: p - lr * g for p, g in zip(params, grads)}
    else:
        model = m["MLP"](DIN, [H, H], DOUT, activation="sigmoid", seed=0)
        loss, params = model.loss(x, y), model.params
        updates = m["sgd"](loss, params, lr=0.1)
    Xd = pkg.shared(rng.normal(size=(NBATCH * B, DIN)).astype(f32), name="Xd")
    Yd = pkg.shared(rng.integers(0, DOUT, size=NBATCH * B).astype("int64"), name="Yd")
    givens = {x: Xd[idx * B:(idx + 1) * B], y: Yd[idx * B:(idx + 1) * B]}
    step = pkg.function([idx], [] if which == 3 else loss, updates=updates, givens=givens, mode=m["mode"])
    return step, pkg.function([idx], loss, givens=givens, mode=m["mode"]), params, True


def op_counts(fn):
    """{op name: count} of a compiled function's graph, a Composite named
    by the sorted multiset of its scalar ops."""
    counts = Counter()
    for node in fn.maker.fgraph.toposort():
        name = type(node.op).__name__
        scalar = getattr(node.op, "scalar_op", None)
        if scalar is not None:
            if type(scalar).__name__ == "Composite":
                inner = scalar.fgraph.toposort() if hasattr(scalar, "fgraph") else scalar.nodes
                name = "Composite{" + ".".join(sorted(type(n.op).__name__ for n in inner)) + "}"
            else:
                name = f"Elemwise{{{type(scalar).__name__}}}"
        counts[name] += 1
    return dict(counts)


CONFIGS = [1, 2, 3, "mlp"]


@pytest.mark.parametrize("which", CONFIGS)
def test_fast_run_graph_has_the_jax_packages_op_counts(which):
    counts = [op_counts(build(m, which)[0]) for m in (JAX, PORT)]
    assert counts[1] == counts[0]
    expected = {1: ["Elemwise{Sigmoid}"], 2: ["Softmax"], 3: ["DynamicSlice", "Composite{Add.Tanh}"],
                "mlp": ["DynamicSlice", "LogSoftmax"]}[which]
    assert all(name in counts[1] for name in expected)


@pytest.mark.parametrize("which", CONFIGS)
def test_three_steps_match_jax(which):
    runs = []
    for m in (JAX, PORT):
        step, loss, params, indexed = build(m, which)
        trace = []
        for i in range(3):
            args = (np.int32(i),) if indexed else ()
            if loss is not None:
                trace.append(_host(loss(*args)))
            out = step(*args)
            if which == 2:
                trace.append(_host(out))
            trace.extend(_host(p.get_value()) for p in params)
        runs.append(trace)
    for got, want in zip(runs[1], runs[0]):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **TOL)
    if which != 2:
        losses = [float(v) for v in runs[1][::len(runs[1]) // 3]]
        assert all(np.isfinite(losses))


def test_mlp_parameters_carry_across_and_predict_matches():
    """``load_params`` carries a JAX-package MLP's parameters into the
    port's; both then give the same logits and predictions."""
    xv = np.random.default_rng(5).normal(size=(7, DIN)).astype("float32")
    jm = JMLP(DIN, [H, H], DOUT, activation="tanh", seed=3)
    pm = PMLP(DIN, [H, H], DOUT, activation="tanh", seed=4)
    load_params(pm, [np.asarray(p.get_value()) for p in jm.params])
    outs = []
    for m, model in ((JAX, jm), (PORT, pm)):
        x = m["at"].matrix("x")
        f = m["pkg"].function([x], [model.logits(x), model.predict(x)], mode=m["mode"])
        outs.append([_host(o) for o in f(xv)])
    np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_logistic_regression_example_runs_through_the_port():
    """``examples/logistic_regression.py``'s program, written for each
    package: 50 epochs of full-batch sgd; the same final loss and
    predictions, and the accuracy the example asserts (> 0.9)."""
    rng = np.random.default_rng(0)
    N, D = 400, 20
    X = rng.normal(size=(N, D)).astype("float32")
    y = (X @ rng.normal(size=D) > 0).astype("int64")
    results = []
    for m in (JAX, PORT):
        at = m["at"]
        x_sym, y_sym = at.matrix("x"), at.lvector("y")
        model = m["LR"](D, 2)
        cost = model.loss(x_sym, y_sym)
        train = m["pkg"].function([x_sym, y_sym], cost, updates=m["sgd"](cost, model.params, lr=0.1),
                                  mode=m["mode"])
        predict = m["pkg"].function([x_sym], model.predict(x_sym), mode=m["mode"])
        for _ in range(50):
            loss = train(X, y)
        results.append((float(_host(loss)), _host(predict(X))))
    (jloss, jpred), (ploss, ppred) = results
    np.testing.assert_allclose(ploss, jloss, **TOL)
    np.testing.assert_array_equal(ppred, jpred)
    assert (ppred == y).mean() > 0.9
