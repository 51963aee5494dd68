"""Sparse-input models of the port against the JAX package on the CPU.

- Logistic regression (``models/linear.py``) on a 300 × 500 CSR with 12
  classes: 3 sgd steps, the loss and every parameter against JAX
  FAST_RUN, then ``predict``; the rewritten train graph holds ``Usmm``,
  ``LogSoftmax`` and ``StructuredDot(Transpose(x), ·)`` and no
  ``DenseFromSparse`` (the JAX package's graph makes x dense there).
- The sparse GLM of ``benchmarks/bench_reference_ratio.py:290-295``
  (without the Monte-Carlo noise) on 512 × 256, the JAX package's BSS path;
  and config 5 as the benchmark builds it, with its noise ``eps =
  RandomStream(42).normal(size=(d,)) * 0.01`` drawn anew each step: 3
  steps, the loss, w and the key against JAX FAST_RUN, and the key
  carried from a JAX package stream into a port stream of another seed
  (``named_state``/``load_state``), after which the steps agree again.
- The gradient with respect to the stored values of x,
  ``grad(sum(structured_dot(x, b)²), x)``: against JAX FAST_RUN at n = 256,
  and against SciPy at n = 300, where the JAX package fails (its BSS
  SDDMM emits coordinates of padded rows, ``ROADMAP.md`` Queue 3).

Tolerance 1e-5 absolute and relative: float32 sums over a few stored
entries per row, taken in another order.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu import sparse as jsparse
from aesara_tpu.models.linear import LinearRegression as JLinear, LogisticRegression as JLogistic
from aesara_tpu.models.optim import sgd as jsgd
from aesara_tpu.tensor import math as jtm
from aesara_tpu.tensor.shape import shape_padright as jpadright

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch import sparse as psparse
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models.convert import load_params
from aesara_tpu_torch.models.linear import LinearRegression as PLinear, LogisticRegression as PLogistic
from aesara_tpu_torch.models.optim import sgd as psgd
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.tensor.shape import shape_padright as ppadright


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


TOL = dict(atol=1e-5, rtol=1e-5)
JAX = dict(pkg=aesara_tpu, at=jat, tm=jtm, sparse=jsparse, sgd=jsgd, Logistic=JLogistic,
           Linear=JLinear, padright=jpadright, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, tm=ptm, sparse=psparse, sgd=psgd, Logistic=PLogistic,
            Linear=PLinear, padright=ppadright, mode="TORCH")


def _csr(n, d, density, seed=0):
    return sps.random(n, d, density=density, format="csr", dtype="float32",
                      random_state=np.random.RandomState(seed))


def _names(fgraph):
    return [type(n.op).__name__ for n in fgraph.toposort()]


def _logistic_step(m, xv, yv, n_classes):
    x = m["pkg"].shared(xv, name="x")
    y = m["pkg"].shared(yv, name="y")
    model = m["Logistic"](xv.shape[1], n_classes, seed=0)
    loss = model.loss(x, y)
    step = m["pkg"].function([], loss, updates=m["sgd"](loss, model.params, lr=0.1), mode=m["mode"])
    xin = m["sparse"].csr_matrix("xin")
    predict = m["pkg"].function([xin], model.predict(xin), mode=m["mode"])
    return model, step, predict


def test_logistic_regression_train_and_predict_match_jax():
    xv = _csr(300, 500, 0.02)
    yv = np.random.default_rng(1).integers(0, 12, size=300).astype("int64")
    jmodel, jstep, jpredict = _logistic_step(JAX, xv, yv, 12)
    pmodel, pstep, ppredict = _logistic_step(PORT, xv, yv, 12)
    load_params(pmodel, jmodel.get_values())
    losses = []
    for _ in range(3):
        want, got = float(np.asarray(jstep())), pstep()
        assert isinstance(got, torch.Tensor) and got.shape == ()
        np.testing.assert_allclose(float(got), want, **TOL)
        for jp, pp in zip(jmodel.params, pmodel.params):
            np.testing.assert_allclose(pp.get_value(), np.asarray(jp.get_value()), err_msg=pp.name,
                                       **TOL)
        losses.append(float(got))
    assert losses[0] > losses[1] > losses[2]
    request = _csr(40, 500, 0.05, seed=2)
    got = ppredict(request)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpredict(request)))


def test_logistic_regression_train_graph_keeps_x_sparse():
    xv = _csr(300, 500, 0.02)
    yv = np.random.default_rng(1).integers(0, 12, size=300).astype("int64")
    _, step, _ = _logistic_step(PORT, xv, yv, 12)
    nodes = step.maker.fgraph.toposort()
    names = _names(step.maker.fgraph)
    assert "DenseFromSparse" not in names
    assert names.count("Usmm") == 1 and names.count("LogSoftmax") == 1
    (sd,) = [n for n in nodes if type(n.op).__name__ == "StructuredDot"]
    owner = sd.inputs[0].owner
    assert type(owner.op).__name__ == "Transpose" and owner.inputs[0].name == "x"


def _glm_step(m, xv, yv, wv, square):
    """The sparse GLM step of bench_reference_ratio.py config 5 without eps."""
    x = m["pkg"].shared(xv, name="x")
    y = m["pkg"].shared(yv, name="y")
    w = m["pkg"].shared(wv, name="w")
    pred = m["sparse"].structured_dot(x, m["padright"](w)).flatten()
    loss = m["tm"].mean(square(pred - y))
    gw = m["pkg"].grad(loss, w)
    return w, m["pkg"].function([], loss, updates={w: w - np.float32(0.1) * gw}, mode=m["mode"])


def test_sparse_glm_step_matches_jax():
    rng = np.random.default_rng(3)
    xv = _csr(512, 256, 0.01, seed=3)
    yv = rng.normal(size=512).astype("float32")
    wv = (rng.normal(size=256) * 0.01).astype("float32")
    # the benchmark writes (pred - y) ** 2; the port has no Pow yet and
    # squares with sqr, which FAST_RUN's pow specialisation also gives
    jw, jstep = _glm_step(JAX, xv, yv, wv, lambda d: d ** 2)
    pw, pstep = _glm_step(PORT, xv, yv, wv, ptm.sqr)
    for _ in range(3):
        np.testing.assert_allclose(float(pstep()), float(np.asarray(jstep())), **TOL)
        np.testing.assert_allclose(pw.get_value(), np.asarray(jw.get_value()), **TOL)
    names = _names(pstep.maker.fgraph)
    assert names.count("StructuredDot") == 2 and "DenseFromSparse" not in names


def _glm_noise_step(m, xv, yv, wv, square, seed=42):
    """Config 5's step as bench_reference_ratio.py:287-296 builds it:
    ``eps = srng.normal(size=(d,)) * 0.01`` added to w in the prediction."""
    rs = __import__(f"{m['pkg'].__name__}.tensor.random.utils", fromlist=["RandomStream"]).RandomStream
    x = m["pkg"].shared(xv, name="x")
    y = m["pkg"].shared(yv, name="y")
    w = m["pkg"].shared(wv, name="w")
    srng = rs(seed=seed)
    eps = srng.normal(size=(wv.shape[0],), dtype="float32") * np.asarray(0.01, "float32")
    pred = m["sparse"].structured_dot(x, m["padright"](w + eps)).flatten()
    loss = m["tm"].mean(square(pred - y))
    gw = m["pkg"].grad(loss, w)
    return w, srng, m["pkg"].function([], loss, updates={w: w - np.float32(0.1) * gw}, mode=m["mode"])


def test_config5_with_its_noise_matches_jax_and_carries_its_key():
    from aesara_tpu_torch.models.convert import load_state, named_state
    from aesara_tpu_torch.tensor.random.op import split

    rng = np.random.default_rng(4)
    xv = _csr(512, 256, 0.01, seed=4)
    yv = rng.normal(size=512).astype("float32")
    wv = (rng.normal(size=256) * 0.01).astype("float32")
    jw, jsrng, jstep = _glm_noise_step(JAX, xv, yv, wv, lambda d: d ** 2)
    pw, psrng, pstep = _glm_noise_step(PORT, xv, yv, wv, ptm.sqr, seed=7)
    (pkey,) = named_state(psrng).values()
    first = pkey.get_value()
    load_state(psrng, named_state(jsrng))
    assert not np.array_equal(pkey.get_value(), first)
    for step in range(3):
        key = pkey.get_value()
        np.testing.assert_allclose(float(pstep()), float(np.asarray(jstep())), **TOL)
        np.testing.assert_allclose(pw.get_value(), np.asarray(jw.get_value()), **TOL)
        np.testing.assert_array_equal(pkey.get_value(), split(key)[0])
        np.testing.assert_array_equal(pkey.get_value(), np.asarray(jsrng.state_updates[0][0].get_value()))
    # and back: the JAX package's stream continues from the port's key
    pstep()
    load_state(jsrng, named_state(psrng))
    np.testing.assert_array_equal(np.asarray(jsrng.state_updates[0][0].get_value()), pkey.get_value())


def _values_grad(m):
    x = m["sparse"].csr_matrix("x")
    b = m["at"].matrix("b")
    cost = m["tm"].sum(m["tm"].sqr(m["sparse"].structured_dot(x, b)))
    return m["pkg"].function([x, b], m["pkg"].grad(cost, x), mode=m["mode"])


@pytest.mark.parametrize("C", [1, 20])
def test_sparse_values_gradient_matches_jax(C):
    xv = _csr(256, 300, 0.02, seed=4)
    bv = np.random.default_rng(5).normal(size=(300, C)).astype("float32")
    want = _values_grad(JAX)(xv, bv)
    got = _values_grad(PORT)(xv, bv)
    assert sps.isspmatrix_csr(got)
    np.testing.assert_array_equal(got.indptr, xv.indptr)
    np.testing.assert_array_equal(got.indices, xv.indices)
    np.testing.assert_allclose(got.toarray(), want.toarray(), **TOL)


@pytest.mark.parametrize("C", [1, 20])
def test_sparse_values_gradient_matches_scipy_where_jax_fails(C):
    xv = _csr(300, 200, 0.03, seed=6)
    bv = np.random.default_rng(7).normal(size=(200, C)).astype("float32")
    got = _values_grad(PORT)(xv, bv)
    gz = 2.0 * (xv @ bv)
    rows = np.repeat(np.arange(300), np.diff(xv.indptr))
    np.testing.assert_array_equal(got.indices, xv.indices)
    np.testing.assert_allclose(got.data, np.einsum("kc,kc->k", gz[rows], bv[xv.indices]), **TOL)


def test_linear_regression_on_sparse_x_matches_jax():
    rng = np.random.default_rng(8)
    xv = _csr(200, 64, 0.1, seed=8)
    yv = rng.normal(size=200).astype("float32")
    results = []
    for m in (JAX, PORT):
        model = m["Linear"](64, seed=0)
        x, y = m["sparse"].csr_matrix("x"), m["at"].vector("y")
        loss = model.loss(x, y)
        f = m["pkg"].function([x, y], loss, updates=m["sgd"](loss, model.params, lr=0.1), mode=m["mode"])
        results.append(([float(np.asarray(f(xv, yv))) for _ in range(2)],
                        [np.asarray(p.get_value()) for p in model.params]))
    (jl, jp), (pl, pp) = results
    np.testing.assert_allclose(pl, jl, **TOL)
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a, b, **TOL)
