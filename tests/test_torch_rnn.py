"""The repo's reference configuration 4 (``benchmarks/
bench_reference_ratio.py:247-276``: an Elman RNN over a shared (T, B,
Din) sequence trained by BPTT with sgd) and the recurrent models
(``models/rnn.py``: ``ElmanRNN``, ``LSTM``, ``GRU``, trained with adam on
an input X), built by the JAX package and by the port from the same code
at small sizes, on the CPU.

- The port's ``TORCH`` graph has the JAX package's ``FAST_RUN`` count of
  every op (a Composite counted by its scalar ops), on the outer graph and
  on each Scan's inner graph.  One difference is the JAX package's: its
  config 4 graph keeps two identical ``cast(0)`` nodes (the starts of its
  two DynamicSlices), because its merge pass walks ``fgraph.variables``, a
  set in which two equal constants are one entry, so the second constant
  and the node over it are never merged; the port merges them, and has
  one ``Elemwise{Cast}`` less.
- 3 steps give the same loss and parameters after each step: float32 at
  atol and rtol 1e-5, and config 4 also in float64 at atol 1e-10 (the
  JAX package's models build float32 parts under ``floatX="float64"``).  The JAX side runs
  ``mode="JAX"``, but the models: their X is a function input, so the
  JAX package runs their step on its Python path (``mode="PY"``).
- The models' parameters are carried from the JAX model by
  ``models/convert.py``.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.models import adam as jadam
from aesara_tpu.models import rnn as jrnn
from aesara_tpu.scan.basic import scan as jscan

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models import adam as padam, load_params, params_by_name
from aesara_tpu_torch.models import rnn as prnn
from aesara_tpu_torch.scan.basic import scan as pscan


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, scan=jscan, rnn=jrnn, adam=jadam, config=aesara_tpu.config)
PORT = dict(pkg=aesara_tpu_torch, at=pat, scan=pscan, rnn=prnn, adam=padam, config=config)
# config 4's shapes cut to size: T steps of a (B, DIN) input, H hidden
T, B, DIN, H, NOUT = 5, 4, 3, 6, 10
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "float64": dict(atol=1e-10, rtol=0)}
MODELS = ["ElmanRNN", "LSTM", "GRU"]


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _name(node):
    name = type(node.op).__name__
    scalar = getattr(node.op, "scalar_op", None)
    if scalar is not None:
        if type(scalar).__name__ == "Composite":
            inner = scalar.fgraph.toposort() if hasattr(scalar, "fgraph") else scalar.nodes
            return "Composite{" + ".".join(sorted(type(n.op).__name__ for n in inner)) + "}"
        return f"Elemwise{{{type(scalar).__name__}}}"
    return name


def op_counts(fgraph):
    """[{op name: count} of the graph, then (info, counts) of each Scan's
    inner graph in topological order]."""
    order = fgraph.toposort()
    out = [dict(Counter(_name(n) for n in order))]
    for n in order:
        if type(n.op).__name__ == "Scan":
            out.append((str(n.op.info), dict(Counter(_name(m) for m in n.op.fgraph.toposort()))))
    return out


def build_config4(m, dtype, mode):
    """Config 4 as the benchmark builds it: (step, parameters)."""
    pkg, at = m["pkg"], m["at"]
    rng = np.random.default_rng(0)
    x = pkg.shared(rng.normal(size=(T, B, DIN)).astype(dtype), name="x")
    wx = pkg.shared((rng.normal(size=(DIN, H)) * 0.1).astype(dtype))
    wh = pkg.shared((rng.normal(size=(H, H)) * 0.1).astype(dtype))
    bh = pkg.shared(np.zeros(H, dtype=dtype))
    h0 = at.zeros((B, H), dtype=dtype)

    def step(xt, htm1):
        return at.tanh(at.dot(xt, wx) + at.dot(htm1, wh) + bh)

    hs, _ = m["scan"](step, sequences=[x], outputs_info=[h0])
    loss = at.mean(hs[-1] ** 2) + at.mean(hs ** 2)
    grads = pkg.grad(loss, [wx, wh, bh])
    lr = np.asarray(0.01, dtype)
    ups = {p: p - lr * g for p, g in zip([wx, wh, bh], grads)}
    return pkg.function([], loss, updates=ups, mode=mode), [wx, wh, bh]


def build_model(m, which, dtype, mode):
    """``which`` with adam over an input X: (step, model)."""
    pkg, at = m["pkg"], m["at"]
    with m["config"].change_flags(floatX=dtype):
        model = getattr(m["rnn"], which)(DIN, H, NOUT, seed=0)
        X = at.tensor3("X", dtype=dtype)
        y = at.ivector("y")
        loss = model.loss(X, y)
        step = pkg.function([X, y], loss, updates=m["adam"](loss, model.params, lr=1e-3), mode=mode)
    return step, model


def _data(dtype, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(T, B, DIN)).astype(dtype), rng.integers(0, NOUT, size=B).astype("int32")


@pytest.mark.parametrize("which", ["config4"] + MODELS)
def test_fast_run_graph_has_the_jax_packages_op_counts(which):
    if which == "config4":
        jax_counts = op_counts(build_config4(JAX, "float32", "FAST_RUN")[0].maker.fgraph)
        port_counts = op_counts(build_config4(PORT, "float32", "TORCH")[0].maker.fgraph)
        # the JAX package's two unmerged cast(0) nodes (module docstring)
        assert jax_counts[0]["Elemwise{Cast}"] == 2
        jax_counts[0]["Elemwise{Cast}"] = 1
    else:
        jax_counts = op_counts(build_model(JAX, which, "float32", "FAST_RUN")[0].maker.fgraph)
        port_counts = op_counts(build_model(PORT, which, "float32", "TORCH")[0].maker.fgraph)
    assert len(port_counts) == 3     # the forward Scan and its reverse
    assert port_counts == jax_counts


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_config4_trains_like_the_jax_package(dtype):
    (jstep, jparams), (pstep, pparams) = build_config4(JAX, dtype, "JAX"), build_config4(PORT, dtype, "TORCH")
    losses = []
    for _ in range(3):
        lj, lp = float(np.asarray(jstep())), float(_host(pstep()))
        np.testing.assert_allclose(lp, lj, **TOL[dtype])
        losses.append(lp)
        for a, b in zip(jparams, pparams):
            np.testing.assert_allclose(b.get_value(), np.asarray(a.get_value()), **TOL[dtype])
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("dtype", ["float32"])
@pytest.mark.parametrize("which", MODELS)
def test_model_trains_like_the_jax_package(which, dtype):
    jstep, jmodel = build_model(JAX, which, dtype, "PY")
    pstep, pmodel = build_model(PORT, which, dtype, "TORCH")
    load_params(pmodel, params_by_name(jmodel))
    xv, yv = _data(dtype)
    for _ in range(3):
        lj, lp = float(np.asarray(jstep(xv, yv))), float(_host(pstep(xv, yv)))
        np.testing.assert_allclose(lp, lj, **TOL[dtype])
        for a, b in zip(jmodel.params, pmodel.params):
            np.testing.assert_allclose(b.get_value(), np.asarray(a.get_value()), **TOL[dtype])


@pytest.mark.parametrize("which", MODELS)
def test_predict_matches_the_jax_package(which):
    jmodel = getattr(jrnn, which)(DIN, H, NOUT, seed=3)
    pmodel = getattr(prnn, which)(DIN, H, NOUT, seed=0)
    load_params(pmodel, [np.asarray(v) for v in jmodel.get_values()])
    X, PX = jat.tensor3("X"), pat.tensor3("X")
    fj = aesara_tpu.function([X], [jmodel.logits(X), jmodel.predict(X)], mode="PY")
    fp = aesara_tpu_torch.function([PX], [pmodel.logits(PX), pmodel.predict(PX)])
    xv = _data("float32", seed=4)[0]
    (lj, pj), (lp, pp) = fj(xv), fp(xv)
    np.testing.assert_allclose(_host(lp), np.asarray(lj), **TOL["float32"])
    np.testing.assert_array_equal(_host(pp), np.asarray(pj))


def test_load_params_refuses_another_models_parameters():
    lstm, elman = prnn.LSTM(DIN, H, NOUT), jrnn.ElmanRNN(DIN, H, NOUT)
    with pytest.raises(ValueError, match="names/order differ"):
        load_params(lstm, params_by_name(elman))


def test_lstm_with_an_input_x_lowers_its_shape_derived_slices():
    """The LSTM's step reads X through Subtensors whose bounds are
    ``Shape_i`` of X (the JAX package runs the step on its Python path for
    them); the port folds those bounds on the host, so the step compiles
    and no graph of it raises."""
    step, _ = build_model(PORT, "LSTM", "float32", "TORCH")
    bounded = [n for n in step.maker.fgraph.toposort() if type(n.op).__name__ == "Subtensor"
               and any(i.owner is not None for i in n.inputs[1:])]
    assert bounded, "the step has no Subtensor with computed bounds"
    xv, yv = _data("float32")
    assert np.isfinite(float(_host(step(xv, yv))))
