"""The port's ``function`` against the JAX package's on the same graphs:
single-op graphs, then the encoder forward (2 layers, d=64, 4 heads,
d_ff=128) with weights carried across by ``models/convert.py``.  JAX
``FAST_RUN`` against the port's ``TORCH`` mode on the CPU: equal dtype
and shape, values within atol 1e-5, rtol 1e-5; and the same number of
``Composite`` and ``FusedAttention`` nodes after rewriting."""

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.models.transformer import TransformerEncoderLayer as JLayer
from aesara_tpu.tensor import math as jtm
from aesara_tpu.tensor.nnet.attention import fused_attention as jattention

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.models.convert import load_params, params_by_name
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as PLayer
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.tensor.nnet.attention import fused_attention as pattention
from aesara_tpu_torch.config import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, tm=jtm, attention=jattention, Layer=JLayer, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, tm=ptm, attention=pattention, Layer=PLayer, mode="TORCH")


def _single_op_graph(m, which):
    """(inputs, outputs) of one small graph, built with package ``m``."""
    at, tm = m["at"], m["tm"]
    if which == "dimshuffle":
        x = at.matrix("x")
        return [x], [x.dimshuffle(1, "x", 0), x.T]
    if which == "reshape":
        x = at.tensor3("x")
        return [x], [x.reshape((x.shape[0] * x.shape[1], x.shape[2]))]
    if which == "sum_mean":
        x = at.tensor3("x")
        return [x], [tm.sum(x, axis=1), tm.mean(x, axis=-1, keepdims=True), tm.mean(x)]
    if which == "dot":
        a, b, w = at.matrix("a"), at.tensor3("b"), at.matrix("w")
        return [a, b, w], [tm.dot(a, w), tm.dot(b, w)]
    if which == "elemwise":
        x, b = at.tensor3("x"), at.vector("b")
        y = tm.maximum(x * b + 1.0, 0.0) - tm.sqrt(tm.sqr(x) + 2.0) / b
        return [x, b], [y, -x]
    if which == "elemwise_f64":
        x, b = at.tensor3("x", dtype="float64"), at.vector("b")
        return [x, b], [tm.sqrt(tm.sqr(x - b) + 1.0) * 3.0]
    q, k, v = at.tensor3("q"), at.tensor3("k"), at.tensor3("v")
    return [q, k, v], [m["attention"](q, k, v), m["attention"](q, k, v, causal=True)]


def _values(which, rng):
    f32 = lambda *s: rng.normal(size=s).astype("float32")  # noqa: E731
    return {
        "dimshuffle": [f32(3, 5)],
        "reshape": [f32(2, 3, 4)],
        "sum_mean": [f32(2, 3, 4)],
        "dot": [f32(3, 5), f32(2, 4, 5), f32(5, 6)],
        "elemwise": [f32(2, 3, 4), np.abs(f32(4)) + 0.5],
        "elemwise_f64": [rng.normal(size=(2, 3, 4)), f32(4)],
        "attention": [f32(6, 20, 8), f32(6, 20, 8), f32(6, 20, 8)],
    }[which]


def _run(m, inputs, outputs, values):
    f = m["pkg"].function(inputs, outputs, mode=m["mode"])
    res = f(*values)
    return f, [r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r) for r in res]


def _assert_same(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("which", ["dimshuffle", "reshape", "sum_mean", "dot", "elemwise",
                                   "elemwise_f64", "attention"])
def test_single_op_graph_matches_jax(which):
    values = _values(which, np.random.default_rng(11))
    _, want = _run(JAX, *_single_op_graph(JAX, which), values)
    _, got = _run(PORT, *_single_op_graph(PORT, which), values)
    _assert_same(got, want)


def _encoder(m, n_layers, d, heads, d_ff):
    layers = [m["Layer"](d, heads, d_ff, seed=i) for i in range(n_layers)]
    x = m["at"].tensor3("x")
    h = x
    for layer in layers:
        h = layer(h)
    return layers, x, h


def _count(fgraph, name):
    return sum(1 for n in fgraph.toposort()
               if type(n.op).__name__ == name
               or type(getattr(n.op, "scalar_op", None)).__name__ == name)


@pytest.mark.parametrize("T", [16, 96])
def test_encoder_forward_matches_jax(T):
    jlayers, jx, jh = _encoder(JAX, 2, 64, 4, 128)
    players, px, ph = _encoder(PORT, 2, 64, 4, 128)
    for jl, pl in zip(jlayers, players):
        # the port's own seeded init draws the same weights; overwrite
        # them anyway, so the comparison does not rest on that
        load_params(pl, jl.get_values())
        for name, arr in params_by_name(pl).items():
            np.testing.assert_array_equal(arr, params_by_name(jl)[name])
    x = np.random.default_rng(T).normal(size=(2, T, 64)).astype("float32")
    jf, want = _run(JAX, [jx], [jh, jtm.mean(jtm.sqr(jh))], [x])
    pf, got = _run(PORT, [px], [ph, ptm.mean(ptm.sqr(ph))], [x])
    _assert_same(got, want)
    assert np.isfinite(got[0]).all()

    # the rewritten graphs hold the same fused nodes (the h-only graph:
    # the JAX package also rewrites sum(sqr(h)) to a dot product)
    jf_h = aesara_tpu.function([jx], [jh])
    pf_h = aesara_tpu_torch.function([px], [ph])
    for name in ("Composite", "FusedAttention"):
        assert _count(pf_h.maker.fgraph, name) == _count(jf_h.maker.fgraph, name), name
    assert _count(pf_h.maker.fgraph, "Composite") == 10
    assert _count(pf_h.maker.fgraph, "FusedAttention") == 2


def test_convert_rejects_mismatches():
    (jl,), _, _ = _encoder(JAX, 1, 16, 2, 32)
    (pl,), _, _ = _encoder(PORT, 1, 16, 2, 32)
    values = jl.get_values()
    with pytest.raises(ValueError, match="arrays"):
        load_params(pl, values[:-1])
    with pytest.raises(ValueError, match="wq"):
        load_params(pl, [values[0][:, :-1]] + values[1:])
    with pytest.raises(ValueError, match="wq"):
        load_params(pl, [values[0].astype("float64")] + values[1:])
    named = params_by_name(jl)
    with pytest.raises(ValueError, match="names"):
        load_params(pl, dict(reversed(list(named.items()))))
    load_params(pl, named)
    np.testing.assert_array_equal(pl.params[0].get_value(), values[0])


def test_shared_values_are_numpy_copies():
    w = aesara_tpu_torch.shared(np.arange(3, dtype="float32"), name="w")
    got = w.get_value()
    got[0] = 7.0
    assert w.get_value()[0] == 0.0
    w.set_value(np.ones(3, dtype="float32"))
    x = pat.vector("x")
    f = aesara_tpu_torch.function([x], x + w)
    assert isinstance(f(np.ones(3, "float32")), torch.Tensor)
    np.testing.assert_array_equal(f(np.ones(3, "float32")).numpy(), 2.0)
