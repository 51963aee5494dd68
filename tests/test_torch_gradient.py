"""The port's symbolic ``grad`` against the JAX package's on the same
small graphs and seeded inputs: JAX ``FAST_RUN`` against the port's
``TORCH`` mode on the CPU, atol/rtol 1e-5 (the two sum in different
orders).  Then the errors ``grad`` raises, as the JAX package raises
them."""

import numpy as np
import pytest

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.gradient import NullTypeGradError as JNullTypeGradError, grad as jgrad
from aesara_tpu.models.transformer import layer_norm as jlayer_norm
from aesara_tpu.tensor import math as jtm

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.gradient import NullTypeGradError as PNullTypeGradError, grad as pgrad
from aesara_tpu_torch.models.transformer import layer_norm as player_norm
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.config import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, tm=jtm, grad=jgrad, layer_norm=jlayer_norm, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, tm=ptm, grad=pgrad, layer_norm=player_norm, mode="TORCH")


def _cost_graph(m, which):
    """(inputs, cost) of one small graph, built with package ``m``."""
    at, tm = m["at"], m["tm"]
    if which == "elemwise_maximum":
        x, b = at.tensor3("x"), at.vector("b")
        y = tm.maximum(x * b + 1.0, 0.0) - tm.sqrt(tm.sqr(x) + 2.0) / b
        return [x, b], tm.sum(y * y)
    if which == "dot_2d":
        a, w = at.matrix("a"), at.matrix("w")
        return [a, w], tm.sum(tm.sqr(tm.dot(a, w)))
    if which == "dot_3d":
        b, w = at.tensor3("b"), at.matrix("w")
        return [b, w], tm.mean(tm.dot(b, w) * tm.dot(b, w))
    if which == "dimshuffle_reshape":
        x = at.tensor3("x")
        y = x.dimshuffle(2, 0, 1).reshape((x.shape[2], x.shape[0] * x.shape[1]))
        return [x], tm.sum(tm.sqr(y) * 0.5 + y)
    if which == "sum_mean_bias":
        x, bias = at.tensor3("x"), at.vector("bias")
        h = x + bias
        return [x, bias], tm.mean(tm.sum(h * h, axis=1)) + tm.sum(tm.mean(h, axis=-1, keepdims=True))
    x, g, b = at.tensor3("x"), at.vector("g"), at.vector("b")
    return [x, g, b], tm.mean(tm.sqr(m["layer_norm"](x, g, b)))


def _values(which, rng):
    f32 = lambda *s: rng.normal(size=s).astype("float32")  # noqa: E731
    return {
        # x * b + 1 crosses 0, so maximum takes both of its branches
        "elemwise_maximum": [f32(2, 3, 4), np.abs(f32(4)) + 0.5],
        "dot_2d": [f32(3, 5), f32(5, 6)],
        "dot_3d": [f32(2, 4, 5), f32(5, 6)],
        "dimshuffle_reshape": [f32(2, 3, 4)],
        "sum_mean_bias": [f32(2, 3, 4), f32(4)],
        "layer_norm": [f32(2, 3, 8), f32(8) + 1.0, f32(8)],
    }[which]


def _grads(m, which, values):
    inputs, cost = _cost_graph(m, which)
    f = m["pkg"].function(inputs, [cost] + m["grad"](cost, inputs), mode=m["mode"])
    return [np.asarray(r) for r in f(*values)]


@pytest.mark.parametrize("which", ["elemwise_maximum", "dot_2d", "dot_3d", "dimshuffle_reshape",
                                   "sum_mean_bias", "layer_norm"])
def test_grad_matches_jax(which):
    values = _values(which, np.random.default_rng(5))
    want = _grads(JAX, which, values)
    got = _grads(PORT, which, values)
    assert len(got) == len(want) == len(values) + 1
    for g, w, v in zip(got[1:], want[1:], values):
        assert g.shape == w.shape == v.shape and g.dtype == w.dtype
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    if which == "elemwise_maximum":
        x, b = values
        pre = x * b + 1.0
        assert (pre > 0).any() and (pre < 0).any()


def test_grad_of_a_maximum_tie_goes_to_the_first_operand():
    for m in (JAX, PORT):
        x, y = m["at"].vector("x"), m["at"].vector("y")
        cost = m["tm"].sum(m["tm"].maximum(x, y))
        f = m["pkg"].function([x, y], m["grad"](cost, [x, y]), mode=m["mode"])
        gx, gy = (np.asarray(r) for r in f(np.ones(2, "float32"), np.ones(2, "float32")))
        np.testing.assert_array_equal(gx, [1.0, 1.0])
        np.testing.assert_array_equal(gy, [0.0, 0.0])


@pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])
def test_grad_errors(m):
    at, tm = m["at"], m["tm"]
    x, y = at.vector("x"), at.vector("y")
    with pytest.raises(TypeError, match="scalar"):
        m["grad"](x * 2.0, x)
    cost = tm.sum(x * 2.0)
    with pytest.raises(ValueError, match="disconnected"):
        m["grad"](cost, y)
    gy = m["grad"](cost, y, disconnected_inputs="ignore")
    f = m["pkg"].function([y], gy, mode=m["mode"])
    np.testing.assert_array_equal(np.asarray(f(np.ones(3, "float32"))), 0.0)
    # an integer-valued path has no gradient
    err = JNullTypeGradError if m is JAX else PNullTypeGradError
    with pytest.raises(err):
        m["grad"](tm.sum(tm.cast(x, "int64")), x)


def test_grad_returns_one_variable_or_a_list_and_names_it():
    x = pat.vector("x")
    cost = ptm.sum(ptm.sqr(x))
    cost.name = "c"
    g = pgrad(cost, x)
    assert g.name == "(dc/dx)"
    (g2,) = pgrad(cost, [x])
    f = aesara_tpu_torch.function([x], [g, g2])
    got = f(np.arange(3, dtype="float32"))
    np.testing.assert_array_equal(got[0].numpy(), [0.0, 2.0, 4.0])
    np.testing.assert_array_equal(got[1].numpy(), got[0].numpy())
