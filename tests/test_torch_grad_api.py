"""The training-side API of the port against the JAX package's, on the
CPU: ``grad``'s options, the gradient manipulators, ``Lop``,
``subgraph_grad``, ``numeric_grad``/``verify_grad``, the gradients of the
optimizers' elementwise ops and reductions, and ``function``'s ``In``
specs, ``givens``, default updates and unused-input policy.

Inputs come from numpy seeds; values agree with JAX ``FAST_RUN`` within
atol/rtol 1e-5 in fp32 (the two packages sum in different orders) and
exactly where no arithmetic is involved (defaults, counters, names)."""

import warnings

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.gradient as jgradient
import aesara_tpu.tensor as jat
from aesara_tpu.compile.function import UnusedInputError as JUnusedInputError
from aesara_tpu.compile.io import In as JIn
from aesara_tpu.tensor import basic as jtb, math as jtm

import aesara_tpu_torch
import aesara_tpu_torch.gradient as pgradient
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.compile.function import UnusedInputError as PUnusedInputError
from aesara_tpu_torch.compile.io import In as PIn
from aesara_tpu_torch.config import config
from aesara_tpu_torch.tensor import basic as ptb, math as ptm


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, g=jgradient, at=jat, tm=jtm, tb=jtb, In=JIn, Unused=JUnusedInputError,
           mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, g=pgradient, at=pat, tm=ptm, tb=ptb, In=PIn, Unused=PUnusedInputError,
            mode="TORCH")
BOTH = pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(e) for e in v]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _vals(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype("float32") for s in shapes]


def _run(m, inputs, outputs, values, **kwargs):
    f = m["pkg"].function(inputs, outputs, mode=m["mode"], on_unused_input="ignore", **kwargs)
    return _np(f(*values))


def _both(build, values, **kwargs):
    """Build the graph with each package and run it on ``values``."""
    outs = []
    for m in (JAX, PORT):
        inputs, outputs = build(m)
        outs.append(_run(m, inputs, outputs, values, **kwargs))
    return outs


def _assert_close(want, got):
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)


# ---------------------------------------------------------------------------
# grad's options
# ---------------------------------------------------------------------------

def _chain(m):
    """(x, w, h = x @ w, cost of h and x)."""
    at, tm = m["at"], m["tm"]
    x, w = at.matrix("x"), at.matrix("w")
    h = tm.dot(x, w)
    return x, w, h, tm.sum(tm.sqr(h) + h * x)


def test_consider_constant_stops_the_walk_at_a_variable():
    def build(m):
        x, w, h, cost = _chain(m)
        # nothing reaches w but through h
        return [x, w], m["g"].grad(cost, [x, w, h], consider_constant=[h], disconnected_inputs="ignore")

    want, got = _both(build, _vals((3, 3), (3, 3)))
    _assert_close(want, got)


def test_known_grads_and_lop_seed_the_walk():
    def build(m):
        x, w, h, _ = _chain(m)
        gh = m["at"].matrix("gh")
        known = m["g"].grad(None, [x, w], known_grads={h: gh})
        lop = m["g"].Lop(h, [x, w], gh)
        return [x, w, gh], known + lop

    want, got = _both(build, _vals((3, 3), (3, 3), (3, 3), seed=1))
    _assert_close(want, got)
    np.testing.assert_allclose(got[0], got[2], **TOL)


@BOTH
@pytest.mark.parametrize("how", ["zero", "none", "disconnected"])
def test_return_disconnected(m, how):
    x, y = m["at"].vector("x"), m["at"].vector("y")
    g = m["g"].grad(m["tm"].sum(x * 2.0), [x, y], disconnected_inputs="ignore", return_disconnected=how)
    assert g[0] is not None
    if how == "zero":
        assert g[1].type.ndim == 1
        out = _run(m, [x, y], g[1], [np.ones(3, "float32"), np.ones(3, "float32")])
        np.testing.assert_array_equal(out, np.zeros(3))
    elif how == "none":
        assert g[1] is None
    else:
        assert type(g[1].type).__name__ == "DisconnectedType"


@BOTH
def test_disconnected_inputs_raise_warn_and_ignore(m):
    x, y = m["at"].vector("x"), m["at"].vector("y")
    cost = m["tm"].sum(x)
    with pytest.raises(ValueError, match="disconnected"):
        m["g"].grad(cost, y)
    with pytest.warns(UserWarning, match="disconnected"):
        m["g"].grad(cost, y, disconnected_inputs="warn")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m["g"].grad(cost, y, disconnected_inputs="ignore")


@BOTH
def test_null_gradients_raise_or_return(m):
    x = m["at"].vector("x")
    cost = m["tm"].sum(m["g"].undefined_grad(x) * 3.0)
    with pytest.raises(m["g"].NullTypeGradError):
        m["g"].grad(cost, x)
    g = m["g"].grad(cost, x, null_gradients="return")
    assert type(g.type).__name__ == "NullType"


@BOTH
def test_add_names(m):
    x = m["at"].vector("x")
    cost = m["tm"].sum(x * x)
    cost.name = "c"
    assert m["g"].grad(cost, x).name == "(dc/dx)"
    assert m["g"].grad(cost, x, add_names=False).name != "(dc/dx)"


# ---------------------------------------------------------------------------
# manipulators, subgraph_grad, verify_grad
# ---------------------------------------------------------------------------

MANIPULATORS = {
    "zero_grad": lambda g, x: g.zero_grad(x),
    "disconnected_grad": lambda g, x: g.disconnected_grad(x),
    "grad_clip": lambda g, x: g.grad_clip(x, -0.5, 0.25),
    "grad_scale": lambda g, x: g.grad_scale(x, 3.0),
    "consider_constant": lambda g, x: g.consider_constant(x),
}


@pytest.mark.parametrize("name", sorted(MANIPULATORS))
def test_manipulator_is_the_identity_forward_with_its_own_gradient(name):
    def build(m):
        x, w = m["at"].vector("x"), m["at"].vector("w")
        y = MANIPULATORS[name](m["g"], x * w)
        cost = m["tm"].sum(m["tm"].sqr(y) + x)
        return [x, w], [y] + m["g"].grad(cost, [x, w], disconnected_inputs="ignore")

    want, got = _both(build, _vals((7,), (7,), seed=2))
    _assert_close(want, got)
    np.testing.assert_allclose(got[0], np.prod(_vals((7,), (7,), seed=2), axis=0), **TOL)


def test_subgraph_grad_matches_jax_and_the_whole_gradient():
    def build(m):
        at, tm, g = m["at"], m["tm"], m["g"]
        x, w1, w2 = at.vector("x"), at.vector("w1"), at.vector("w2")
        a = tm.sqr(x * w1)
        b = a * w2 + tm.sum(a)
        cost2 = tm.sum(tm.sqr(b))
        g2, next_grad = g.subgraph_grad(wrt=[w2], end=[a], cost=cost2)
        g1, _ = g.subgraph_grad(wrt=[w1, x], end=[x], start=dict(zip([a], next_grad)))
        whole = g.grad(cost2, [w2, w1])
        return [x, w1, w2], g2 + next_grad + g1 + whole

    want, got = _both(build, _vals((5,), (5,), (5,), seed=3))
    _assert_close(want, got)
    np.testing.assert_allclose(got[0], got[-2], **TOL)    # d cost / d w2, in one walk or two
    np.testing.assert_allclose(got[2], got[-1], **TOL)    # d cost / d w1


def _new_ops_cost(m, x, y):
    """A cost through the optimizers' elementwise ops and the reductions."""
    tm, tb = m["tm"], m["tb"]
    pos = tm.abs(x) + 0.5
    z = (tm.pow(pos, y) + tm.log(pos) * tm.cos(y) + tm.minimum(x, y) + tm.clip(x * y, -0.3, 0.4)
         + tb.switch(tm.gt(x, y), x * 2.0, y * y))
    return tm.sum(z * z) + tm.max(x * y) - tm.min(y) + tm.sum(tm.sqrt(tm.sqr(x) + 1.0))


def test_gradients_of_the_new_ops_match_jax():
    def build(m):
        x, y = m["at"].vector("x"), m["at"].vector("y")
        cost = _new_ops_cost(m, x, y)
        return [x, y], [cost] + m["g"].grad(cost, [x, y])

    want, got = _both(build, _vals((11,), (11,), seed=4))
    _assert_close(want, got)


@BOTH
def test_verify_grad_passes_a_right_gradient_and_catches_a_wrong_one(m):
    pt = _vals((6,), (6,), seed=5)
    m["g"].verify_grad(lambda x, y: _new_ops_cost(m, x, y) * x, [p.astype("float64") for p in pt],
                       rng=np.random.default_rng(0), mode=m["mode"])
    with pytest.raises(m["g"].GradientError):
        m["g"].verify_grad(lambda x: m["g"].grad_scale(m["tm"].sqr(x), 2.0), [pt[0].astype("float64")],
                           rng=np.random.default_rng(0), mode=m["mode"])


def test_numeric_grad_matches_jax():
    x0 = _vals((4,), seed=6)[0].astype("float64")
    f = lambda x: float(np.sum(np.cos(x) * x))   # noqa: E731
    jng, png = jgradient.numeric_grad(f, [x0]), pgradient.numeric_grad(f, [x0])
    np.testing.assert_array_equal(png.gf[0], jng.gf[0])
    assert png.max_err([-np.sin(x0) * x0 + np.cos(x0)], 1e-6, 1e-6) == jng.max_err(
        [-np.sin(x0) * x0 + np.cos(x0)], 1e-6, 1e-6)


# ---------------------------------------------------------------------------
# In specs, givens, default updates, unused inputs
# ---------------------------------------------------------------------------

def _calls(m, build, calls):
    """Compile ``build(m)`` -> (inputs, outputs, kwargs) and make the
    calls, each (args, kwargs)."""
    inputs, outputs, kwargs = build(m)
    f = m["pkg"].function(inputs, outputs, mode=m["mode"], **kwargs)
    return [_np(f(*args, **kw)) for args, kw in calls]


def _defaults(m):
    x, y = m["at"].scalar("x"), m["at"].scalar("y")
    z = m["at"].scalar("z")
    return [x, m["In"](y, name="yy", value=2.0), m["In"](z, value=np.float32(-1.0))], x * 10.0 + y - z, {}


def _state(m):
    x, acc = m["at"].vector("x"), m["at"].vector("acc")
    return [x, m["In"](acc, value=np.zeros(3, "float32"), update=acc + x)], acc * 2.0, {}


def _givens(m):
    x, y, z = m["at"].vector("x"), m["at"].vector("y"), m["at"].vector("z")
    # dict at once; list in order (z's replacement is then rewritten by y's)
    return [x], [x + y, y * z], {"givens": [(z, y + 1.0), (y, x * 3.0)]}


def _givens_dict(m):
    x, y = m["at"].vector("x"), m["at"].vector("y")
    w = m["pkg"].shared(np.arange(3, dtype="float32"), name="w")
    return [x], [x + y, y * 2.0], {"givens": {y: w * x}}


@pytest.mark.parametrize("case,calls", [
    (_defaults, [((1.0,), {}), ((1.0, 5.0), {}), ((1.0,), {"yy": 4.0}), ((1.0,), {"yy": 4.0, "z": 7.0})]),
    (_state, [((np.ones(3, "float32"),), {})] * 3 + [((np.arange(3, dtype="float32"),), {"acc": np.ones(3, "float32")})]),
    (_givens, [((np.arange(3, dtype="float32"),), {})]),
    (_givens_dict, [((np.arange(3, dtype="float32") + 1,), {})] * 2),
], ids=["defaults_and_names", "in_update_state", "givens_list", "givens_dict"])
def test_function_inputs_match_jax(case, calls):
    want, got = _calls(JAX, case, calls), _calls(PORT, case, calls)
    for w, g in zip(want, got):
        w, g = (w, g) if isinstance(w, list) else ([w], [g])
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, **TOL)


@BOTH
def test_call_errors(m):
    x, y = m["at"].scalar("x"), m["at"].scalar("y")
    f = m["pkg"].function([x, m["In"](y, name="yy")], x + y, mode=m["mode"])
    with pytest.raises(TypeError, match="unknown input name"):
        f(1.0, zz=2.0)
    with pytest.raises(TypeError, match="given twice"):
        f(1.0, 2.0, yy=2.0)
    with pytest.raises(TypeError, match="missing input"):
        f(1.0)
    assert float(_np(f(1.0, yy=2.0))) == 3.0


@BOTH
def test_strict_and_allow_downcast(m):
    x = m["at"].vector("x")
    f64 = np.arange(3, dtype="float64")
    strict = m["pkg"].function([m["In"](x, strict=True)], x * 2.0, mode=m["mode"])
    with pytest.raises(TypeError):
        strict(f64)
    loose = m["pkg"].function([x], x * 2.0, mode=m["mode"], allow_input_downcast=True)
    np.testing.assert_array_equal(_np(loose(f64)), [0, 2, 4])
    with pytest.raises(TypeError):
        m["pkg"].function([x], x * 2.0, mode=m["mode"])(f64)


@BOTH
def test_default_updates_and_no_default_updates(m):
    s = m["pkg"].shared(np.asarray(0.0, "float32"), name="s")
    t = m["pkg"].shared(np.asarray(10.0, "float32"), name="t")
    s.default_update = s + 1.0
    t.default_update = t * 2.0
    m["pkg"].function([], s + t, mode=m["mode"])()
    assert (float(np.asarray(s.get_value())), float(np.asarray(t.get_value()))) == (1.0, 20.0)
    m["pkg"].function([], s + t, mode=m["mode"], no_default_updates=True)()
    assert (float(np.asarray(s.get_value())), float(np.asarray(t.get_value()))) == (1.0, 20.0)
    m["pkg"].function([], s + t, mode=m["mode"], no_default_updates=[t])()
    assert (float(np.asarray(s.get_value())), float(np.asarray(t.get_value()))) == (2.0, 20.0)
    # an explicit update wins over the default one
    m["pkg"].function([], s, mode=m["mode"], updates=[(s, s - 5.0)])()
    assert float(np.asarray(s.get_value())) == -3.0


@BOTH
def test_on_unused_input(m):
    x, y = m["at"].vector("x"), m["at"].vector("y")
    with pytest.raises(m["Unused"]):
        m["pkg"].function([x, y], x * 2.0, mode=m["mode"])
    with pytest.warns(UserWarning, match="unused"):
        m["pkg"].function([x, y], x * 2.0, mode=m["mode"], on_unused_input="warn")
    f = m["pkg"].function([x, y], x * 2.0, mode=m["mode"], on_unused_input="ignore")
    np.testing.assert_array_equal(_np(f(np.ones(2, "float32"), np.ones(5, "float32"))), [2, 2])
    # a given replaces an input: the input is then unused
    with pytest.raises(m["Unused"]):
        m["pkg"].function([x, y], x + y, mode=m["mode"], givens={y: x})
