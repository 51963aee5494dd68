"""The core ops Scan's graphs build (``aesara_tpu_torch/tensor/basic.py``,
``tensor/shape.py``): ``Join``/``Split``, ``AllocEmpty``, ``zeros``,
``TensorFromScalar``/``ScalarFromTensor``, ``SpecifyShape`` and
``Unbroadcast``, each with its gradient, against the JAX package on the
CPU (float64 at atol 1e-10); and the slice bounds computed from shapes,
which the port folds on the host (``link/torch/dispatch.py::_basic_index``)
while a bound computed from data still raises when the function is
compiled.
"""

import importlib

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
import aesara_tpu.tensor.basic as jtb
from aesara_tpu.tensor.shape import specify_shape as jspecify_shape, unbroadcast as junbroadcast

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
import aesara_tpu_torch.tensor.basic as ptb
from aesara_tpu_torch.tensor.shape import specify_shape as pspecify_shape, unbroadcast as punbroadcast
from aesara_tpu_torch.config import config

# ``aesara_tpu_torch.tensor.shape`` is shadowed by a function of that name
pts = importlib.import_module("aesara_tpu_torch.tensor.shape")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, tb=jtb, specify_shape=jspecify_shape, unbroadcast=junbroadcast, mode="JAX")
PORT = dict(pkg=aesara_tpu_torch, at=pat, tb=ptb, specify_shape=pspecify_shape, unbroadcast=punbroadcast,
            mode="TORCH")
TOL = dict(atol=1e-10, rtol=0)
RNG = np.random.default_rng(11)
A, B = RNG.normal(size=(2, 3)), RNG.normal(size=(4, 3))
W6, W5 = RNG.normal(size=(6, 3)), RNG.normal(size=(5, 4))


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _compare(build, args):
    results = []
    for m in (JAX, PORT):
        ins, outs = build(m)
        results.append(m["pkg"].function(ins, outs, mode=m["mode"])(*args))
    for w, g in zip(*results):
        g = _host(g)
        assert g.shape == np.shape(w) and g.dtype == np.asarray(w).dtype
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_join_and_its_split_gradient(axis):
    a, b = (A, B) if axis == 0 else (A.T, B.T)

    def build(m):
        at, tb = m["at"], m["tb"]
        x, y = at.matrix("x", dtype="float64"), at.matrix("y", dtype="float64")
        j = tb.join(axis, x, y)
        w = at.constant(W6 if axis == 0 else W6.T)
        cost = at.sum(at.tanh(j) * w)
        return [x, y], [j, tb.concatenate([y, x], axis=axis)] + m["pkg"].grad(cost, [x, y])

    _compare(build, [a, b])


def test_join_types_and_stack():
    x, y = pat.matrix("x", shape=(2, 3)), pat.matrix("y", shape=(4, 3))
    assert ptb.join(0, x, y).type.shape == (6, 3)
    assert ptb.join(0, x) is x
    with pytest.raises(TypeError, match="disagree"):
        ptb.join(0, x, pat.matrix("z", shape=(4, 5)))
    assert ptb.stack([x, x], axis=1).type.shape == (2, 2, 3)


def test_split_and_its_join_gradient():
    def build(m):
        at, tb = m["at"], m["tb"]
        x = at.matrix("x", dtype="float64")
        p, q, r = tb.split(x, [1, 2, 3], 3, axis=0)
        cost = at.sum(p * 2.0) + at.sum(at.sin(r))      # q takes no gradient
        return [x], [p, q, r, m["pkg"].grad(cost, x)]

    _compare(build, [RNG.normal(size=(6, 2))])


def test_split_sizes_from_shapes_and_the_lstm_backward_form():
    """Join's gradient splits at ``shape(t)[axis]`` of its inputs: the
    sizes fold on the host."""
    def build(m):
        at, tb = m["at"], m["tb"]
        x, h = at.matrix("x", dtype="float64"), at.matrix("h", dtype="float64")
        z = at.tanh(at.dot(tb.join(1, x, h), at.constant(W5)))
        return [x, h], m["pkg"].grad(at.sum(z), [x, h])

    _compare(build, [RNG.normal(size=(3, 2)), RNG.normal(size=(3, 3))])


def test_split_refuses_sizes_computed_on_the_device():
    x, s = pat.vector("x"), pat.lvector("s")
    with pytest.raises(NotImplementedError, match="split sizes computed on the device"):
        aesara_tpu_torch.function([x, s], ptb.split(x, s, 2))


def test_alloc_empty_zeros_and_full():
    def build(m):
        at, tb = m["at"], m["tb"]
        x = at.matrix("x", dtype="float64")
        z = tb.zeros((x.shape[0], 2), dtype="float64")
        e = tb.AllocEmpty("float64")(x.shape[1], 4)
        return [x], [z + 1.0, tb.full((2, x.shape[1]), 3.0, dtype="float64"), e.shape[0] * 1.0]

    _compare(build, [A])
    assert ptb.empty((2, 3), dtype="float32").type.shape == (2, 3)


def test_alloc_empty_has_no_gradient_to_its_shape():
    n = pat.lscalar("n")
    e = ptb.AllocEmpty("float64")(n, 2)
    assert e.owner.op.connection_pattern(e.owner) == [[False], [False]]


def test_tensor_from_scalar_and_back():
    def build(m):
        at, tb = m["at"], m["tb"]
        x = at.scalar("x", dtype="float64")
        s = tb.scalar_from_tensor(x)
        t = tb.tensor_from_scalar(s)
        return [x], [t * 3.0, m["pkg"].grad(t * t, x)]

    _compare(build, [np.float64(1.5)])


def test_specify_shape_checks_and_passes_the_gradient():
    def build(m):
        at = m["at"]
        x = at.matrix("x", dtype="float64")
        y = m["specify_shape"](x, (2, None))
        return [x], [y * 2.0, m["pkg"].grad(at.sum(y ** 2), x)]

    _compare(build, [A])
    x = pat.matrix("x", dtype="float64")
    y = pts.specify_shape(x, (2, 3))
    assert y.type.shape == (2, 3)
    f = aesara_tpu_torch.function([x], y * 1.0)
    with pytest.raises(AssertionError, match="SpecifyShape"):
        f(B)


def test_unbroadcast_and_its_gradient():
    def build(m):
        at = m["at"]
        x = at.matrix("x", dtype="float64", shape=(1, 3))
        u = m["unbroadcast"](x, 0)
        return [x], [u + 1.0, m["pkg"].grad(at.sum(u * u), x)]

    _compare(build, [A[:1]])
    assert pts.unbroadcast(pat.matrix("x", shape=(1, 3)), 0).type.shape == (None, 3)


def test_slice_bounds_from_shapes_are_lowered():
    """x[: n - 1] and x[1 : n] with n = x.shape[0]: the bounds are host
    values fixed by each key of the function."""
    def build(m):
        at = m["at"]
        x = at.matrix("x", dtype="float64")
        n = x.shape[0]
        y = x[: n - 1] * x[1:n]
        # a negative step after an integer index, and beside a computed bound
        return [x], [y, m["pkg"].grad(at.sum(y), x), x[1, ::-1], x[: n - 1, ::-1]]

    for rows in (4, 6):
        _compare(build, [RNG.normal(size=(rows, 2))])


def test_slice_bounds_from_data_still_raise():
    """x[: i + n] with i an input: the bound is data, read on the host when
    the node runs, so the function runs eagerly and names that blocker; the
    result is NumPy's slice (the JAX package's Python fallback)."""
    x, i = pat.vector("x"), pat.iscalar("i")
    f = aesara_tpu_torch.function([x, i], x[: i + x.shape[0]])
    assert "slice bound computed from data" in f.fn.program.blocker_reason
    data = np.arange(6.0, dtype="float32")
    for k in (-4, -1, 0, 2):
        np.testing.assert_array_equal(f(data, k).numpy(), data[: k + 6])