"""Sort, top-k, the cumulative ops and ``broadcast_to`` of the port
(``aesara_tpu_torch/tensor/sort.py``, ``tensor/extra_ops.py`` and their
lowerings in ``link/torch/dispatch.py``) against the JAX package on the
CPU: values and indices exactly (ties lowest index first, as ``jnp.sort``
and ``lax.top_k`` keep them), gradients to 1e-10 in float64.

- ``sort``/``argsort`` along each axis and ``axis=None``, on floats with
  ties, ints, every unsigned type and bools; the gradient of ``sort`` in
  one and two dims.
- ``topk``/``argtopk``/``topk_and_argtopk`` with positive and negative k
  (bottom |k|, reversed dtype-safely for ints and unsigned types), ties,
  along axis 0 and -1, and the values' gradient.
- ``cumsum``/``cumprod`` along each axis and ``axis=None`` (a 0-d input
  too), an int8 input that wraps, and their gradients.
- ``broadcast_to``, its gradient, and ``broadcast_arrays``; the view it
  returns is never written through.
"""

import importlib

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.tensor import extra_ops as jxo

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.tensor import extra_ops as pxo, sort as psort

# ``aesara_tpu.tensor.sort`` is shadowed by a function of that name
jsort = importlib.import_module("aesara_tpu.tensor.sort")


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, sort=jsort, xo=jxo)
PORT = dict(pkg=aesara_tpu_torch, at=pat, sort=psort, xo=pxo)
RNG = np.random.default_rng(21)
TIES = np.asarray([[3.0, 1.0, 3.0, -2.0, 1.0, 0.5], [2.0, 2.0, 2.0, -1.0, 7.0, 2.0],
                   [0.0, -0.5, 4.0, 4.0, 4.0, 1.0], [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]])
DTYPES = ["float64", "float32", "int64", "int8", "uint8", "uint16", "uint32", "uint64", "bool"]


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _data(dtype):
    if dtype == "bool":
        return TIES > 1.0
    if dtype.startswith("uint"):
        big = np.iinfo(dtype).max
        return np.asarray([[big, 1, 3, 0, 1, big - 1], [2, 2, 2, 9, 7, 2], [0, 5, 4, 4, 4, 1],
                           [1, 1, 1, 1, 1, 1]], dtype=dtype)
    return (TIES * 3).astype(dtype)


def _run(build, args):
    """Each package's outputs of ``build(m) -> (inputs, outputs)`` on ``args``."""
    results = []
    for m in (JAX, PORT):
        ins, outs = build(m)
        results.append([_host(v) for v in m["pkg"].function(ins, outs)(*args)])
    return results


def _assert_same(results, exact=True):
    want, got = results
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", [0, -1, None], ids=str)
def test_sort_and_argsort(dtype, axis):
    def build(m):
        x = m["at"].matrix("x", dtype=dtype)
        return [x], [m["sort"].sort(x, axis=axis), m["sort"].argsort(x, axis=axis)]

    _assert_same(_run(build, [_data(dtype)]))


@pytest.mark.parametrize("dtype", DTYPES[:-1])
@pytest.mark.parametrize("k", [1, 3, 6, -1, -4])
@pytest.mark.parametrize("axis", [-1, 0])
def test_topk_and_argtopk_with_ties(dtype, k, axis):
    if axis == 0 and abs(k) > 4:
        k = 4 if k > 0 else -4

    def build(m):
        x = m["at"].matrix("x", dtype=dtype)
        s = m["sort"]
        return [x], [s.topk(x, k, axis=axis), s.argtopk(x, k, axis=axis), *s.topk_and_argtopk(x, k, axis=axis)]

    _assert_same(_run(build, [_data(dtype)]))


def test_argtopk_ties_on_a_flat_score_vector():
    """The beam search's case: a (beam * V,) joint score with runs of equal
    values and -inf lanes."""
    joint = np.asarray([-np.inf, -1.0, -np.inf, -2.0, -1.0, -np.inf, -1.0, -np.inf], dtype="float64")

    def build(m):
        x = m["at"].vector("x", dtype="float64")
        return [x], [m["sort"].argtopk(x, 6), m["sort"].argtopk(x, -3)]

    results = _run(build, [joint])
    _assert_same(results)
    np.testing.assert_array_equal(results[1][0], [1, 4, 6, 3, 0, 2])


@pytest.mark.parametrize("ndim", [1, 2])
def test_the_gradients_of_sort_and_topk(ndim):
    x0 = RNG.normal(size=(5,) if ndim == 1 else (3, 5))
    w0 = RNG.normal(size=x0.shape)

    def build(m):
        at, s = m["at"], m["sort"]
        x = at.vector("x", dtype="float64") if ndim == 1 else at.matrix("x", dtype="float64")
        w = at.vector("w", dtype="float64") if ndim == 1 else at.matrix("w", dtype="float64")
        cost = at.sum(s.sort(x, axis=-1) * w) + at.sum(s.topk(x, 2, axis=-1) ** 2) + at.sum(s.topk(x, -2) * 3.0)
        return [x, w], m["pkg"].grad(cost, [x, w])

    _assert_same(_run(build, [x0, w0]), exact=False)


@pytest.mark.parametrize("mode", ["cumsum", "cumprod"])
@pytest.mark.parametrize("axis", [0, 1, None], ids=str)
def test_cumsum_and_cumprod_and_their_gradients(mode, axis):
    x0 = RNG.uniform(0.5, 1.5, size=(3, 4))

    def build(m):
        at = m["at"]
        x = at.matrix("x", dtype="float64")
        y = getattr(m["xo"], mode)(x, axis=axis)
        cost = at.sum(y * np.arange(y.type.shape[-1] or 12.0) if axis is None else y * np.arange(4.0))
        return [x], [y, m["pkg"].grad(cost, x)]

    _assert_same(_run(build, [x0]), exact=False)


def test_cum_ops_of_a_scalar_and_of_int8_wrap():
    def build(m):
        at, xo = m["at"], m["xo"]
        s = at.scalar("s", dtype="float64")
        i = at.vector("i", dtype="int8")
        return [s, i], [xo.cumsum(s), xo.cumprod(s), xo.cumsum(i), xo.cumprod(i), xo.cumprod(i, axis=0)]

    _assert_same(_run(build, [np.float64(2.5), np.asarray([100, 100, 7, -3, 2], dtype="int8")]))


def test_broadcast_to_its_gradient_and_broadcast_arrays():
    x0, y0 = RNG.normal(size=(1, 3)), RNG.normal(size=(4, 1))

    def build(m):
        at, xo = m["at"], m["xo"]
        tt = importlib.import_module(f"{m['pkg'].__name__}.tensor.type").TensorType
        x = tt("float64", (1, 3))("x")
        y = tt("float64", (4, 1))("y")
        b = xo.broadcast_to(x, (2, 4, 3))
        bx, by = xo.broadcast_arrays(x, y)
        cost = at.sum(b * np.arange(24.0).reshape(2, 4, 3)) + at.sum(bx * by)
        return [x, y], [b, bx, by, *m["pkg"].grad(cost, [x, y])]

    _assert_same(_run(build, [x0, y0]), exact=False)


def test_a_broadcast_view_is_not_written_through():
    """``broadcast_to(c)`` is a view of c with zero strides; ``+ 0.0`` after
    it and the loop's own copy of a state keep every writer off it."""
    x0 = np.arange(3.0)

    def build(m):
        at, xo = m["at"], m["xo"]
        x = at.vector("x", dtype="float64")
        b = xo.broadcast_to(x.dimshuffle("x", 0), (4, 3))
        from importlib import import_module

        sub = import_module(f"{m['pkg'].__name__}.tensor.subtensor")
        return [x], [b, sub.set_subtensor(b[1], x * 10.0)]

    want, got = _run(build, [x0])
    _assert_same((want, got))
    np.testing.assert_array_equal(got[0], np.tile(x0, (4, 1)))
