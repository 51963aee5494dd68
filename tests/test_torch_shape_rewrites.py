"""``ShapeFeature`` and the shape and subtensor rewrites of the port against
the JAX package's, on the CPU.

``shape_of`` of every variable of graphs over each op family is computed
by both packages' ``ShapeFeature`` and evaluated on the same inputs: the
values must be the JAX package's and the outputs' true shapes.  Then the
op counts after ``FAST_RUN`` of graphs that reshape by a shape unknown at
build time, slice a slice, index an ``Alloc``, and set then get a
subtensor: the port's counts equal the JAX package's, and the values
agree within 1e-6 (float32; a tanh or a sum may round differently).
"""

from collections import Counter

import numpy as np
import pytest

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.graph.fg import FunctionGraph as JFunctionGraph
from aesara_tpu.tensor.rewriting.shape import ShapeFeature as JShapeFeature

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.compile.mode import optdb
from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.fg import FunctionGraph as PFunctionGraph
from aesara_tpu_torch.tensor.rewriting.shape import ShapeFeature as PShapeFeature, ShapeOptimizer, UnShapeOptimizer


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, fg=JFunctionGraph, sf=JShapeFeature, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, fg=PFunctionGraph, sf=PShapeFeature, mode="TORCH")
RNG = np.random.default_rng(0)
A = RNG.normal(size=(4, 6)).astype("float32")
B = RNG.normal(size=(6, 5)).astype("float32")
V = RNG.normal(size=6).astype("float32")


def _host(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


#: graphs over each op family: (a 4x6 matrix a, a 6x5 matrix b, a 6-vector v) -> outputs
FAMILIES = {
    "elemwise": lambda at, a, b, v: [at.tanh(a) + v, a * 2.0],
    "dimshuffle": lambda at, a, b, v: [a.T, v.dimshuffle("x", 0, "x")],
    "careduce": lambda at, a, b, v: [a.sum(axis=0), a.max(axis=1), at.argmax(a, axis=1)],
    "dot": lambda at, a, b, v: [at.dot(a, b), at.dot(a, v), at.dot(v, b)],
    "reshape": lambda at, a, b, v: [a.reshape((2, 12)), a.reshape((a.shape[1], -1)), a.flatten()],
    "subtensor": lambda at, a, b, v: [a[1:3], a[::-2, 2], a[:, 1:-1]],
    "inc_subtensor": lambda at, a, b, v: [at.inc_subtensor(a[1:3], 1.0), at.set_subtensor(a[:, 0], 0.0)],
    "advanced": lambda at, a, b, v: [a[np.array([0, 2, 2])], a[:, np.array([5, 1])],
                                     a[np.array([True, False, True, True])]],
    "join_split": lambda at, a, b, v: [at.concatenate([a, a], axis=0), at.concatenate([a, b.T], axis=0),
                                       at.split(v, [2, 4], 2, axis=0)[1]],
    "alloc": lambda at, a, b, v: [at.alloc(v, 3, 6), at.zeros_like(a), at.ones((a.shape[0], 2))],
    "arange_eye": lambda at, a, b, v: [at.arange(a.shape[1]), at.eye(a.shape[0]), at.tri(3, a.shape[1])],
    "diag": lambda at, a, b, v: [at.diagonal(a), at.diag(v), at.extract_diag(a, offset=1)],
    "shape_ops": lambda at, a, b, v: [at.shape(a), a.shape[1] * 2, at.specify_shape(a, (4, 6)) + 1.0],
    "softmax": lambda at, a, b, v: [at.nnet.softmax(a), at.nnet.logsoftmax(a)],
    "cum_sort": lambda at, a, b, v: [at.cumsum(a, axis=1), at.sort(a, axis=0), at.argsort(v)],
}


def _shape_values(m, name):
    at = m["at"]
    a, b, v = at.matrix("a"), at.matrix("b"), at.vector("v")
    outs = FAMILIES[name](at, a, b, v)
    fg = m["fg"]([a, b, v], outs, clone=False)
    sf = m["sf"]()
    fg.attach_feature(sf)
    dims = [sf.shape_of[o] for o in outs]
    flat = [d for ds in dims for d in ds]
    f = m["pkg"].function([a, b, v], flat + outs, mode=m["mode"], on_unused_input="ignore")
    res = [_host(r) for r in f(A, B, V)]
    k, shapes = 0, []
    for ds in dims:
        shapes.append(tuple(int(x) for x in res[k:k + len(ds)]))
        k += len(ds)
    return shapes, [r.shape for r in res[len(flat):]]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_shape_of_is_the_jax_packages_and_the_true_shape(name):
    jshapes, jtrue = _shape_values(JAX, name)
    pshapes, ptrue = _shape_values(PORT, name)
    assert pshapes == jshapes
    assert pshapes == [tuple(s) for s in ptrue] == [tuple(s) for s in jtrue]


def test_shape_optimizer_and_unshape_optimizer_sit_at_the_jax_packages_positions():
    assert optdb._position["ShapeOpt"] == 0.1 and optdb._position["UnShapeOpt"] == 10
    assert isinstance(optdb["ShapeOpt"], ShapeOptimizer) and isinstance(optdb["UnShapeOpt"], UnShapeOptimizer)


def test_x_shape_is_a_shape_vector():
    x = pat.matrix("x")
    assert type(x.shape.owner.op).__name__ == "Shape"
    assert type(x.shape[0].owner.op).__name__ == "Subtensor"
    assert len(list(pat.matrix("y", shape=(3, None)).shape[:1])) == 1


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


#: graphs whose FAST_RUN op counts the port must share: (x, y, n) -> outputs
GRAPHS = {
    "reshape_by_unknown_shape": lambda at, x, y, n: [x.reshape((x.shape[0] * x.shape[1],)),
                                                      (x * 2.0).reshape((y.shape[1], -1))],
    "reshape_to_own_shape": lambda at, x, y, n: [at.tanh(x).reshape(x.shape), x.reshape((x.shape[0], x.shape[1], 1))],
    "slice_of_a_slice": lambda at, x, y, n: [x[1:][:, 2:5][::2], x[2:][1]],
    "index_an_alloc": lambda at, x, y, n: [at.alloc(y[0], 7, y.shape[1])[2:5], at.alloc(x[0, 0], 5, x.shape[1])[1]],
    "set_then_get": lambda at, x, y, n: [at.set_subtensor(x[1:3], y[:2, :6])[1:3], at.inc_subtensor(x[0], 1.0)[0]],
    "shape_arithmetic": lambda at, x, y, n: [at.ones((x.shape[0], y.shape[0])) * at.sum(x), x[: x.shape[0] - 1]],
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fast_run_op_counts_are_the_jax_packages(name):
    X = RNG.normal(size=(4, 6)).astype("float32")
    Y = RNG.normal(size=(3, 8)).astype("float32")
    counts, values = [], []
    for m in (JAX, PORT):
        at = m["at"]
        x, y, n = at.matrix("x"), at.matrix("y"), at.lscalar("n")
        f = m["pkg"].function([x, y, n], GRAPHS[name](at, x, y, n), mode=m["mode"], on_unused_input="ignore")
        counts.append(op_counts(f))
        values.append([_host(o) for o in f(X, Y, 3)])
    assert counts[1] == counts[0]
    for p, j in zip(values[1], values[0]):
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6)
