"""The linker's bookkeeping on the CPU: ``allow_gc``, the memo of lowered
programs and its graph keys, updates written into the shared variables'
storage, and the capture decision.  Values are held against the JAX
package's on seeded inputs, atol/rtol 1e-6 (the same float32 ops, in the
same order on one side and the other except for XLA's fusion).

Capture itself needs the card: ``tests/test_torch_cuda.py`` holds a
captured step bitwise against its eager run."""

import weakref

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.tensor import basic as jtb, math as jtm

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.cache import fgraph_key
from aesara_tpu_torch.link.torch.linker import TorchLinker
from aesara_tpu_torch.tensor import basic as ptb, math as ptm


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, tm=jtm, tb=jtb, mode="FAST_RUN")
PORT = dict(pkg=ptp, at=pat, tm=ptm, tb=ptb, mode="TORCH")
TOL = dict(atol=1e-6, rtol=1e-6)


def _value(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _chain(m, x):
    """Intermediates that die early: each value feeds the next two ops only."""
    tm = m["tm"]
    h = tm.dot(x, x.T)
    a = tm.exp(h * 0.01)
    b = tm.sum(a, axis=0)
    c = tm.dot(a, b)
    return [tm.sqrt(tm.sqr(c) + 1.0), tm.max(b)]


@pytest.mark.parametrize("allow_gc", [True, False])
def test_allow_gc_leaves_results_unchanged(allow_gc):
    xv = np.random.default_rng(0).normal(size=(6, 5)).astype("float32")
    outs = {}
    for name, m in (("jax", JAX), ("port", PORT)):
        x = m["at"].matrix("x")
        mode = m["mode"] if name == "jax" else ptp.Mode(TorchLinker())
        with config.change_flags(allow_gc=allow_gc):
            f = m["pkg"].function([x], _chain(m, x), mode=mode)
        outs[name] = [_value(o) for o in f(xv)]
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("allow_gc", [True, False])
def test_allow_gc_frees_intermediates_after_their_last_reader(allow_gc):
    x = pat.matrix("x")
    with config.change_flags(allow_gc=allow_gc):
        f = ptp.function([x], _chain(PORT, x), mode=ptp.Mode(TorchLinker()))
    program = f.fn.program
    freed = [v for vs in program.frees for v in vs]
    kept = set(program.inputs) | set(program.outputs)
    computed = {o for node, fold in zip(program.order, program.folds) if not fold for o in node.outputs}
    if allow_gc:
        # every intermediate read by a later node, once, after its last reader
        assert len(freed) == len(set(freed)) and not set(freed) & kept
        assert computed - kept <= set(freed)
    else:
        assert freed == []
    # watch the first node's device result from the last node
    first = program.fns[0]
    refs, alive = [], []

    def first_fn(*args):
        out = first(*args)
        refs.append(weakref.ref(out))
        return out

    last = program.fns[-1]

    def last_fn(*args):
        alive.append(refs[0]() is not None)
        return last(*args)

    program.fns[0], program.fns[-1] = first_fn, last_fn
    try:
        f(np.ones((6, 5), "float32"))
    finally:
        program.fns[0], program.fns[-1] = first, last
    assert alive == [not allow_gc]


def test_memo_returns_one_lowering_for_identical_graphs():
    def build(scale):
        x, y = pat.matrix("x"), pat.vector("y")
        return ptp.function([x, y], ptm.exp(ptm.dot(x, y) * scale) + 1.0)

    f1, f2, f3 = build(2.0), build(2.0), build(3.0)
    assert fgraph_key(f1.maker.fgraph) == fgraph_key(f2.maker.fgraph) != fgraph_key(f3.maker.fgraph)
    assert f1.fn.program is f2.fn.program
    assert f3.fn.program is not f1.fn.program
    xv, yv = np.ones((3, 2), "float32"), np.arange(2, dtype="float32")
    np.testing.assert_array_equal(_value(f1(xv, yv)), _value(f2(xv, yv)))
    # allow_gc is part of the key
    x, y = pat.matrix("x"), pat.vector("y")
    with config.change_flags(allow_gc=False):
        f4 = ptp.function([x, y], ptm.exp(ptm.dot(x, y) * 2.0) + 1.0)
    assert f4.fn.program is not f1.fn.program


def test_graph_key_sees_every_byte_of_a_large_constant_and_inside_composites():
    big = np.zeros(70000, "float32")
    other = big.copy()
    other[-1] = 1.0
    x = pat.vector("x")
    fa, fb = ptp.function([x], x + big), ptp.function([x], x + other)
    assert fgraph_key(fa.maker.fgraph) != fgraph_key(fb.maker.fgraph)
    np.testing.assert_array_equal(_value(fb(np.zeros(70000, "float32")))[-1:], [1.0])
    # two Composites of the same display name and types, different scalar graphs
    y = pat.vector("y")
    g1 = ptp.function([y], ptm.exp(y * 2.0) - y)
    g2 = ptp.function([y], ptm.exp(y - 2.0) * y)
    assert fgraph_key(g1.maker.fgraph) != fgraph_key(g2.maker.fgraph)


@pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])
def test_updates_keep_the_shared_storage_and_set_value_takes_effect(m):
    w = m["pkg"].shared(np.arange(4, dtype="float32"), name="w")
    c = m["pkg"].shared(np.asarray(0.0, dtype="float32"), name="c")
    f = m["pkg"].function([], m["tm"].sum(w), updates=[(w, w * 2.0 + c), (c, c + 1.0)], mode=m["mode"])
    ptrs = {(w.value.data_ptr(), c.value.data_ptr())} if m is PORT else set()
    got = [float(_value(f())) for _ in range(2)]
    if m is PORT:
        ptrs.add((w.value.data_ptr(), c.value.data_ptr()))
        assert len(ptrs) == 1
    np.testing.assert_allclose(got, [6.0, 12.0])
    np.testing.assert_allclose(w.get_value(), [1, 5, 9, 13])
    w.set_value(np.ones(4, "float32"))
    assert float(_value(f())) == 4.0
    np.testing.assert_allclose(w.get_value(), [4, 4, 4, 4])
    assert float(c.get_value()) == 3.0


def test_an_output_that_reads_an_updated_variable_keeps_the_old_value():
    w = ptp.shared(np.arange(3, dtype="float32"), name="w")
    f = ptp.function([], [ptp.Out(w, borrow=True), w.dimshuffle("x", 0)], updates=[(w, w + 10.0)])
    old, view = f()
    np.testing.assert_array_equal(_value(old), [0, 1, 2])
    np.testing.assert_array_equal(_value(view), [[0, 1, 2]])
    np.testing.assert_array_equal(w.get_value(), [10, 11, 12])
    # an update that reads another target's old value, both written after
    a = ptp.shared(np.zeros(2, "float32"), name="a")
    b = ptp.shared(np.ones(2, "float32"), name="b")
    g = ptp.function([], [], updates=[(a, b.dimshuffle(0)), (b, a * 1.0)])
    g()
    np.testing.assert_array_equal(a.get_value(), [1, 1])
    np.testing.assert_array_equal(b.get_value(), [0, 0])


def test_capture_blocker_names_a_device_arange_and_the_cpu():
    x = pat.vector("x")
    n = ptb.cast(ptm.sum(x), "int64")
    f = ptp.function([x], ptb.arange(0, n, 1, dtype="int64"))
    assert type(f.fn.program.blocker.op).__name__ == "ARange"
    assert f.capture_blocker == "runs on cpu"
    np.testing.assert_array_equal(_value(f(np.asarray([1.0, 2.0], "float32"))), [0, 1, 2])
    assert not f.captured
    # an arange of host bounds folds on the host and blocks nothing
    y = pat.vector("y")
    g = ptp.function([y], y + ptb.arange(0, y.shape[0], 1, dtype="float32"))
    assert g.fn.program.blocker is None
    np.testing.assert_array_equal(_value(g(np.zeros(3, "float32"))), [0, 1, 2])


def test_config_flags_choose_the_linkers_defaults():
    x = pat.vector("x")
    with config.change_flags(allow_gc=False, cuda_graph=False):
        f = ptp.function([x], ptm.exp(x) * 2.0 + 1.0)
    assert all(not vs for vs in f.fn.program.frees)
    with pytest.raises(ValueError):
        config.cuda_graph = "yes"
