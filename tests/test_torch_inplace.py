"""In-place updates and the encoder in float64 on the CPU.

* The encoder in float64 (2 layers, d_model 64, 4 heads, T 16, B 2), its
  weights carried from the JAX package's by ``load_params``: the forward
  and one sgd step within 1e-12 of each tensor's scale of the JAX
  package's (x64 on the CPU), with its FusedAttention, FusedAttentionGrad
  and BLAS op counts, and the fp32 graph's Composite count.
* ``blas_inplace``: after ``FAST_RUN`` the same Gemm, Gemv and Ger nodes are
  ``inplace`` as in the JAX package, on the encoder's step, config 3's
  step and small graphs built for it (a z that is an intermediate read
  once; a z that views an input, or is read twice, stays out of place).
* Donation (``TorchLinker(donate_updated=)``): the sgd and AdamW encoder
  steps, config 3 through ``givens`` and the LSTM with adam give the same
  bits over 3 steps with it on and off; with it on the nodes that compute
  the updates write into the shared storage (whose ``data_ptr`` never
  changes).  The cases it must not take (an output that returns an
  updated variable's old value, two shared variables on one borrowed
  array, a swap, an update that is also an output) give the copying run's
  values and numpy's."""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import aesara_tpu
from aesara_tpu.models.optim import sgd as jsgd
from aesara_tpu.models.transformer import TransformerEncoderLayer as JLayer
from aesara_tpu.tensor import math as jtm

import aesara_tpu_torch as ptp
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models.convert import load_params
from aesara_tpu_torch.models.optim import adamw, sgd as psgd
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as PLayer
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.tensor.blas import gemm

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_mlp as mlp  # noqa: E402
import test_torch_rnn as rnn  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, rel, name):
    got, want = np.asarray(_host(got), dtype="float64"), np.asarray(_host(want), dtype="float64")
    assert got.shape == want.shape, name
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{name}: {err / scale:.3e} of the scale (tolerance {rel})"


# --- the encoder in float64 -------------------------------------------------------

B, T, D, HEADS, FF = 2, 16, 64, 4, 128


def _encoder(pkg, Layer, sgd, tm, change_flags, mode, dtype="float64"):
    """(layers, params, forward, step) of the 2-layer encoder in ``dtype``:
    the forward of an input x and an sgd step on mean(h²) of a shared x."""
    xv = np.random.default_rng(7).normal(size=(B, T, D)).astype(dtype)
    with change_flags(floatX=dtype):
        layers = [Layer(D, HEADS, FF, seed=i) for i in range(2)]
        params = [p for layer in layers for p in layer.params]
        xs = pkg.shared(xv, name="x")

        def run(h):
            for layer in layers:
                h = layer(h)
            return h

        x = pkg.tensor.tensor3("x", dtype=dtype)
        forward = pkg.function([x], run(x), mode=mode)
        loss = tm.mean(tm.sqr(run(xs)))
        step = pkg.function([], loss, updates=sgd(loss, params, lr=0.01), mode=mode)
    return layers, params, forward, step, xv


def _counts(fgraph):
    names = Counter(type(n.op).__name__ for n in fgraph.toposort())
    names["Composite"] = sum(type(getattr(n.op, "scalar_op", None)).__name__ == "Composite"
                             for n in fgraph.toposort())
    return names


def test_the_encoder_in_float64_matches_the_jax_package():
    import aesara_tpu.tensor  # noqa: F401  (pkg.tensor below)

    jl, jparams, jforward, jstep, xv = _encoder(aesara_tpu, JLayer, jsgd, jtm, aesara_tpu.config.change_flags,
                                               "FAST_RUN")
    pl, pparams, pforward, pstep, _ = _encoder(ptp, PLayer, psgd, ptm, config.change_flags, "TORCH")
    for a, b in zip(jl, pl):
        load_params(b, a.get_values())
    assert all(p.get_value().dtype == np.float64 for p in pparams)
    _close(pforward(xv), jforward(xv), 1e-12, "forward")
    _close(pstep(), jstep(), 1e-12, "loss")
    for jp, pp in zip(jparams, pparams):
        _close(pp.get_value(), jp.get_value(), 1e-12, pp.name)
    jc, pc = _counts(jstep.maker.fgraph), _counts(pstep.maker.fgraph)
    for name in ("FusedAttention", "FusedAttentionGrad", "Dot22Scalar", "Gemm", "Gemv", "Ger"):
        assert pc[name] == jc[name], name
    assert pc["FusedAttention"] == pc["FusedAttentionGrad"] == 2
    # the fp32 graph's fusion: as many Composites in float64
    fp32 = _encoder(ptp, PLayer, psgd, ptm, config.change_flags, "TORCH", dtype="float32")[3]
    assert pc["Composite"] == _counts(fp32.maker.fgraph)["Composite"]


# --- blas_inplace against the JAX package ----------------------------------------


def _blas_graphs(pkg, at):
    """Small graphs with a Gemm, Gemv or Ger: (inputs, outputs) by name."""
    a, b, c, d = (at.matrix(n) for n in "abcd")
    u, v = at.vector("u"), at.vector("v")
    z = at.dot(a, b)
    return {
        "gemm-z-intermediate": ([a, b, c, d], [at.dot(a, b) + at.dot(c, d)]),
        "gemm-z-read-twice": ([a, b, c, d], [z + at.dot(c, d), z * 2.0]),
        "gemm-z-views-an-input": ([a, c, d], [a[::-1] + at.dot(c, d)]),
        "gemv-z-intermediate": ([a, b, u, v], [at.dot(a, u) + at.dot(b, v)]),
        "ger-z-intermediate": ([a, b, u, v], [at.dot(a, b) + at.outer(u, v)]),
    }


def _blas_nodes(fn):
    return sorted(str(n.op) for n in fn.maker.fgraph.toposort() if type(n.op).__name__ in ("Gemm", "Gemv", "Ger"))


@pytest.mark.parametrize("which", ["gemm-z-intermediate", "gemm-z-read-twice", "gemm-z-views-an-input",
                                   "gemv-z-intermediate", "ger-z-intermediate"])
def test_blas_inplace_takes_the_jax_packages_nodes(which):
    import aesara_tpu.tensor as jat

    rng = np.random.default_rng(3)
    values = None
    got = {}
    for name, pkg, at, mode in (("jax", aesara_tpu, jat, "FAST_RUN"), ("port", ptp, pat, "TORCH")):
        inputs, outputs = _blas_graphs(pkg, at)[which]
        fn = pkg.function(inputs, outputs, mode=mode)
        if values is None:
            values = [rng.normal(size=(4,) if i.type.ndim == 1 else (4, 4)).astype("float32") for i in inputs]
        got[name] = (_blas_nodes(fn), [_host(o) for o in fn(*values)])
    assert got["port"][0] == got["jax"][0]
    assert got["port"][0], "the graph has a BLAS node"
    assert any("{inplace}" in s for s in got["port"][0]) == (which.endswith("intermediate"))
    for p, j in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_allclose(p, j, atol=1e-5, rtol=1e-5)


def test_blas_inplace_on_the_encoder_step_and_config3_is_the_jax_packages():
    import test_torch_train as train

    for jm, pm in ((mlp.JAX, mlp.PORT),):
        assert _blas_nodes(mlp.build(jm, 3)[0]) == _blas_nodes(mlp.build(pm, 3)[0])
    j = train._train_step(train.JAX, 16, mode="FAST_RUN")[2]
    p = train._train_step(train.PORT, 16, mode="TORCH")[2]
    assert _blas_nodes(j) == _blas_nodes(p)


# --- donation on and off --------------------------------------------------------------


def _mode(donate: bool):
    return ptp.Mode(ptp.TorchLinker(donate_updated=donate))


def _encoder_step(optimizer, donate):
    with config.change_flags(floatX="float32"):
        layers = [PLayer(D, HEADS, FF, seed=i) for i in range(2)]
        params = [p for layer in layers for p in layer.params]
        h = x = ptp.shared(np.random.default_rng(5).normal(size=(B, T, D)).astype("float32"), name="x")
        for layer in layers:
            h = layer(h)
        loss = ptm.mean(ptm.sqr(h))
        updates = psgd(loss, params, lr=0.01) if optimizer == "sgd" else adamw(loss, params, lr=1e-3)
        step = ptp.function([], loss, updates=updates, mode=_mode(donate))
    return step, params, [], lambda i: ()


def _config3_step(_, donate):
    step, _, params, _ = mlp.build(dict(mlp.PORT, mode=_mode(donate)), 3)
    return step, params, [], lambda i: (np.int32(i),)


def _lstm_step(_, donate):
    step, model = rnn.build_model(rnn.PORT, "LSTM", "float32", _mode(donate))
    data = rnn._data("float32")
    return step, model.params, [], lambda i: data


BUILDS = {"encoder-sgd": (_encoder_step, "sgd"), "encoder-adamw": (_encoder_step, "adamw"),
          "config3-givens": (_config3_step, None), "lstm-adam": (_lstm_step, None)}


def _shared_state(step):
    """Every shared variable the step updates (parameters, optimizer state)."""
    return list(step.update_targets)


@pytest.mark.parametrize("which", list(BUILDS))
def test_donation_on_and_off_give_the_same_bits(which):
    build, optimizer = BUILDS[which]
    runs = {}
    for donate in (True, False):
        torch.manual_seed(0)
        step, params, _, args = build(optimizer, donate)
        state = _shared_state(step)
        ptrs = [s.value.data_ptr() for s in state]
        trace = []
        for i in range(3):
            out = step(*args(i))
            trace.append([None if out is None or isinstance(out, list) else out.clone()]
                         + [s.value.clone() for s in state])
            assert [s.value.data_ptr() for s in state] == ptrs
        program = step.fn.program
        runs[donate] = (trace, program, step.fn.donating)
    trace_on, program_on, donating = runs[True]
    trace_off, program_off, _ = runs[False]
    assert donating and program_on.donated and not program_off.donated
    assert program_on.donation_fallbacks == 0
    for a, b in zip(trace_on, trace_off):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)


def test_donation_writes_through_the_k1_launch_and_the_gemm():
    """The update nodes of an sgd step: K1 Composites and a Gemm whose z is
    the variable, each kept by the destroy handler."""
    w = ptp.shared(np.ones((3, 4), "float32"), name="w")
    b = ptp.shared(np.ones(4, "float32"), name="b")
    x, y = pat.matrix("x"), pat.matrix("y")
    loss = ptm.mean(ptm.sqr(pat.tanh(pat.dot(x, w) + b)))
    gw, gb = ptp.grad(loss, [w, b])
    # w's update is a Gemm with z = w
    f = ptp.function([x, y], loss, updates={w: gemm(w, np.float32(-0.1), x.T, y, np.float32(1.0)),
                                            b: b * 0.9 - 0.1 * gb})
    kinds = sorted(type(n.op).__name__ + ("/" + type(n.op.scalar_op).__name__ if hasattr(n.op, "scalar_op") else "")
                   for n in f.fn.program.donated)
    assert kinds == ["Elemwise/Composite", "Gemm"]
    xv, yv = np.ones((2, 3), "float32"), np.full((2, 4), 0.5, "float32")
    wv, bv = np.ones((3, 4)), np.ones(4)
    for _ in range(2):
        f(xv, yv)
        g_b = (1 - np.tanh(xv @ wv + bv) ** 2) * np.tanh(xv @ wv + bv) * 2 / 8
        wv, bv = wv - 0.1 * xv.T @ yv, bv * 0.9 - 0.1 * g_b.sum(0)
        np.testing.assert_allclose(w.get_value(), wv, rtol=1e-5)
        np.testing.assert_allclose(b.get_value(), bv, rtol=1e-5)


def _both(build):
    """The values of build(mode) for donation on and off, each as numpy."""
    return [build(_mode(d)) for d in (True, False)]


def test_an_output_returning_the_old_value_is_not_donated():
    def build(mode):
        w = ptp.shared(np.arange(4, dtype="float32"), name="w")
        f = ptp.function([], [w, w.dimshuffle("x", 0)], updates={w: w * 2.0 + 1.0}, mode=mode)
        outs = [[_host(o).copy() for o in f()] for _ in range(2)]
        return outs, w.get_value(), f.fn.program.donated
    (on, w_on, donated), (off, w_off, _) = _both(build)
    assert not donated
    for a, b in zip(on, off):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(on[1][0], [1, 3, 5, 7])
    np.testing.assert_array_equal(w_on, w_off)
    np.testing.assert_array_equal(w_on, [3, 7, 11, 15])


@pytest.mark.parametrize("one_storage", [False, True], ids=["borrowed", "one-storage"])
def test_two_shared_variables_on_one_borrowed_array_take_the_copying_route(one_storage):
    """``shared(arr, borrow=True)`` copies ``arr`` in the port, so two
    variables made from one array hold two storages; two variables whose
    values are one tensor (set so by hand) share it, and their updates take
    the copying route: each update is written in turn, as without
    donation."""
    def build(mode):
        arr = np.arange(4, dtype="float32")
        a = ptp.shared(arr, name="a", borrow=True)
        b = ptp.shared(arr, name="b", borrow=True)
        if one_storage:
            b._value = a.value
        assert (a.value.data_ptr() == b.value.data_ptr()) == one_storage
        f = ptp.function([], ptm.sum(a), updates={a: a * 2.0 + 1.0, b: b * 3.0 - 1.0}, mode=mode)
        got = [float(f()) for _ in range(2)]
        return got, a.get_value(), b.get_value(), f.fn.donating
    (on, a_on, b_on, donating), (off, a_off, b_off, _) = _both(build)
    assert donating != one_storage
    assert on == off
    np.testing.assert_array_equal(a_on, a_off)
    np.testing.assert_array_equal(b_on, b_off)
    a, b = np.arange(4.0), np.arange(4.0)
    for _ in range(2):
        a, b = a * 2 + 1, b * 3 - 1
        if one_storage:
            a = b = b.copy()   # b's update is written last, into the one storage
    np.testing.assert_array_equal(a_on, a)
    np.testing.assert_array_equal(b_on, b)


def test_a_swap_and_an_update_that_is_also_an_output():
    def build(mode):
        a = ptp.shared(np.arange(3, dtype="float32"), name="a")
        b = ptp.shared(np.arange(3, 6, dtype="float32"), name="b")
        c = ptp.shared(np.ones(3, "float32"), name="c")
        new_c = c * 2.0 + a
        f = ptp.function([], [new_c, ptm.sum(a)], updates={a: b, b: a, c: new_c}, mode=mode)
        outs = [[_host(o).copy() for o in f()] for _ in range(3)]
        return outs, a.get_value(), b.get_value(), c.get_value(), f.fn.program.donated
    (on, a_on, b_on, c_on, donated), (off, *rest_off, _) = _both(build)
    assert [v.name for v in donated.values() for v in v[:1]] == ["c"]
    for x, y in zip(on, off):
        for p, q in zip(x, y):
            np.testing.assert_array_equal(p, q)
    for got, want in zip((a_on, b_on, c_on), rest_off):
        np.testing.assert_array_equal(got, want)
    # numpy: a, b swap each call; c <- 2c + a
    a, b, c = np.arange(3.0), np.arange(3.0, 6.0), np.ones(3)
    for k in range(3):
        c = c * 2 + a
        np.testing.assert_array_equal(on[k][0], c)
        a, b = b, a
    np.testing.assert_array_equal(c_on, c)
    np.testing.assert_array_equal(a_on, a)


def test_the_returned_update_does_not_alias_the_shared_storage():
    w = ptp.shared(np.arange(4, dtype="float32"), name="w")
    f = ptp.function([], w * 2.0 + 1.0, updates={w: w * 2.0 + 1.0})
    out = f()
    assert f.fn.program.donated and out.data_ptr() != w.value.data_ptr()
    out += 100.0
    np.testing.assert_array_equal(w.get_value(), [1, 3, 5, 7])


def test_the_config_flag_and_the_linker_argument_turn_donation_off():
    w = ptp.shared(np.arange(4, dtype="float32"), name="w")
    with config.change_flags(donate_shared=False):
        assert not ptp.function([], [], updates={w: w * 2.0 + 1.0}).fn.program.donated
    assert ptp.function([], [], updates={w: w * 2.0 + 1.0}).fn.program.donated
    assert not ptp.function([], [], updates={w: w * 2.0 + 1.0}, mode=_mode(False)).fn.program.donated


def test_a_view_the_graph_does_not_declare_takes_the_copying_route_at_run_time():
    """An op whose lowering returns a view of its input but declares no
    ``view_map``: the destroy handler lets the update's node write into w,
    and the run-time check (the run's tensors by storage) finds the
    returned view of w and takes the copying route, which returns the old
    value as the run without donation does."""
    from aesara_tpu_torch.graph.ir import Apply
    from aesara_tpu_torch.graph.op import Op
    from aesara_tpu_torch.link.torch.dispatch import torch_funcify

    class HiddenView(Op):
        __props__ = ()

        def make_node(self, x):
            return Apply(self, [x], [x.type()])

        def perform(self, node, inputs, outputs):
            outputs[0][0] = inputs[0]

    @torch_funcify.register(HiddenView)
    def _lower(op, node):
        return lambda x: x.view(x.shape)

    def build(mode):
        w = ptp.shared(np.arange(4, dtype="float32"), name="w")
        f = ptp.function([], HiddenView()(w), updates={w: w * 2.0 + 1.0}, mode=mode)
        outs = [_host(f()).copy() for _ in range(2)]
        return outs, w.get_value(), len(f.fn.program.donated), f.fn.program.donation_fallbacks

    (on, w_on, donated, fallbacks), (off, w_off, _, _) = _both(build)
    assert donated == 1 and fallbacks == 2
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, [[0, 1, 2, 3], [1, 3, 5, 7]])
    np.testing.assert_array_equal(w_on, w_off)


def test_a_donating_run_frees_each_value_after_its_last_reader():
    """With updates written in place the run still drops an intermediate
    after its last reader (the run-time alias check keeps no tensor)."""
    import weakref

    from aesara_tpu_torch.graph.ir import Apply
    from aesara_tpu_torch.graph.op import Op
    from aesara_tpu_torch.link.torch.dispatch import torch_funcify

    refs, seen = [], []

    class Tap(Op):
        __props__ = ()

        def make_node(self, x):
            return Apply(self, [x], [x.type()])

        def perform(self, node, inputs, outputs):
            outputs[0][0] = inputs[0].copy()

    class Probe(Tap):
        pass

    def tap(x):
        out = x * 3.0
        refs.append(weakref.ref(out))
        return out

    def probe(x):
        seen.append(refs[-1]() is None)
        return x.clone()

    torch_funcify.register(Tap)(lambda op, node: tap)
    torch_funcify.register(Probe)(lambda op, node: probe)
    w = ptp.shared(np.arange(4, dtype="float32"), name="w")
    x = pat.vector("x")
    f = ptp.function([x], Probe()(Tap()(x) + 1.0), updates={w: w * 2.0 + 1.0}, mode=_mode(True))
    assert len(f.fn.program.donated) == 1
    np.testing.assert_array_equal(_host(f(np.ones(4, "float32"))), [4, 4, 4, 4])
    assert f.fn.donating and seen == [True]
    np.testing.assert_array_equal(w.get_value(), [1, 3, 5, 7])
