"""Updates, ``Out`` and the encoder train step: the port's ``function``
with ``updates=`` against the JAX package's.  The train step is the
flagship benchmark's (``benchmarks/bench_transformer.py:26-67``) at a
small size: 2 layers, d=64, 4 heads, d_ff=128, B=2, a shared ``x``,
``sgd(lr=0.01)`` on mean(h²).  Weights are carried across with
``load_params``; over 3 steps the loss and every parameter match JAX
``FAST_RUN`` within atol/rtol 1e-5."""

import numpy as np
import pytest
import torch

import aesara_tpu
from aesara_tpu.compile.function import Out as JOut
from aesara_tpu.models.optim import sgd as jsgd
from aesara_tpu.models.transformer import TransformerEncoderLayer as JLayer
from aesara_tpu.tensor import math as jtm

import aesara_tpu_torch
from aesara_tpu_torch.compile.io import Out as POut
from aesara_tpu_torch.models.convert import load_params
from aesara_tpu_torch.models.optim import sgd as psgd
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as PLayer
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.config import config


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, Out=JOut, sgd=jsgd, Layer=JLayer, tm=jtm, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, Out=POut, sgd=psgd, Layer=PLayer, tm=ptm,
            mode=aesara_tpu_torch.get_mode("TORCH").excluding("BlasOpt"))
BOTH = pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])

#: Composite nodes in the port's rewritten 2-layer train step without
#: BlasOpt (the port's mode here excludes it; ``test_torch_blas.py`` holds
#: the step with it).  The JAX package's FAST_RUN.excluding("BlasOpt")
#: graph gave 48, 50 or 45 on the same model, depending on the process's
#: hash seed and on whether torch was imported (its rewrites walk sets in
#: hash order), so the port's count is pinned rather than compared.
N_COMPOSITE = 48


def _value(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@BOTH
def test_counter_update_reads_the_old_value(m):
    c = m["pkg"].shared(np.asarray(0.0, dtype="float32"), name="c")
    f = m["pkg"].function([], c, updates=[(c, c + 1.0)], mode=m["mode"])
    got = [float(_value(f())) for _ in range(3)]
    assert got == [0.0, 1.0, 2.0]
    assert float(c.get_value()) == 3.0


@BOTH
def test_swap_by_updates_reads_values_from_before_the_call(m):
    a = m["pkg"].shared(np.arange(3, dtype="float32"), name="a")
    b = m["pkg"].shared(np.arange(3, 6, dtype="float32"), name="b")
    f = m["pkg"].function([], m["tm"].sum(a), updates={a: b, b: a}, mode=m["mode"])
    assert float(_value(f())) == 3.0
    np.testing.assert_array_equal(a.get_value(), [3, 4, 5])
    np.testing.assert_array_equal(b.get_value(), [0, 1, 2])
    f()
    np.testing.assert_array_equal(a.get_value(), [0, 1, 2])


@BOTH
def test_duplicate_update_target_raises(m):
    c = m["pkg"].shared(np.asarray(0.0, dtype="float32"), name="c")
    with pytest.raises(ValueError, match="duplicate"):
        m["pkg"].function([], c, updates=[(c, c + 1.0), (c, c * 2.0)], mode=m["mode"])


def test_update_of_another_type_raises():
    w = aesara_tpu_torch.shared(np.zeros(3, dtype="float32"), name="w")
    with pytest.raises(TypeError, match="update of w"):
        aesara_tpu_torch.function([], updates=[(w, ptm.sum(w))])
    with pytest.raises(TypeError, match="shared"):
        aesara_tpu_torch.function([], updates=[(ptm.sum(w), w)])


def test_out_borrow_returns_the_shared_storage_and_no_borrow_a_copy():
    w = aesara_tpu_torch.shared(np.arange(4, dtype="float32"), name="w")
    borrowed = aesara_tpu_torch.function([], POut(w, borrow=True))()
    copied = aesara_tpu_torch.function([], w)()
    view = aesara_tpu_torch.function([], [w.dimshuffle("x", 0)])()[0]
    assert borrowed.data_ptr() == w.value.data_ptr()
    assert copied.data_ptr() != w.value.data_ptr()
    assert view.untyped_storage().data_ptr() != w.value.untyped_storage().data_ptr()
    copied += 10.0
    np.testing.assert_array_equal(w.get_value(), [0, 1, 2, 3])
    # a new value returned without borrow does not alias the updated variable
    f = aesara_tpu_torch.function([], w * 2.0, updates=[(w, w * 2.0)])
    out = f()
    out += 1.0
    np.testing.assert_array_equal(w.get_value(), [0, 2, 4, 6])


def _train_step(m, T, mode=None):
    layers = [m["Layer"](64, 4, 128, seed=i) for i in range(2)]
    x = m["pkg"].shared(np.random.default_rng(T).normal(size=(2, T, 64)).astype("float32"), name="x")
    h = x
    for layer in layers:
        h = layer(h)
    loss = m["tm"].mean(m["tm"].sqr(h))
    params = [p for layer in layers for p in layer.params]
    step = m["pkg"].function([], m["Out"](loss, borrow=True), updates=m["sgd"](loss, params, lr=0.01),
                             mode=mode or m["mode"])
    return layers, params, step


def _count(fgraph, name):
    return sum(1 for n in fgraph.toposort()
               if type(n.op).__name__ == name
               or type(getattr(n.op, "scalar_op", None)).__name__ == name)


@pytest.mark.parametrize("T", [16, 96])
def test_encoder_train_step_matches_jax(T):
    jlayers, jparams, jstep = _train_step(JAX, T)
    players, pparams, pstep = _train_step(PORT, T)
    for jl, pl in zip(jlayers, players):
        load_params(pl, jl.get_values())
    losses = []
    for _ in range(3):
        want, got = float(np.asarray(jstep())), pstep()
        assert isinstance(got, torch.Tensor) and got.shape == ()
        np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=1e-5)
        for jp, pp in zip(jparams, pparams):
            np.testing.assert_allclose(pp.get_value(), np.asarray(jp.get_value()),
                                       atol=1e-5, rtol=1e-5, err_msg=pp.name)
        losses.append(float(got))
    assert losses[0] > losses[1] > losses[2]

    jf, pf = jstep.maker.fgraph, pstep.maker.fgraph
    for name in ("FusedAttention", "FusedAttentionGrad"):
        assert _count(pf, name) == _count(jf, name) == 2, name
    assert _count(pf, "Composite") == N_COMPOSITE
    # the gradient's fills and shape vectors are gone; the one Shape left
    # is the length of local_sumsqr2dot's flatten (Prod(Shape(x))), as in
    # the JAX package's graph
    assert _count(pf, "Second") == 0 and _count(pf, "Shape") == _count(jf, "Shape") == 1


def test_train_step_graph_is_the_same_under_any_hash_seed():
    import os
    import subprocess
    import sys

    code = ("import numpy as np, aesara_tpu_torch as ptp\n"
            "ptp.config.device = 'cpu'\n"
            "from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as L\n"
            "from aesara_tpu_torch.models.optim import sgd\n"
            "from aesara_tpu_torch.tensor import math as tm\n"
            "ls = [L(64, 4, 128, seed=i) for i in range(2)]\n"
            "h = ptp.shared(np.zeros((2, 16, 64), 'float32'))\n"
            "for l in ls: h = l(h)\n"
            "loss = tm.mean(tm.sqr(h))\n"
            "f = ptp.function([], loss, updates=sgd(loss, [p for l in ls for p in l.params]),\n"
            "                 mode=ptp.get_mode('TORCH').excluding('BlasOpt'))\n"
            "nodes = f.maker.fgraph.toposort()\n"
            "print(sorted(str(n.op) for n in nodes))\n"
            "print(sum(type(getattr(n.op, 'scalar_op', None)).__name__ == 'Composite' for n in nodes))\n")
    outs = set()
    for seed in ("0", "1"):
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                             env={**os.environ, "PYTHONHASHSEED": seed}, check=True)
        outs.add(res.stdout)
    assert len(outs) == 1
    assert outs.pop().split()[-1] == str(N_COMPOSITE)
