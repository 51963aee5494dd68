"""bfloat16 and float16 graphs: the port against the JAX package on the CPU.

The same seeded inputs go through both packages: the JAX package's
bfloat16 values are ml_dtypes arrays, the port's torch.bfloat16 tensors
(NumPy has no bfloat16, and the port does not import ml_dtypes).  The
weights of ``models.base`` are the same bits in both.  Each graph's outputs
agree within ``REL`` of their scale (the largest magnitude of the JAX
package's output): 2e-2 in bfloat16, 1e-2 in float16.

The JAX package's CPU graphs keep more precision inside a fused chain
than the dtype has (XLA's excess precision); the port's Composites round
after every op, as its kernel does.  A bfloat16 gradient of the 2-layer
encoder is then 2-7% of its scale off the float64 result of the same
graph in both packages, and after two sgd steps a bias (which starts at
0, so its scale is two updates) differs between them by up to 3.1% of its
scale.  So the two-step comparison holds the port to the JAX package
within ``REL`` of the scale plus the JAX package's own distance from the
float64 run of the same steps from the same bfloat16 start: the port must
be as close to exact arithmetic as the reference is.  An sgd step at lr
0.01 moves a bfloat16 weight of this scale by less than half an ulp, so
the parameters after it barely show the weights' gradients: the
gradients themselves are compared too, by the same rule, against the JAX
package's flash-attention kernels in interpret mode (``jax_flash``), which
round P and dS to bfloat16 where K2, K3 and their plain versions do.
"""

import contextlib

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ml_dtypes

import aesara_tpu
import aesara_tpu.tensor as jt
from aesara_tpu.compile.function import Out as JOut
from aesara_tpu.gradient import grad as jgrad
from aesara_tpu.models.checkpoint import load_checkpoint as jload, save_checkpoint as jsave
from aesara_tpu.models.optim import adamw_from_grads as jadamw, scaled_loss_updates as jscaled, sgd as jsgd
from aesara_tpu.models.transformer import TransformerEncoderLayer as JLayer
from aesara_tpu.tensor import math as jtm
from aesara_tpu.tensor.nnet.attention import fused_attention as jattention

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pt
from aesara_tpu_torch.compile.io import Out as POut
from aesara_tpu_torch.config import config
from aesara_tpu_torch.gradient import grad as pgrad
from aesara_tpu_torch.link.torch.linker import TorchLinker
from aesara_tpu_torch.misc.safe_asarray import _asarray
from aesara_tpu_torch.models.checkpoint import load_checkpoint as pload, save_checkpoint as psave
from aesara_tpu_torch.models.optim import adamw_from_grads as padamw, scaled_loss_updates as pscaled, sgd as psgd
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as PLayer
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.tensor.nnet.attention import fused_attention as pattention
from aesara_tpu_torch.tensor.type import values_eq_approx


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


REL = {"bfloat16": 2e-2, "float16": 1e-2}
LOW = pytest.mark.parametrize("dtype", ["bfloat16", "float16"])


def f64(v) -> np.ndarray:
    """A value of either package as float64 NumPy."""
    if isinstance(v, torch.Tensor):
        return v.detach().double().numpy()
    return np.asarray(v).astype(np.float64)


def jax_value(x64: np.ndarray, dtype: str) -> np.ndarray:
    return x64.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def port_value(x64: np.ndarray, dtype: str):
    return _asarray(x64, dtype)


def assert_close(port, ref, rel, extra=0.0, what=""):
    port, ref = f64(port), f64(ref)
    assert port.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max()
    assert err <= rel * scale + extra, f"{what}: {err:.3e} > {rel} x {scale:.3e} + {extra:.3e}"


def bits(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v


# -- the dtype plumbing -------------------------------------------------------


@LOW
def test_floatx_takes_the_low_precision_dtypes(dtype):
    with config.change_flags(floatX=dtype):
        assert config.floatX == dtype
        assert pt.matrix("x").type.dtype == dtype
        assert pt.constant(0.5).type.dtype == dtype
    with pytest.raises(ValueError):
        config.floatX = "float8"


def test_shared_holds_a_bfloat16_tensor_and_rounds_numpy_by_torch():
    t = torch.tensor([1.0, 2.5, -3.0], dtype=torch.bfloat16)
    s = aesara_tpu_torch.shared(t, name="s")
    assert s.type.dtype == "bfloat16"
    got = s.get_value()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert torch.equal(got, t)
    x64 = np.random.default_rng(0).normal(size=1000)
    assert np.array_equal(bits(_asarray(x64, "bfloat16")), bits(jax_value(x64, "bfloat16")))
    s2 = aesara_tpu_torch.shared(_asarray(x64, "bfloat16"))
    s2.set_value(_asarray(x64[::-1].copy(), "bfloat16"))
    assert np.array_equal(bits(s2.get_value()), bits(jax_value(x64[::-1], "bfloat16")))
    # admission depends on the dtype given, as in the JAX package, not on
    # the values: a float32 array is refused even where it holds bfloat16
    # values only
    for refused in (x64.astype(np.float32), f64(_asarray(x64, "bfloat16")).astype(np.float32)):
        with pytest.raises(TypeError, match="bfloat16"):
            s2.set_value(refused)
        with pytest.raises(TypeError, match="bfloat16"):
            jt.vector(dtype="bfloat16").type.filter(refused)
    ptype = pt.vector(dtype="bfloat16").type
    assert np.array_equal(ptype.filter(x64.astype(np.float32), allow_downcast=True),
                          f64(jax_value(x64, "bfloat16")).astype(np.float32))
    assert np.array_equal(ptype.filter(np.arange(-3, 3, dtype=np.int8)), np.arange(-3, 3, dtype=np.float32))
    assert np.array_equal(ptype.filter([0.1, 2.5]), f64(jax_value(np.float64([0.1, 2.5]), "bfloat16")))
    assert np.array_equal(ptype.filter(jax_value(x64, "bfloat16")), f64(jax_value(x64, "bfloat16")))


@LOW
def test_constant_and_cast_in_low_precision(dtype):
    c = pt.constant(0.1, dtype=dtype)
    assert c.type.dtype == dtype
    assert f64(c.data) == f64(jt.constant(0.1, dtype=dtype).data)
    x = pt.vector("x", dtype="float32")
    f = aesara_tpu_torch.function([x], pt.cast(x, dtype) * 3.0)
    xv = np.linspace(-2, 2, 9, dtype=np.float32)
    jx = jt.vector("x", dtype="float32")
    jf = aesara_tpu.function([jx], jt.cast(jx, dtype) * 3.0)
    got, want = f(xv), jf(xv)
    # the float32 literal 3.0 (floatX) widens the product, as in the JAX package
    assert str(got.dtype).split(".")[-1] == want.dtype.name == "float32"
    assert np.array_equal(f64(got), f64(want))
    g = aesara_tpu_torch.function([x], pt.cast(x, dtype) * pt.constant(3.0, dtype=dtype))(xv)
    assert str(g.dtype).split(".")[-1] == dtype
    assert np.array_equal(f64(g), f64(jax_value(f64(jax_value(xv.astype(np.float64), dtype)) * 3.0, dtype)))


def test_values_eq_approx_takes_the_low_precision_tolerances():
    a = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    b = torch.tensor([1.0078125, 2.0], dtype=torch.bfloat16)
    assert values_eq_approx(a, b)
    assert not values_eq_approx(np.float32([1.0, 2.0]), np.float32([1.0078125, 2.0]))
    assert values_eq_approx(a, jax_value(np.float64([1.0, 2.0]), "bfloat16"))


@LOW
def test_model_weights_are_the_jax_package_bits(dtype):
    with aesara_tpu.config.change_flags(floatX=dtype):
        ref = JLayer(64, 4, 128, seed=3)
    with config.change_flags(floatX=dtype):
        port = PLayer(64, 4, 128, seed=3)
    for p, r in zip(port.params, ref.params):
        assert p.type.dtype == dtype
        assert np.array_equal(bits(p.get_value()), bits(r.get_value())), p.name


# -- op graphs ------------------------------------------------------------------


def _graphs(pkg, t, tm, attention):
    x, y = t.tensor3("x"), t.tensor3("y")
    m, w = t.matrix("m"), t.matrix("w")
    return {
        "elemwise": ([x, y], [tm.tanh(x) * y + tm.exp(-tm.sqr(x)) / (1.0 + tm.abs(y))]),
        "sum": ([x], [tm.sum(x, axis=-1), tm.mean(tm.sqr(x)), tm.max(x, axis=1)]),
        "dot": ([m, w], [tm.dot(m, w), tm.dot(m, w) * 0.5 + w[0]]),
        "batched_dot": ([x, y], [tm.batched_dot(x, y.dimshuffle(0, 2, 1))]),
        "attention": ([x, y], [attention(x, y, x + y, causal=True)]),
    }


GRAPHS = ["elemwise", "sum", "dot", "batched_dot", "attention"]
SHAPES = {"elemwise": [(2, 8, 16)] * 2, "sum": [(2, 8, 16)], "dot": [(12, 16), (16, 20)],
          "batched_dot": [(2, 8, 16)] * 2, "attention": [(3, 17, 16)] * 2}


@LOW
@pytest.mark.parametrize("name", GRAPHS)
def test_op_graph_against_the_jax_package(dtype, name):
    rng = np.random.default_rng(7)
    values = [rng.normal(size=s) for s in SHAPES[name]]
    with aesara_tpu.config.change_flags(floatX=dtype):
        ins, outs = _graphs(aesara_tpu, jt, jtm, jattention)[name]
        want = aesara_tpu.function(ins, outs)(*[jax_value(v, dtype) for v in values])
    with config.change_flags(floatX=dtype):
        ins, outs = _graphs(aesara_tpu_torch, pt, ptm, pattention)[name]
        got = aesara_tpu_torch.function(ins, outs)(*[port_value(v, dtype) for v in values])
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == dtype
        assert_close(g, w, REL[dtype], what=name)


# -- the encoder ------------------------------------------------------------------


def _encoder_step(pkg, layer_cls, tm, sgd, out, shared, x64, dtype, n_layers=2):
    layers = [layer_cls(64, 4, 128, seed=i) for i in range(n_layers)]
    x = shared(x64, name="x")
    h = x
    for layer in layers:
        h = layer(h)
    loss = tm.mean(tm.sqr(h))
    params = [p for layer in layers for p in layer.params]
    step = pkg.function([], [out(loss, borrow=True), h], updates=sgd(loss, params, lr=0.01))
    return step, params


def _run_steps(which, dtype, x64, start=None, n_steps=2):
    """(forward of the first call, losses, parameters after n_steps) of the
    2-layer encoder: ``which`` is "jax" or "port"; ``start`` overrides the
    parameters (float64 runs from a low-precision start)."""
    if which == "jax":
        with aesara_tpu.config.change_flags(floatX=dtype):
            step, params = _encoder_step(aesara_tpu, JLayer, jtm, jsgd, JOut, aesara_tpu.shared,
                                         jax_value(x64, dtype), dtype)
    else:
        with config.change_flags(floatX=dtype):
            step, params = _encoder_step(aesara_tpu_torch, PLayer, ptm, psgd, POut, aesara_tpu_torch.shared,
                                         port_value(x64, dtype), dtype)
    if start is not None:
        for p, v in zip(params, start):
            p.set_value(v)
    first = step()
    losses = [f64(first[0])] + [f64(step()[0]) for _ in range(n_steps - 1)]
    return f64(first[1]), losses, [f64(p.get_value()) for p in params]


@LOW
def test_encoder_forward_and_two_sgd_steps(dtype):
    x64 = np.random.default_rng(0).normal(size=(2, 16, 64)) * 0.1
    h_ref, loss_ref, p_ref = _run_steps("jax", dtype, x64)
    h, loss, p = _run_steps("port", dtype, x64)
    # the float64 run of the same two steps from the same low-precision start
    with config.change_flags(floatX=dtype):
        start = [f64(q.get_value()) for q in
                 (q for i in range(2) for q in PLayer(64, 4, 128, seed=i).params)]
    x_start = f64(port_value(x64, dtype))
    _, loss_exact, p_exact = _run_steps("port", "float64", x_start, start=start)
    assert_close(h, h_ref, REL[dtype], what="forward")
    for k in range(2):
        assert abs(loss[k] - loss_ref[k]) <= REL[dtype] * abs(loss_ref[k]), (k, loss, loss_ref)
    for i, (a, r, e) in enumerate(zip(p, p_ref, p_exact)):
        assert_close(a, r, REL[dtype], extra=np.abs(r - e).max(), what=f"parameter {i}")


def _encoder_grads(pkg, layer_cls, tm, grad, x_value, start=None):
    """The loss and the gradient of each parameter of the 2-layer encoder
    (as float64 NumPy); ``start`` overrides the parameters."""
    layers = [layer_cls(64, 4, 128, seed=i) for i in range(2)]
    params = [p for layer in layers for p in layer.params]
    for p, v in zip(params, start or ()):
        p.set_value(v)
    h = pkg.shared(x_value, name="x")
    for layer in layers:
        h = layer(h)
    loss = tm.mean(tm.sqr(h))
    outs = pkg.function([], [loss] + grad(loss, params))()
    return [str(v.dtype).split(".")[-1] for v in outs], [f64(v) for v in outs], ["loss"] + [p.name for p in params]


@contextlib.contextmanager
def jax_flash(dtype):
    """For bfloat16, the JAX package's flash-attention kernels in interpret
    mode, as its TPU runs them from T 1024 on: they round P and dS to
    bfloat16 before their second products, as K2 and K3 (and their plain
    versions) do; float16 has no flash kernel in either package."""
    if dtype != "bfloat16":
        yield
        return
    with aesara_tpu.config.change_flags(flash_attention="on"), pltpu.force_tpu_interpret_mode():
        yield


@LOW
def test_encoder_gradients_against_the_jax_package(dtype):
    x64 = np.random.default_rng(0).normal(size=(2, 16, 64)) * 0.1
    with aesara_tpu.config.change_flags(floatX=dtype), jax_flash(dtype):
        _, want, names = _encoder_grads(aesara_tpu, JLayer, jtm, jgrad, jax_value(x64, dtype))
    with config.change_flags(floatX=dtype):
        dtypes, got, _ = _encoder_grads(aesara_tpu_torch, PLayer, ptm, pgrad, port_value(x64, dtype))
        start = [f64(q.get_value()) for i in range(2) for q in PLayer(64, 4, 128, seed=i).params]
    with config.change_flags(floatX="float64"):
        _, exact, _ = _encoder_grads(aesara_tpu_torch, PLayer, ptm, pgrad, f64(port_value(x64, dtype)), start)
    assert dtypes == [dtype] * len(names)
    for name, g, w, e in zip(names, got, want, exact):
        assert np.abs(w).max() > 0, name
        assert_close(g, w, REL[dtype], extra=np.abs(w - e).max(), what=f"d{name}")


def _scaled_adamw_step(pkg, layer_cls, tm, scaled, adamw, out, x_value):
    layers = [layer_cls(64, 4, 128, seed=i) for i in range(2)]
    x = pkg.shared(x_value, name="x")
    h = x
    for layer in layers:
        h = layer(h)
    loss = tm.mean(tm.sqr(h))
    params = [p for layer in layers for p in layer.params]
    updates = scaled(loss, params, lambda grads: adamw(params, grads, lr=ADAMW_LR, weight_decay=0.01))
    return pkg.function([], out(loss, borrow=True), updates=updates), params, updates


ADAMW_LR = 1e-3


def test_scaled_loss_updates_around_adamw_in_bfloat16():
    """Dynamic loss scaling around AdamW on the bfloat16 encoder: the scale
    and its counter stay 0-d float32 tensors, the moments float32 and the
    parameters bfloat16; after two steps the scale, the counter and the
    losses are the JAX package's, and each parameter is within 2e-2 of its
    scale plus 4 lr of the JAX package's (an AdamW step moves an entry by at
    most lr, so two implementations whose gradient differs in sign at an
    entry whose gradient sums cancel end 2 lr apart a step)."""
    x64 = np.random.default_rng(0).normal(size=(2, 16, 64)) * 0.1
    with aesara_tpu.config.change_flags(floatX="bfloat16"):
        jstep, jparams, jupdates = _scaled_adamw_step(aesara_tpu, JLayer, jtm, jscaled, jadamw, JOut,
                                                      jax_value(x64, "bfloat16"))
        jloss = [f64(jstep()) for _ in range(2)]
    with config.change_flags(floatX="bfloat16"):
        pstep, pparams, pupdates = _scaled_adamw_step(aesara_tpu_torch, PLayer, ptm, pscaled, padamw, POut,
                                                      port_value(x64, "bfloat16"))
        ploss = [f64(pstep()) for _ in range(2)]
    state = {v.name: v for v, _ in pupdates}
    for name in ("loss_scale", "loss_scale_good", "adamw_t"):
        assert state[name].type.dtype == "float32" and state[name].type.ndim == 0, name
        assert state[name].value.device.type == "cpu"
    assert state["wq_m"].type.dtype == "float32"
    jstate = {v.name: v for v, _ in jupdates}
    for name in ("loss_scale", "loss_scale_good", "adamw_t"):
        assert f64(state[name].get_value()) == f64(jstate[name].get_value()), name
    assert f64(state["loss_scale_good"].get_value()) == 2.0
    for a, b in zip(ploss, jloss):
        assert abs(a - b) <= REL["bfloat16"] * abs(b)
    for p, r in zip(pparams, jparams):
        assert p.type.dtype == "bfloat16"
        assert_close(p.get_value(), r.get_value(), REL["bfloat16"], extra=4 * ADAMW_LR * 1.001, what=p.name)


# -- checkpoints ------------------------------------------------------------------


def test_bfloat16_checkpoint_round_trip_across_packages(tmp_path):
    with aesara_tpu.config.change_flags(floatX="bfloat16"):
        ref = JLayer(64, 4, 128, seed=5)
    with config.change_flags(floatX="bfloat16"):
        port = PLayer(64, 4, 128, seed=6)
        other = PLayer(64, 4, 128, seed=7)
    jsave(tmp_path / "jax.npz", ref.params)
    pload(tmp_path / "jax.npz", port.params)
    for p, r in zip(port.params, ref.params):
        assert p.type.dtype == "bfloat16"
        assert np.array_equal(bits(p.get_value()), bits(r.get_value())), p.name
    with np.load(tmp_path / "jax.npz") as archive:
        assert all(archive[k].dtype == np.float32 for k in archive.files)
    psave(tmp_path / "port.npz", other.params)
    with np.load(tmp_path / "port.npz") as archive:
        assert all(archive[k].dtype == np.float32 for k in archive.files)
    jload(tmp_path / "port.npz", ref.params)
    pload(tmp_path / "port.npz", port.params)
    for p, q, r in zip(port.params, other.params, ref.params):
        assert np.array_equal(bits(p.get_value()), bits(q.get_value())), p.name
        assert np.array_equal(bits(r.get_value()), bits(q.get_value())), p.name


# -- the linker's refusal -----------------------------------------------------------


@pytest.mark.parametrize("dtype, flag", [("bfloat16", "allow_bf16_reduced_precision_reduction"),
                                         ("float16", "allow_fp16_reduced_precision_reduction")])
def test_linker_refuses_a_low_precision_dot_while_reduced_sums_are_on(monkeypatch, dtype, flag):
    """On the card a bfloat16 or float16 Dot must sum in fp32: the compile
    for CUDA raises while PyTorch lets cuBLAS sum in reduced precision,
    and a float32 graph compiles (up to the missing card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    matmul = torch.backends.cuda.matmul
    old = getattr(matmul, flag)
    setattr(matmul, flag, True)
    try:
        cuda = aesara_tpu_torch.Mode(TorchLinker(device=torch.device("cuda", 0)))
        x = pt.matrix("x", dtype=dtype)
        with pytest.raises(RuntimeError, match=flag):
            aesara_tpu_torch.function([x], ptm.dot(x, x), mode=cuda)
        y = pt.matrix("y", dtype="float32")
        f = aesara_tpu_torch.function([y], ptm.dot(y, y), mode=cuda)
        assert f.fn.device.type == "cuda"
        setattr(matmul, flag, False)
        aesara_tpu_torch.function([x], ptm.dot(x, x), mode=cuda)
    finally:
        setattr(matmul, flag, old)
