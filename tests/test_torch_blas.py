"""The BLAS ops (``Gemm``, ``Gemv``, ``Ger``, ``Dot22``, ``Dot22Scalar``),
their rewrites (``BlasOpt``) and ``local_sumsqr2dot`` of the port against
the JAX package's, on the CPU and seeded inputs.

Each op's ``perform`` and its lowering (``torch.addmm``, ``addmv``,
``addr``, ``mm``; a coefficient on the host as a number, one on the
device as a tensor multiply) and its gradient hold to the JAX package's
within atol/rtol 1e-5 (float32; float64 at 1e-12).  The port's
``FAST_RUN`` graph has as many of each BLAS op as the JAX package's on
the tested graphs: the fusions of one op each, the 2-layer train step of
``test_torch_train.py`` (Dot22Scalar; its count is compared, not pinned,
since the JAX package's rewrites walk sets in hash order), and the AdamW
clip, whose squares and sums become dots."""

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.models import optim as joptim
from aesara_tpu.models.transformer import TransformerEncoderLayer as JLayer
from aesara_tpu.tensor import blas as jblas, math as jtm

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models import optim as poptim
from aesara_tpu_torch.models.convert import load_params
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as PLayer
from aesara_tpu_torch.tensor import blas as pblas, math as ptm


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, tm=jtm, blas=jblas, optim=joptim, Layer=JLayer, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, tm=ptm, blas=pblas, optim=poptim, Layer=PLayer, mode="TORCH")
BLAS_OPS = ("Gemm", "Gemv", "Ger", "Dot22", "Dot22Scalar")
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "float64": dict(atol=1e-12, rtol=1e-12)}


def _value(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _op_graph(m, which, dtype, coeff):
    """(inputs, output) of one BLAS op applied directly; ``coeff`` "input"
    makes its scalar coefficients inputs of the function (on the device in
    the port), "constant" constants."""
    at, blas = m["at"], m["blas"]
    mat, vec = at.TensorType(dtype, (None, None)), at.TensorType(dtype, (None,))
    if coeff == "input":
        alpha, beta = at.TensorType(dtype, ())("alpha"), at.TensorType(dtype, ())("beta")
        scalars = [alpha, beta]
    else:
        alpha, beta = np.asarray(1.5, dtype=dtype), np.asarray(-0.5, dtype=dtype)
        scalars = []
    if which == "Gemm":
        z, x, y = mat("z"), mat("x"), mat("y")
        return [z, x, y] + scalars, blas.gemm(z, alpha, x, y, beta)
    if which == "Gemv":
        z, A, x = vec("z"), mat("A"), vec("x")
        return [z, A, x] + scalars, blas.gemv(z, alpha, A, x, beta)
    if which == "Ger":
        z, x, y = mat("z"), vec("x"), vec("y")
        return [z, x, y] + scalars[:1], blas.ger(z, alpha, x, y)
    x, y = mat("x"), mat("y")
    if which == "Dot22":
        return [x, y], blas.Dot22()(x, y)
    return [x, y] + scalars[:1], blas.Dot22Scalar()(x, y, alpha if coeff == "input" else
                                                    at.constant(alpha, dtype=dtype))


_SHAPES = {"Gemm": [(4, 5), (4, 3), (3, 5)], "Gemv": [(4,), (4, 3), (3,)], "Ger": [(4, 5), (4,), (5,)],
           "Dot22": [(4, 3), (3, 5)], "Dot22Scalar": [(4, 3), (3, 5)]}


def _values(which, dtype, coeff, rng):
    vals = [rng.normal(size=s).astype(dtype) for s in _SHAPES[which]]
    if coeff == "input":
        vals += [np.asarray(1.5, dtype), np.asarray(-0.5, dtype)][:2 if which in ("Gemm", "Gemv") else 1]
    return vals[:2] if which == "Dot22" else vals


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("which,coeff", [(op, c) for op in BLAS_OPS for c in ("constant", "input")
                                         if op != "Dot22" or c == "constant"])
def test_blas_op_and_its_gradient_match_jax(which, coeff, dtype):
    rng = np.random.default_rng(0)
    vals = _values(which, dtype, coeff, rng)
    wv = rng.normal(size=(4,) if which == "Gemv" else (4, 5)).astype(dtype)
    results = {}
    for name, m in (("jax", JAX), ("port", PORT)):
        ins, out = _op_graph(m, which, dtype, coeff)
        assert type(out.owner.op).__name__ == which
        w = m["at"].TensorType(dtype, (None,) * out.type.ndim)("w")
        cost = m["tm"].sum(out * w)
        grads = m["pkg"].grad(cost, ins)
        f = m["pkg"].function(ins + [w], [out] + grads, mode=m["mode"])
        results[name] = [_value(r) for r in f(*vals, wv)]
    for got, want in zip(results["port"], results["jax"]):
        np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("which", BLAS_OPS)
def test_blas_perform_matches_jax(which):
    rng = np.random.default_rng(1)
    vals = _values(which, "float64", "input", rng)
    outs = []
    for m in (JAX, PORT):
        ins, out = _op_graph(m, which, "float64", "input")
        node = out.owner
        args = {v: val for v, val in zip(ins, vals)}
        inputs = [args[i] if i in args else np.asarray(i.data) for i in node.inputs]
        storage = [[None]]
        node.op.perform(node, inputs, storage)
        outs.append(storage[0][0])
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12, atol=1e-12)


def _fusion_graph(m, which):
    at, tm = m["at"], m["tm"]
    if which == "gemm":             # add(β·z, α·dot)
        z, x, y = at.matrix("z"), at.matrix("x"), at.matrix("y")
        return [z, x, y], 0.5 * z + 2.0 * tm.dot(x, y)
    if which == "gemv":             # dot(A, x) + y
        A, x, y = at.matrix("A"), at.vector("x"), at.vector("y")
        return [A, x, y], tm.dot(A, x) + y
    if which == "ger":              # z + α·outer(x, y)
        z, x, y = at.matrix("z"), at.vector("x"), at.vector("y")
        return [z, x, y], z + 3.0 * m["blas"].outer(x, y)
    x, y = at.matrix("x"), at.matrix("y")     # α·dot, no addend
    return [x, y], 3.0 * tm.dot(x, y)


def _counts(fgraph):
    names = [type(n.op).__name__ for n in fgraph.toposort()]
    return {op: names.count(op) for op in BLAS_OPS + ("Dot",)}


@pytest.mark.parametrize("which,fused", [("gemm", "Gemm"), ("gemv", "Gemv"), ("ger", "Ger"),
                                         ("dot22scalar", "Dot22Scalar")])
def test_blasopt_fuses_as_the_jax_package_does(which, fused):
    rng = np.random.default_rng(2)
    shapes = {"gemm": [(4, 5), (4, 3), (3, 5)], "gemv": [(4, 3), (3,), (4,)], "ger": [(4, 5), (4,), (5,)],
              "dot22scalar": [(4, 3), (3, 5)]}[which]
    vals = [rng.normal(size=s).astype("float32") for s in shapes]
    outs, counts = {}, {}
    for name, m in (("jax", JAX), ("port", PORT)):
        f = m["pkg"].function(*_fusion_graph(m, which), mode=m["mode"])
        outs[name] = _value(f(*vals))
        counts[name] = _counts(f.maker.fgraph)
    assert counts["port"] == counts["jax"]
    assert counts["port"][fused] == 1
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL["float32"])


def test_blasopt_is_excluded_by_tag():
    x, y = pat.matrix("x"), pat.matrix("y")
    f = aesara_tpu_torch.function([x, y], 3.0 * ptm.dot(x, y),
                                  mode=aesara_tpu_torch.get_mode("TORCH").excluding("BlasOpt"))
    assert _counts(f.maker.fgraph)["Dot22Scalar"] == 0 and _counts(f.maker.fgraph)["Dot"] == 1
    back = aesara_tpu_torch.get_mode("TORCH").excluding("BlasOpt").including("BlasOpt")
    assert "BlasOpt" in back.query.exclude and "BlasOpt" in back.query.include


def test_train_step_has_the_jax_packages_blas_counts():
    built = {}
    for name, m in (("jax", JAX), ("port", PORT)):
        layers = [m["Layer"](64, 4, 128, seed=i) for i in range(2)]
        x = m["pkg"].shared(np.random.default_rng(16).normal(size=(2, 16, 64)).astype("float32"), name="x")
        h = x
        for layer in layers:
            h = layer(h)
        loss = m["tm"].mean(m["tm"].sqr(h))
        params = [p for layer in layers for p in layer.params]
        step = m["pkg"].function([], loss, updates=m["optim"].sgd(loss, params, lr=0.01), mode=m["mode"])
        built[name] = (layers, params, step)
    for jl, pl in zip(built["jax"][0], built["port"][0]):
        load_params(pl, jl.get_values())
    counts = {name: _counts(b[2].maker.fgraph) for name, b in built.items()}
    assert counts["port"] == counts["jax"]
    assert counts["port"]["Dot22Scalar"] > 0
    for _ in range(2):
        np.testing.assert_allclose(float(built["port"][2]()), float(np.asarray(built["jax"][2]())),
                                   **TOL["float32"])
    for jp, pp in zip(built["jax"][1], built["port"][1]):
        np.testing.assert_allclose(pp.get_value(), np.asarray(jp.get_value()), err_msg=pp.name,
                                   **TOL["float32"])


def test_sumsqr2dot_takes_the_clip_norms_squares():
    rng = np.random.default_rng(8)
    vals = [rng.normal(size=(5, 3)).astype("float32") * 3, rng.normal(size=(4,)).astype("float32")]
    outs, graphs = {}, {}
    for name, m in (("jax", JAX), ("port", PORT)):
        gs = [m["pkg"].shared(v, name=f"g{i}") for i, v in enumerate(vals)]
        clipped, norm = m["optim"].clip_by_global_norm(gs, 1.0)
        f = m["pkg"].function([], clipped + [norm], mode=m["mode"])
        outs[name] = [_value(o) for o in f()]
        nodes = f.maker.fgraph.toposort()
        graphs[name] = (sum(type(n.op).__name__ == "Dot" for n in nodes),
                        sum(type(n.op).__name__ == "Sum" for n in nodes))
    assert graphs["port"] == graphs["jax"] == (2, 0)
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("axes", [1, 2, [[1], [0]], [[0, 2], [1, 0]]])
def test_batched_tensordot_matches_jax(axes):
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(3, 4, 5, 6)).astype("float32")
    yv = rng.normal(size=(3, 6, 4, 2) if axes == [[0, 2], [1, 0]] else
                    (3, 5, 6, 2) if axes == 2 else (3, 6, 2) if axes == 1 else (3, 5, 2)).astype("float32")
    outs = []
    for m in (JAX, PORT):
        x = m["at"].TensorType("float32", (None,) * 4)("x")
        y = m["at"].TensorType("float32", (None,) * yv.ndim)("y")
        f = m["pkg"].function([x, y], m["blas"].batched_tensordot(x, y, axes), mode=m["mode"])
        outs.append(_value(f(xv, yv)))
    assert outs[1].shape == outs[0].shape
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-4, rtol=1e-5)


#: the port's 2-layer sgd train step with BlasOpt: its Composites and the
#: gradients' scaled products (12, as in the JAX package's FAST_RUN)
N_COMPOSITE_BLAS, N_DOT22SCALAR = 36, 12


def test_blas_train_step_graph_is_the_same_under_any_hash_seed():
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
            "f = ptp.function([], loss, updates=sgd(loss, [p for l in ls for p in l.params]))\n"
            "nodes = f.maker.fgraph.toposort()\n"
            "print(sorted(str(n.op) for n in nodes))\n"
            "print(sum(type(getattr(n.op, 'scalar_op', None)).__name__ == 'Composite' for n in nodes),\n"
            "      sum(type(n.op).__name__ == 'Dot22Scalar' for n in nodes))\n")
    outs = set()
    for seed in ("0", "1"):
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                             env={**os.environ, "PYTHONHASHSEED": seed}, check=True)
        outs.add(res.stdout)
    assert len(outs) == 1
    assert outs.pop().split()[-2:] == [str(N_COMPOSITE_BLAS), str(N_DOT22SCALAR)]
