"""Convolution, pooling, ``images2neibs``, batch normalization, the nnet
graph functions and the ``ConvNet`` model of the port against the JAX
package, on the CPU, from the same seeded numpy inputs.

Each op is compiled in a graph of each package (``FAST_RUN`` and
``TORCH``) with its gradients, so the lowerings and the gradient ops run
as a model runs them.  float64 values agree within 1e-10; the
``ConvNet(1, (12, 12), [4, 8], 10)`` in float32, its weights carried by
``models/convert.py``, within 1e-5 after 3 sgd steps, with the same
``predict`` and the JAX package's ``FAST_RUN`` op counts.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import aesara_tpu
import aesara_tpu.tensor as jat
import aesara_tpu.tensor.nnet as jnn
from aesara_tpu.models import ConvNet as JConvNet, sgd as jsgd
from aesara_tpu.tensor.nnet.abstract_conv import conv3d as jconv3d
from aesara_tpu.tensor.nnet.neighbours import images2neibs as jimages2neibs

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
import aesara_tpu_torch.tensor.nnet as pnn
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models import ConvNet as PConvNet, load_params, sgd as psgd


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, nn=jnn, conv3d=jconv3d, images2neibs=jimages2neibs, ConvNet=JConvNet, sgd=jsgd,
           mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, nn=pnn, conv3d=pnn.conv3d, images2neibs=pnn.images2neibs,
            ConvNet=PConvNet, sgd=psgd, mode="TORCH")
TOL = dict(atol=1e-10, rtol=1e-10)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _outputs(res):
    return [_host(v) for v in (res if isinstance(res, (list, tuple)) else [res])]


def _compare(build, args, tol=TOL):
    """``build(m)`` -> a function of each package; both called on ``args``
    give the same outputs (same shapes and dtypes)."""
    want, got = [_outputs(build(m)(*args)) for m in (JAX, PORT)]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape and w.dtype == g.dtype, (w.shape, w.dtype, g.shape, g.dtype)
        np.testing.assert_allclose(g, w, **tol)
    return got


def op_counts(fn) -> Counter:
    """{op name: count} of a compiled graph, a Composite named by the
    sorted scalar ops it fuses."""
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
    return counts


# -- conv2d ----------------------------------------------------------------------------------

CONV_CASES = [
    # border_mode, kernel hw, subsample, filter_dilation, num_groups, filter_flip
    ("valid", (3, 3), (1, 1), (1, 1), 1, True),
    ("full", (3, 2), (1, 1), (1, 1), 1, True),
    ("half", (3, 3), (1, 1), (1, 1), 1, True),
    ("half", (2, 4), (1, 1), (1, 1), 1, True),         # even kernels under "half"
    (1, (3, 3), (2, 2), (1, 1), 1, True),
    ((2, 1), (3, 3), (1, 2), (1, 1), 1, False),
    (((1, 2), (0, 1)), (3, 3), (1, 1), (1, 1), 1, True),   # asymmetric pairs
    (((2, 0), 1), (2, 3), (2, 1), (1, 1), 1, True),
    ("valid", (3, 3), (1, 1), (2, 1), 1, True),          # dilation
    ("half", (3, 3), (1, 1), (1, 2), 2, True),           # groups and dilation
    ("valid", (2, 2), (2, 2), (1, 1), 2, False),
    ("full", (3, 3), (2, 1), (2, 2), 1, False),
]


@pytest.mark.parametrize("border_mode, khw, subsample, dilation, groups, flip", CONV_CASES)
def test_conv2d_and_both_gradients_match_jax(border_mode, khw, subsample, dilation, groups, flip):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 4, 9, 8))
    kern = rng.normal(size=(6, 4 // groups) + khw)

    def build(m):
        at, pkg = m["at"], m["pkg"]
        x, w = at.dtensor4("x"), at.dtensor4("w")
        out = m["nn"].conv2d(x, w, border_mode=border_mode, subsample=subsample, filter_flip=flip,
                             filter_dilation=dilation, num_groups=groups)
        cost = at.sum(at.sqr(out) * 0.5 + out)
        return pkg.function([x, w], [out] + pkg.grad(cost, [x, w]), mode=m["mode"])

    out = _compare(build, (img, kern))
    assert out[1].shape == img.shape and out[2].shape == kern.shape


def test_conv2d_transpose_matches_jax():
    rng = np.random.default_rng(2)
    x, w = rng.normal(size=(2, 3, 4, 5)), rng.normal(size=(3, 2, 3, 3))

    def build(m):
        at = m["at"]
        xv, wv = at.dtensor4("x"), at.dtensor4("w")
        out = m["nn"].conv2d_transpose(xv, wv, output_shape=(2, 2, 9, 11), border_mode="valid",
                                       input_dilation=(2, 2))
        return m["pkg"].function([xv, wv], out, mode=m["mode"])

    (out,) = _compare(build, (x, w))
    assert out.shape == (2, 2, 9, 11)


@pytest.mark.parametrize("border_mode, subsample", [("valid", (1, 1, 1)), ("half", (1, 2, 1)), ((1, 0, 2), (2, 1, 1))])
def test_conv3d_and_its_gradients_match_jax(border_mode, subsample):
    rng = np.random.default_rng(3)
    img, kern = rng.normal(size=(2, 2, 5, 6, 4)), rng.normal(size=(3, 2, 3, 2, 3))

    def build(m):
        at, pkg = m["at"], m["pkg"]
        x, w = at.TensorType("float64", (None,) * 5)("x"), at.TensorType("float64", (None,) * 5)("w")
        out = m["conv3d"](x, w, border_mode=border_mode, subsample=subsample)
        return pkg.function([x, w], [out] + pkg.grad(at.sum(at.tanh(out)), [x, w]), mode=m["mode"])

    _compare(build, (img, kern))


# -- pooling ---------------------------------------------------------------------------------

POOL_CASES = [
    # ws, stride, pad, ignore_border, input shape
    ((2, 2), None, (0, 0), True, (2, 3, 7, 6)),
    ((2, 2), None, (0, 0), False, (2, 3, 7, 6)),
    ((3, 2), (1, 1), (1, 1), True, (2, 2, 6, 5)),
    ((3, 3), (2, 1), (0, 0), False, (1, 2, 7, 8)),
    ((2, 3), (2, 3), (1, 0), True, (3, 5, 7)),
    ((3, 3), None, (0, 0), False, (1, 1, 2, 2)),       # an input shorter than the window
]


@pytest.mark.parametrize("mode", ["max", "sum", "average_inc_pad", "average_exc_pad"])
@pytest.mark.parametrize("ws, stride, pad, ignore_border, shape", POOL_CASES)
def test_pool_and_its_gradient_match_jax(mode, ws, stride, pad, ignore_border, shape):
    """Every mode, ignore_border both ways, padding and strides; half the
    values rounded, so windows hold ties."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=shape)
    x[..., ::2, :] = np.round(x[..., ::2, :])

    def build(m):
        at, pkg = m["at"], m["pkg"]
        xv = at.TensorType("float64", (None,) * len(shape))("x")
        out = m["nn"].pool_2d(xv, ws=ws, ignore_border=ignore_border, stride=stride, pad=pad, mode=mode)
        cost = at.sum(at.sqr(out) + out * 0.5)
        return pkg.function([xv], [out, pkg.grad(cost, xv)], mode=m["mode"])

    _compare(build, (x,))


@pytest.mark.parametrize("values", ["relu", "nan"])
def test_max_pool_gradient_among_ties_and_nan_goes_where_jax_puts_it(values):
    """After ReLU whole windows are zeros: the gradient goes to the
    position the JAX package's vjp picks, here the PoolGrad itself with a
    cotangent that tells positions apart; NaN is handled alike."""
    rng = np.random.default_rng(5)
    x = np.maximum(rng.normal(size=(2, 3, 8, 8)), 0.0)
    if values == "nan":
        x = np.round(rng.normal(size=(2, 3, 8, 8)))
        x[rng.random(x.shape) < 0.15] = np.nan
    gz = rng.normal(size=(2, 3, 4, 4))

    def build(m):
        at, pkg = m["at"], m["pkg"]
        xv, gv = at.dtensor4("x"), at.dtensor4("gz")
        out = m["nn"].pool_2d(xv, ws=(2, 2), ignore_border=True, mode="max")
        grad_op = type(out.owner.op.L_op([xv], [out], [gv])[0].owner.op)
        assert grad_op.__name__ == "PoolGrad"
        return pkg.function([xv, gv], [out, pkg.grad(None, xv, known_grads={out: gv})], mode=m["mode"])

    _compare(build, (x, gz))
    for stride, pad in (((1, 1), (1, 1)), ((1, 2), (1, 0))):
        def padded(m):
            at, pkg = m["at"], m["pkg"]
            xv, gv = at.dtensor4("x"), at.dtensor4("gz")
            out = m["nn"].pool_2d(xv, ws=(3, 3), ignore_border=True, stride=stride, pad=pad, mode="max")
            return pkg.function([xv, gv], pkg.grad(None, xv, known_grads={out: gv}), on_unused_input="ignore",
                                mode=m["mode"])

        out_hw = [(8 + 2 * p - 3) // st + 1 for p, st in zip(pad, stride)]
        _compare(padded, (x, rng.normal(size=(2, 3, *out_hw))))


@pytest.mark.parametrize("dtype, mode", [("int64", "max"), ("int32", "sum"), ("int64", "sum"), ("int8", "sum")])
@pytest.mark.parametrize("ignore_border", [True, False])
def test_pool_on_integers_matches_jax(dtype, mode, ignore_border):
    rng = np.random.default_rng(6)
    x = rng.integers(-50, 50, size=(2, 3, 7, 6)).astype(dtype)

    def build(m):
        at = m["at"]
        xv = at.TensorType(dtype, (None,) * 4)("x")
        out = m["nn"].pool_2d(xv, ws=(3, 2), ignore_border=ignore_border, stride=(2, 2), mode=mode)
        return m["pkg"].function([xv], out, mode=m["mode"])

    _compare(build, (x,))


def test_pool_legacy_keywords_and_max_pool_2d():
    x = np.random.default_rng(7).normal(size=(2, 2, 6, 6))

    def build(m):
        at, nn = m["at"], m["nn"]
        xv = at.dtensor4("x")
        return m["pkg"].function([xv], [nn.pool_2d(xv, ds=(2, 3), st=(1, 2), padding=(1, 1), mode="sum"),
                                        nn.max_pool_2d(xv, (3, 3), ignore_border=False)], mode=m["mode"])

    _compare(build, (x,))


# -- images2neibs, batchnorm ---------------------------------------------------------------------


@pytest.mark.parametrize("mode, shape, step", [("valid", (2, 2), None), ("valid", (3, 2), (1, 2)),
                                               ("ignore_borders", (3, 3), (2, 2))])
def test_images2neibs_matches_jax(mode, shape, step):
    x = np.random.default_rng(8).normal(size=(2, 3, 7, 8)) if mode != "valid" or shape == (3, 2) \
        else np.random.default_rng(8).normal(size=(2, 3, 6, 8))

    def build(m):
        at = m["at"]
        xv = at.dtensor4("x")
        out = m["images2neibs"](xv, shape, step, mode=mode)
        return m["pkg"].function([xv], out, mode=m["mode"])

    _compare(build, (x,))


def test_images2neibs_valid_refuses_an_inexact_tiling():
    xv = pat.dtensor4("x")
    f = aesara_tpu_torch.function([xv], pnn.images2neibs(xv, (2, 2)))
    with pytest.raises(ValueError, match="tile exactly"):
        f(np.zeros((1, 1, 5, 4)))


@pytest.mark.parametrize("axes", ["spatial", "per-activation", (0, 2)])
def test_batch_normalization_train_and_test_match_jax(axes):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 3, 5, 2)) * 2 + 1
    shape = {"spatial": (1, 3, 1, 1), "per-activation": (1, 3, 5, 2), (0, 2): (1, 3, 1, 2)}[axes]
    gamma, beta = rng.normal(size=shape), rng.normal(size=shape)
    mean, var = rng.normal(size=shape), rng.random(size=shape) + 0.5

    def build(m):
        at, nn, pkg = m["at"], m["nn"], m["pkg"]
        xv = at.dtensor4("x")
        param = at.TensorType("float64", tuple(1 if n == 1 else None for n in shape))
        g, b, rm, rv = (param(n) for n in ("g", "b", "rm", "rv"))
        out, mu, invstd, new_m, new_v = nn.batch_normalization_train(xv, g, b, axes=axes, running_mean=rm,
                                                                     running_var=rv)
        test = nn.batch_normalization_test(xv, g, b, rm, rv, axes=axes)
        plain = nn.batch_normalization(xv, g, b, rm, at.sqrt(rv))
        grads = pkg.grad(at.sum(at.sqr(out)), [xv, g, b])
        return pkg.function([xv, g, b, rm, rv], [out, mu, invstd, new_m, new_v, test, plain] + grads,
                            mode=m["mode"])

    _compare(build, (x, gamma, beta, mean, var))


# -- the nnet graph functions -----------------------------------------------------------------------

ACTIVATIONS = ["relu", "relu_leaky", "elu", "selu", "softplus", "softsign", "hard_sigmoid", "sigmoid",
               "ultra_fast_sigmoid"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activations_and_their_gradients_match_jax(name):
    x = np.random.default_rng(10).normal(size=(5, 7)) * 3

    def build(m):
        at, nn, pkg = m["at"], m["nn"], m["pkg"]
        xv = at.dmatrix("x")
        out = nn.relu(xv, alpha=0.1) if name == "relu_leaky" else getattr(nn, name)(xv)
        return pkg.function([xv], [out, pkg.grad(at.sum(out * xv), xv)], mode=m["mode"])

    _compare(build, (x,))


@pytest.mark.parametrize("name", ["binary", "sigmoid_binary", "categorical_dense", "categorical_index",
                                  "softmax_1hot", "argmax_1hot", "max_and_argmax", "dx", "categorical_grad",
                                  "softmax_with_bias", "logsoftmax", "softmax_legacy", "softmax_grad_legacy"])
def test_crossentropy_family_matches_jax(name):
    rng = np.random.default_rng(11)
    x, b = rng.normal(size=(6, 5)), rng.normal(size=5)
    p = 1 / (1 + np.exp(-x))
    t = (rng.random((6, 5)) > 0.5).astype("float64")
    y = rng.integers(0, 5, size=6).astype("int64")
    dy = rng.normal(size=6)
    sm = np.exp(x) / np.exp(x).sum(1, keepdims=True)

    def build(m):
        at, nn, pkg = m["at"], m["nn"], m["pkg"]
        xv, bv, pv, tv, yv, dyv, smv = (at.dmatrix("x"), at.dvector("b"), at.dmatrix("p"), at.dmatrix("t"),
                                        at.lvector("y"), at.dvector("dy"), at.dmatrix("sm"))
        outs = {
            "binary": lambda: [nn.binary_crossentropy(pv, tv)],
            "sigmoid_binary": lambda: [nn.sigmoid_binary_crossentropy(xv, tv)],
            "categorical_dense": lambda: [nn.categorical_crossentropy(pv, tv)],
            "categorical_index": lambda: [nn.categorical_crossentropy(smv, yv)],
            "softmax_1hot": lambda: list(nn.crossentropy_softmax_1hot(xv, yv)),
            "argmax_1hot": lambda: list(nn.crossentropy_softmax_argmax_1hot_with_bias(xv, bv, yv)),
            "max_and_argmax": lambda: list(nn.crossentropy_softmax_max_and_argmax_1hot(xv, yv)),
            "dx": lambda: [nn.crossentropy_softmax_1hot_with_bias_dx(dyv, smv, yv)],
            "categorical_grad": lambda: [nn.crossentropy_categorical_1hot_grad(dyv, smv, yv)],
            "softmax_with_bias": lambda: [nn.softmax_with_bias(xv, bv)],
            "logsoftmax": lambda: [nn.logsoftmax(xv)],
            "softmax_legacy": lambda: [nn.softmax_legacy(xv)],
            "softmax_grad_legacy": lambda: [nn.softmax_grad_legacy(pv, smv)],
        }[name]()
        if outs[0].type.dtype.startswith("float") and name not in ("dx", "categorical_grad", "softmax_grad_legacy"):
            outs.append(pkg.grad(at.sum(outs[0]), xv if name in ("sigmoid_binary", "softmax_1hot", "argmax_1hot",
                                                                  "max_and_argmax", "softmax_with_bias",
                                                                  "logsoftmax", "softmax_legacy") else
                                 (pv if name in ("binary", "categorical_dense") else smv)))
        return pkg.function([xv, bv, pv, tv, yv, dyv, smv], outs, on_unused_input="ignore", mode=m["mode"])

    _compare(build, (x, b, p, t, y, dy, sm))


def test_prepend_helpers_match_jax():
    x = np.random.default_rng(12).normal(size=(3, 4))

    def build(m):
        at, nn = m["at"], m["nn"]
        xv = at.dmatrix("x")
        return m["pkg"].function([xv], [nn.prepend_0_to_each_row(xv), nn.prepend_1_to_each_row(xv),
                                        nn.prepend_scalar_to_each_row(2.5, xv)], mode=m["mode"])

    _compare(build, (x,))


@pytest.mark.parametrize("with_target", [False, True])
def test_h_softmax_matches_jax(with_target):
    rng = np.random.default_rng(13)
    B, D, n_classes, per_class = 4, 6, 3, 4
    args = (rng.normal(size=(B, D)), rng.normal(size=(D, n_classes)), rng.normal(size=n_classes),
            rng.normal(size=(D, n_classes, per_class)), rng.normal(size=(n_classes, per_class)),
            rng.integers(0, n_classes * per_class - 1, size=B).astype("int64"))

    def build(m):
        at, nn, pkg = m["at"], m["nn"], m["pkg"]
        x, W1, b1, W2, b2, target = (at.dmatrix("x"), at.dmatrix("W1"), at.dvector("b1"), at.dtensor3("W2"),
                                     at.dmatrix("b2"), at.lvector("target"))
        out = nn.h_softmax(x, B, n_classes * per_class - 1, n_classes, per_class, W1, b1, W2, b2,
                           target if with_target else None)
        return pkg.function([x, W1, b1, W2, b2, target], [out, pkg.grad(at.sum(at.log(out)), x)],
                            on_unused_input="ignore", mode=m["mode"])

    _compare(build, args)


def test_confusion_matrix_matches_the_jax_package():
    """The label set is data-dependent: the JAX package's XLA linker
    refuses it and its PY linker runs it; the port runs it (eagerly)."""
    rng = np.random.default_rng(14)
    actual, pred = rng.integers(0, 5, size=20), rng.integers(1, 6, size=20)
    want = []
    for m, mode in ((JAX, "PY"), (PORT, "TORCH")):
        at = m["at"]
        a, p = at.lvector("a"), at.lvector("p")
        want.append(_outputs(m["pkg"].function([a, p], m["nn"].confusion_matrix(a, p), mode=mode)(actual, pred)))
    for w, g in zip(*want):
        np.testing.assert_array_equal(g, w)
    assert want[1][0].sum() == 20


# -- ConvNet ----------------------------------------------------------------------------------------


def _convnet(m):
    at, pkg = m["at"], m["pkg"]
    model = m["ConvNet"](1, (12, 12), [4, 8], 10, seed=0)
    x, y = at.tensor4("x", dtype="float32"), at.lvector("y")
    loss = model.loss(x, y)
    grads = pkg.grad(loss, model.params)
    return dict(model=model, grads=pkg.function([x, y], [loss] + grads, mode=m["mode"]),
                step=pkg.function([x, y], loss, updates=m["sgd"](loss, model.params, lr=0.1), mode=m["mode"]),
                predict=pkg.function([x], model.predict(x), mode=m["mode"]))


def test_convnet_trains_and_predicts_like_jax():
    """Loss and every gradient, then 3 sgd steps (loss and every parameter
    after each) and ``predict``, float32 within 1e-5; the parameters are
    carried by name (``f0``, ``f1``, ``w_out``, ``b_out``)."""
    rng = np.random.default_rng(15)
    x = rng.normal(size=(6, 1, 12, 12)).astype("float32")
    y = rng.integers(0, 10, size=6).astype("int64")
    ref, port = _convnet(JAX), _convnet(PORT)
    assert [p.name for p in port["model"].params] == ["f0", "f1", "w_out", "b_out"]
    load_params(port["model"], {p.name: p.get_value() for p in ref["model"].params})
    tol = dict(atol=1e-5, rtol=1e-5)
    for w, g in zip(_outputs(ref["grads"](x, y)), _outputs(port["grads"](x, y))):
        np.testing.assert_allclose(g, w, **tol)
    losses = []
    for _ in range(3):
        lw, lg = float(_host(ref["step"](x, y))), float(_host(port["step"](x, y)))
        np.testing.assert_allclose(lg, lw, **tol)
        for p, q in zip(ref["model"].params, port["model"].params):
            np.testing.assert_allclose(_host(q.get_value()), p.get_value(), **tol)
        losses.append(lg)
    assert losses[-1] < losses[0]
    np.testing.assert_array_equal(_host(port["predict"](x)), _host(ref["predict"](x)))


def test_convnet_fast_run_graph_has_the_jax_packages_op_counts():
    ref, port = _convnet(JAX), _convnet(PORT)
    for key in ("grads", "step", "predict"):
        assert op_counts(port[key]) == op_counts(ref[key]), key
    counts = op_counts(port["step"])
    assert (counts["AbstractConv2d"], counts["AbstractConv2dGradWeights"], counts["AbstractConv2dGradInputs"],
            counts["Pool"], counts["PoolGrad"]) == (2, 2, 1, 2, 2)
