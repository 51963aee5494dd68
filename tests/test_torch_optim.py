"""The optimizers and their helpers (``models/optim.py``) and the training
checkpoint (``models/checkpoint.py``) of the port against the JAX
package's, on the CPU.

Each optimizer or helper runs 3 steps on the 2-layer (64, 4, 128) encoder
of ``test_torch_train.py`` and on the two linear models, from the same
weights; after the 3 steps every parameter and every piece of optimizer
state (moments, counters, loss scale, accumulators, averages) agrees with
the JAX package compiled by ``FAST_RUN.excluding("BlasOpt")`` (and the
port by ``TORCH.excluding("BlasOpt")``) within
atol/rtol 1e-5 (fp32; the two sum in different orders), with one
exception.  Adam, AdamW and the helpers that drive ``adamw_from_grads``
divide each gradient entry by its own running RMS, so an entry whose
gradient sums cancel (its rounding, some 1e-3 of its value where the two
packages sum in different orders) moves the update by a fraction of the
learning rate: on the encoder, at most one entry in a thousand of a
tensor (and at least one) may differ by up to 2 × lr = 2e-3, the change
of sign of one step's update (measured: one of wq's 4,096 entries,
1.3e-4).  Every other entry, and every moment, holds to 1e-5.  A checkpoint
written by either package after 2 steps loads into the other by name, and
one more step on each side agrees at the same tolerance.  What waits for
a later slice (optimizer-state sharding, the bucketing options of ``In``)
raises; ``steps_per_call`` came with the scan slice."""

import numpy as np
import pytest
import torch

import aesara_tpu
from aesara_tpu.compile.mode import get_mode as jget_mode
from aesara_tpu.models import checkpoint as jcheckpoint, optim as joptim
from aesara_tpu.models.linear import LinearRegression as JLinear, LogisticRegression as JLogistic
from aesara_tpu.models.transformer import TransformerEncoderLayer as JLayer
from aesara_tpu.tensor import math as jtm

import aesara_tpu_torch
from aesara_tpu_torch.compile.io import In
from aesara_tpu_torch.config import config
from aesara_tpu_torch.models import checkpoint as pcheckpoint, optim as poptim
from aesara_tpu_torch.models.convert import load_params
from aesara_tpu_torch.models.linear import LinearRegression as PLinear, LogisticRegression as PLogistic
from aesara_tpu_torch.models.transformer import TransformerEncoderLayer as PLayer
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.tensor.type import matrix


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, optim=joptim, ckpt=jcheckpoint, tm=jtm, Layer=JLayer, Linear=JLinear,
           Logistic=JLogistic, mode=lambda: jget_mode("FAST_RUN").excluding("BlasOpt"))
PORT = dict(pkg=aesara_tpu_torch, optim=poptim, ckpt=pcheckpoint, tm=ptm, Layer=PLayer, Linear=PLinear,
            Logistic=PLogistic, mode=lambda: aesara_tpu_torch.get_mode("TORCH").excluding("BlasOpt"))
TOL = dict(atol=1e-5, rtol=1e-5)
RECIPES = ["momentum", "rmsprop", "adam", "adamw", "scaled_loss", "accumulate", "ema"]
#: the recipes that divide each gradient entry by its running RMS (see the docstring)
NORMALISED = {"adam", "adamw", "scaled_loss", "accumulate"}
CANCEL_ATOL, CANCEL_SHARE = 2e-3, 1e-3


def _value(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _model(m, which):
    """(models, parameters, loss) of one model on shared data from seeds."""
    rng = np.random.default_rng(5)
    shared = m["pkg"].shared
    if which == "encoder":
        layers = [m["Layer"](64, 4, 128, seed=i) for i in range(2)]
        h = x = shared(rng.normal(size=(2, 16, 64)).astype("float32"), name="x")
        for layer in layers:
            h = layer(h)
        return layers, [p for layer in layers for p in layer.params], m["tm"].mean(m["tm"].sqr(h))
    x = shared(rng.normal(size=(32, 8)).astype("float32"), name="x")
    if which == "linear":
        model = m["Linear"](8, seed=3)
        y = shared(rng.normal(size=(32,)).astype("float32"), name="y")
    else:
        model = m["Logistic"](8, 3, seed=3)
        y = shared(rng.integers(0, 3, size=32).astype("int64"), name="y")
    return [model], model.params, model.loss(x, y)


def _updates(m, recipe, loss, params, init_scale=2.0 ** 10, backoff_factor=0.5):
    """The updates of one optimizer or helper, as a user writes them."""
    o = m["optim"]
    if recipe == "momentum":
        return o.momentum(loss, params, lr=0.01, mu=0.9)
    if recipe == "rmsprop":
        return o.rmsprop(loss, params, lr=1e-3)
    if recipe == "adam":
        return o.adam(loss, params, lr=1e-3)
    if recipe == "adamw":
        s = m["pkg"].shared(np.asarray(0.0, "float32"), name="s")
        updates = o.adamw(loss, params, lr=o.warmup_cosine(s, 1e-3, 2, 13), weight_decay=0.01, grad_clip=1.0)
        return updates + [(s, s + 1.0)]
    if recipe == "scaled_loss":
        return o.scaled_loss_updates(loss, params, lambda gs: o.adamw_from_grads(params, gs, lr=1e-3),
                                     init_scale=init_scale, growth_interval=2, backoff_factor=backoff_factor)
    if recipe == "accumulate":
        return o.accumulate_gradients(loss, params, lambda gs: o.adamw_from_grads(params, gs, lr=1e-3), every=2)
    updates, _ = o.ema_updates(params, decay=0.9)
    return o.sgd(loss, params, lr=0.01) + updates


def _build(m, which, recipe, **kwargs):
    models, params, loss = _model(m, which)
    updates = _updates(m, recipe, loss, params, **kwargs)
    step = m["pkg"].function([], loss, updates=updates, mode=m["mode"]())
    return models, step, [t for t, _ in updates]


def _same_weights(jmodels, pmodels):
    for jm, pm in zip(jmodels, pmodels):
        load_params(pm, jm.get_values())


def _assert_state_agrees(jstate, pstate, cancelling=False):
    """Every state variable agrees within TOL; with ``cancelling``, a
    parameter's entries whose gradient sums cancel may differ by up to
    CANCEL_ATOL, in at most CANCEL_SHARE of a tensor (and one entry)."""
    assert [t.name for t in jstate] == [t.name for t in pstate]
    for jt, pt in zip(jstate, pstate):
        got, want = pt.get_value(), np.asarray(jt.get_value())
        assert got.dtype == want.dtype and got.shape == want.shape, pt.name
        if not cancelling:
            np.testing.assert_allclose(got, want, err_msg=pt.name, **TOL)
            continue
        off = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
        assert off.sum() <= max(1, CANCEL_SHARE * off.size), (pt.name, int(off.sum()))
        np.testing.assert_allclose(got, want, err_msg=pt.name, atol=CANCEL_ATOL, rtol=0)


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("which", ["encoder", "linear", "logistic"])
def test_optimizer_matches_jax_after_3_steps(which, recipe):
    jmodels, jstep, jstate = _build(JAX, which, recipe)
    pmodels, pstep, pstate = _build(PORT, which, recipe)
    _same_weights(jmodels, pmodels)
    for _ in range(3):
        want, got = float(np.asarray(jstep())), float(pstep())
        np.testing.assert_allclose(got, want, **TOL)
    _assert_state_agrees(jstate, pstate, cancelling=which == "encoder" and recipe in NORMALISED)


@pytest.mark.parametrize("which", ["linear", "logistic"])
def test_scaled_loss_at_a_huge_scale_matches_jax(which):
    # at 3e38 the linear model's scaled gradients overflow: every update is
    # skipped and the scale backs off, far enough that the next steps go
    # through; the classifier's stay finite and its first step is taken
    kwargs = dict(init_scale=3e38, backoff_factor=2.0 ** -100)
    jmodels, jstep, jstate = _build(JAX, which, "scaled_loss", **kwargs)
    pmodels, pstep, pstate = _build(PORT, which, "scaled_loss", **kwargs)
    _same_weights(jmodels, pmodels)
    before = [p.get_value() for p in pmodels[0].params]
    pstep()
    jstep()
    skipped = [np.array_equal(p.get_value(), b) for p, b in zip(pmodels[0].params, before)]
    assert skipped == [which == "linear"] * len(before)
    scale = next(t for t in pstate if t.name == "loss_scale")
    assert float(scale.get_value()) == np.float32(3e38) * np.float32(2.0 ** -100 if which == "linear" else 1.0)
    _assert_state_agrees(jstate, pstate)
    for _ in range(2):
        jstep()
        pstep()
    _assert_state_agrees(jstate, pstate)


def test_clip_by_global_norm_and_warmup_cosine_match_jax():
    rng = np.random.default_rng(8)
    vals = [rng.normal(size=(5, 3)).astype("float32") * 3, rng.normal(size=(4,)).astype("float32")]
    outs = {}
    for name, m in (("jax", JAX), ("port", PORT)):
        gs = [m["pkg"].shared(v, name=f"g{i}") for i, v in enumerate(vals)]
        clipped, norm = m["optim"].clip_by_global_norm(gs, 1.0)
        s = m["pkg"].shared(np.asarray(0.0, "float32"), name="s")
        lr = m["optim"].warmup_cosine(s, 1e-3, 2, 13, lr_min=1e-5)
        f = m["pkg"].function([], clipped + [norm, lr], updates=[(s, s + 1.0)], mode=m["mode"]())
        outs[name] = [[_value(o) for o in f()] for _ in range(15)]
    for want, got in zip(outs["jax"], outs["port"]):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, **TOL)
    lrs = [step[-1] for step in outs["port"]]
    assert lrs[0] == 0.0 and lrs[2] == pytest.approx(1e-3) and lrs[-1] == pytest.approx(1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_carries_weights_and_adamw_state_across(tmp_path, writer):
    built = {"jax": _build(JAX, "encoder", "adamw"), "port": _build(PORT, "encoder", "adamw")}
    if writer == "port":
        _same_weights(built["jax"][0], built["port"][0])   # the port's own init differs
    reader = "port" if writer == "jax" else "jax"
    packages = {"jax": jcheckpoint, "port": pcheckpoint}
    src_models, src_step, src_state = built[writer]
    for _ in range(2):
        src_step()
    params = [p for m in src_models for p in m.params]
    packages[writer].save_checkpoint(tmp_path / "ckpt", params, [(t, None) for t in src_state],
                                     extra={"epoch": np.asarray(7)})
    dst_models, _, dst_state = built[reader]
    dst_params = [p for m in dst_models for p in m.params]
    extra = packages[reader].load_checkpoint(tmp_path / "ckpt", dst_params, [(t, None) for t in dst_state])
    assert int(extra["epoch"]) == 7
    t = next(v for v in dst_state if v.name == "adamw_t")
    assert float(np.asarray(t.get_value())) == 2.0
    want, got = float(np.asarray(built["jax"][1]())), float(built["port"][1]())
    np.testing.assert_allclose(got, want, **TOL)
    _assert_state_agrees(built["jax"][2], built["port"][2], cancelling=True)


def test_checkpoint_refuses_another_state_layout(tmp_path):
    pmodels, _, pstate = _build(PORT, "linear", "adam")
    params = pmodels[0].params
    pcheckpoint.save_checkpoint(tmp_path / "c.npz", params, [(t, None) for t in pstate])
    with pytest.raises(ValueError, match="state entries"):
        pcheckpoint.load_checkpoint(tmp_path / "c.npz", params)
    assert pcheckpoint.load_checkpoint(tmp_path / "c.npz", params, strict=False) == {}


@pytest.mark.parametrize("recipe", ["momentum", "rmsprop", "adam", "adamw"])
def test_optimizer_state_sharding_waits_for_the_parallel_slice(recipe):
    _, params, loss = _model(PORT, "linear")
    with pytest.raises(NotImplementedError, match="parallel slice"):
        getattr(poptim, recipe)(loss, params, state_shard_axis="data", state_shard_size=2)


def test_steps_per_call_and_bucketing_wait_for_their_slices():
    # steps_per_call came with the scan slice: two steps a call, stacked
    x = matrix("x")
    f = aesara_tpu_torch.function([x], ptm.sum(x), steps_per_call=2)
    np.testing.assert_array_equal(f(np.ones((2, 3), "float32")).numpy(), [6.0, 6.0])
    # bucketing came with the decoder's serving slice: the marked axis is
    # padded to the rung (the function's key) and the result cut back
    for kwargs, key in (({"batched": True}, (4, 3)), ({"seq_bucketed": 1}, (3, 4))):
        g = aesara_tpu_torch.function([In(x, **kwargs)], x * 2.0)
        with config.change_flags(shape_buckets="pow2"):
            np.testing.assert_array_equal(g(np.ones((3, 3), "float32")).numpy(), np.full((3, 3), 2.0))
        assert [k[0][0] for k in g.fn._keys] == [key]
