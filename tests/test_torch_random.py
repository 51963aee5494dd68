"""Random streams of the port (``aesara_tpu_torch/tensor/random``, the
lowering ``link/torch/random_dispatch.py`` and the threefry kernel's plain
version ``link/torch/kernels/threefry.py``) against ``jax.random`` and the
JAX package's ``aesara_tpu/tensor/random`` on the CPU, with 64-bit mode on
as the JAX package runs there.

- ``prng_key``, ``fold_in``, ``split`` and the raw 32- and 64-bit bits are
  ``jax.random``'s bit for bit, at seeds 0, 42, 2**31, 2**32 + 5 and -1;
  so is the plain threefry draw (next key, bits, uniform floats), an
  all-ones key too.
- Each ported distribution draws the JAX package's ``RandomStream``
  values in float32 and float64: ``uniform`` and ``bernoulli`` bit for
  bit; the others, whose transforms call ``erfinv``, ``log``, ``log1p``,
  ``tan`` or ``pow`` (XLA's and PyTorch's differ by a few ulps), within 4
  float32 ulps or 1e-6 relative in float32, and 1e-12 relative in float64
  (with 1e-12 of the distribution's scale as the floor where ``loc``
  cancels the draw near 0).
- A compiled function with a default update draws anew each call, the
  JAX package's values and keys call for call; re-seeding and
  ``shared(np.random.default_rng())`` give its keys.
- The random rewrites: the ``FAST_RUN`` op counts of graphs with draws
  are the JAX package's, and each lift of ``random_rewrites_db`` rewrites
  as the JAX package's does and keeps its values.
- A distribution the port does not draw yet raises when compiled, naming
  the ROADMAP item; a draw size computed from data refuses to compile.
"""

import ast

import numpy as np
import pytest
import torch

import jax
import jax.random as jr

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.config import config as jconfig
from aesara_tpu.graph.fg import FunctionGraph as JFG
from aesara_tpu.graph.rewriting.basic import in2out as jin2out
from aesara_tpu.tensor.random import rewriting as jrw
from aesara_tpu.tensor.random.utils import RandomStream as JRS

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.graph.fg import FunctionGraph as PFG
from aesara_tpu_torch.graph.rewriting.basic import in2out as pin2out
from aesara_tpu_torch.link.torch.kernels import threefry
from aesara_tpu_torch.tensor.random import op as rop, rewriting as prw
from aesara_tpu_torch.tensor.random.utils import RandomStream as PRS
from tests.test_torch_rnn import op_counts


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def _x64():
    """The JAX package's CPU runs have 64-bit mode on (its config turns it
    on for the CPU); hold it so here whatever ran before."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


SEEDS = [0, 42, 2**31, 2**32 + 5, -1]
SHAPES = [(1,), (31,), (4, 5), (32000,)]
JAX = dict(pkg=aesara_tpu, at=jat, RS=JRS, cfg=jconfig)
PORT = dict(pkg=aesara_tpu_torch, at=pat, RS=PRS, cfg=config)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# -- keys and bits -------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_are_jax_randoms(seed):
    key = jr.PRNGKey(seed)
    np.testing.assert_array_equal(rop.prng_key(seed), np.asarray(jr.key_data(key)))
    for data in (0, 1, 7, 2**32 - 1):
        np.testing.assert_array_equal(rop.fold_in(rop.prng_key(seed), data),
                                      np.asarray(jr.key_data(jr.fold_in(key, data))))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(rop.split(rop.prng_key(seed), num), np.asarray(jr.key_data(jr.split(key, num))))
    assert rop.prng_key(seed).dtype == np.uint32


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_host_bits_are_jax_randoms(seed, shape):
    key = jr.PRNGKey(seed)
    np.testing.assert_array_equal(rop.random_bits(rop.prng_key(seed), shape, 32), np.asarray(jr.bits(key, shape, "uint32")))
    np.testing.assert_array_equal(rop.random_bits(rop.prng_key(seed), shape, 64), np.asarray(jr.bits(key, shape, "uint64")))


@pytest.mark.parametrize("key", SEEDS + ["ones"], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_the_threefry_plain_version_is_jax_randoms(key, shape):
    """(next key, draw) of one draw: JAX's split at counters 0 and 1, then
    the draw key's bits and uniform floats."""
    data = np.full(2, 0xFFFFFFFF, np.uint32) if key == "ones" else rop.prng_key(key)
    next_key, draw_key = jr.split(jr.wrap_key_data(data))
    t = torch.as_tensor(data)
    before = threefry.threefry_draw.plain_calls
    for mode, want in (("bits32", jr.bits(draw_key, shape, "uint32")), ("bits64", jr.bits(draw_key, shape, "uint64")),
                       ("float32", jr.uniform(draw_key, shape, "float32")),
                       ("float64", jr.uniform(draw_key, shape, "float64"))):
        nk, out = threefry.threefry_draw(t, shape, mode)
        np.testing.assert_array_equal(nk.numpy(), np.asarray(jr.key_data(next_key)))
        got = out.numpy()
        if mode.startswith("bits"):
            got = got.view(np.uint32 if mode == "bits32" else np.uint64)
        assert got.shape == shape
        np.testing.assert_array_equal(got, np.asarray(want))
    assert threefry.threefry_draw.plain_calls == before + 4
    np.testing.assert_array_equal(t.numpy(), data)      # the key is not written


def test_the_threefry_kernel_source_parses_and_refuses_bad_keys():
    ast.parse(threefry.source())
    with pytest.raises(TypeError, match="uint32"):
        threefry.threefry_draw(torch.zeros(2, dtype=torch.int64), (3,), "float32")
    with pytest.raises(ValueError, match="mode"):
        threefry.threefry_draw(torch.as_tensor(rop.prng_key(0)), (3,), "float16")


# -- the distributions -----------------------------------------------------------

#: (method, params, size, scale of the draw): each draw the port computes
DISTS = [("uniform", (-2.0, 3.0), (1000,), 5.0), ("normal", (1.0, 2.0), (1000,), 2.0),
         ("standard_normal", (), (40, 25), 1.0), ("lognormal", (0.1, 0.5), (1000,), 1.0),
         ("halfnormal", (0.5, 1.5), (1000,), 1.5), ("bernoulli", (0.3,), (1000,), 1.0),
         ("exponential", (2.0,), (1000,), 2.0), ("weibull", (1.5,), (1000,), 1.0),
         ("laplace", (0.5, 2.0), (1000,), 2.0), ("logistic", (0.5, 2.0), (1000,), 2.0),
         ("cauchy", (0.5, 2.0), (1000,), 2.0), ("halfcauchy", (0.5, 2.0), (1000,), 2.0),
         ("gumbel", (0.5, 2.0), (1000,), 2.0)]
BITWISE = ("uniform", "bernoulli")


def _assert_draws_close(name, got, want, scale):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if name in BITWISE or want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    elif want.dtype == np.float32:
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        rel = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want.astype(np.float64)), 1e-30)
        assert np.all((ulps <= 4) | (rel <= 1e-6)), (ulps.max(), rel.max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("floatX", ["float32", "float64"])
@pytest.mark.parametrize("name,params,size,scale", DISTS, ids=[d[0] for d in DISTS])
def test_each_distribution_draws_the_jax_packages_values(name, params, size, scale, floatX):
    results = []
    for m in (JAX, PORT):
        with m["cfg"].change_flags(floatX=floatX):
            draw = getattr(m["RS"](seed=42), name)(*params, size=size)
            f = m["pkg"].function([], draw)
            results.append([_host(f()) for _ in range(3)])
    for want, got in zip(*results):
        _assert_draws_close(name, got, want, scale)
    assert not np.array_equal(results[1][0], results[1][1])     # each call draws anew


def test_params_with_a_batch_shape_and_a_float32_bernoulli():
    """A draw shaped by its params, params of mixed dtypes, and bernoulli's
    p in float32 (32-bit bits) and float64 (64-bit bits)."""
    loc = np.linspace(-1, 1, 7)
    results = []
    for m in (JAX, PORT):
        at = m["at"]
        srng = m["RS"](seed=3)
        x = at.vector("x", dtype="float64")
        outs = [srng.normal(x, np.float32(0.5)), srng.uniform(np.float32(-1.0), x + 2.0),
                srng.bernoulli(np.float32(0.25), size=(5, 3)), srng.bernoulli(x * 0 + 0.75)]
        f = m["pkg"].function([x], outs)
        results.append([[_host(v) for v in f(loc)] for _ in range(2)])
    for want_call, got_call in zip(*results):
        for k, (want, got) in enumerate(zip(want_call, got_call)):
            _assert_draws_close("normal" if k == 0 else "uniform", got, want, 1.0)


def test_keys_advance_call_for_call_and_reseed():
    """Three calls of a function with a default update: each the JAX
    package's values and next key; ``seed`` resets every key the stream
    made; ``shared`` of a NumPy generator seeds the JAX package's key."""
    streams, fns, draws = [], [], []
    for m in (JAX, PORT):
        srng = m["RS"](seed=7)
        a = srng.normal(0.0, 1.0, size=(4,))
        b = srng.uniform(size=(3,))
        streams.append(srng)
        fns.append(m["pkg"].function([], [a, b]))
        draws.append((a, b))
    for _ in range(3):
        want, got = ([_host(v) for v in f()] for f in fns)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        for (jr_, _), (pr_, _) in zip(streams[0].state_updates, streams[1].state_updates):
            np.testing.assert_array_equal(pr_.get_value(), np.asarray(jr_.get_value()))
            assert pr_.get_value().dtype == np.uint32
    for srng in streams:
        srng.seed(11)
    for (jr_, _), (pr_, _) in zip(streams[0].state_updates, streams[1].state_updates):
        np.testing.assert_array_equal(pr_.get_value(), np.asarray(jr_.get_value()))
    np.testing.assert_array_equal(_host(fns[1]()[1]), np.asarray(fns[0]()[1]))
    gen = np.random.default_rng(123)
    pk, jk = aesara_tpu_torch.shared(gen), aesara_tpu.shared(gen)
    np.testing.assert_array_equal(pk.get_value(), np.asarray(jk.get_value()))
    assert gen.integers(0, 10) == np.random.default_rng(123).integers(0, 10)     # the caller's did not move


def test_an_unported_distribution_and_a_size_from_data_refuse_to_compile():
    from aesara_tpu_torch.tensor.random import basic as rb

    srng = PRS(seed=1)
    for op, params in ((rb.gamma, (2.0, 1.0)), (rb.integers, (0, 5)), (rb.categorical, (np.full(4, 0.25),))):
        with pytest.raises(NotImplementedError, match="item 9"):
            aesara_tpu_torch.function([], srng.gen(op, *params, size=(3,)))
    n = pat.lscalar("n")
    with pytest.raises(NotImplementedError, match="static"):
        aesara_tpu_torch.function([n], srng.normal(size=(n * 2,)))


# -- the rewrites -------------------------------------------------------------------

def _fast_run_graphs(m):
    at = m["at"]
    srng = m["RS"](seed=5)
    x = at.matrix("x", dtype="float64")
    from importlib import import_module

    shape = import_module(f"{m['pkg'].__name__}.tensor.shape")
    d = srng.normal(0.0, 1.0, size=(3, 4))
    out = shape.specify_shape(d, (3, 4)).T * 2.0 + x + srng.uniform(size=(4, 3)) * srng.bernoulli(0.5, size=(4, 3))
    return m["pkg"].function([x], out), x


def test_fast_run_graphs_with_draws_have_the_jax_packages_op_counts():
    (jf, _), (pf, _) = _fast_run_graphs(JAX), _fast_run_graphs(PORT)
    assert op_counts(pf.maker.fgraph) == op_counts(jf.maker.fgraph)
    x = np.arange(12.0).reshape(4, 3)
    np.testing.assert_allclose(_host(pf(x)), np.asarray(jf(x)), rtol=1e-12, atol=1e-12)


def _lifted(m, rw, build):
    """The graph ``build`` gives, rewritten by ``rw`` alone: (the draws'
    values, the length of each RandomVariable node's size: 0 once a lift
    made it implicit).  The port's dimshuffle lift permutes a constant
    size on the host, so its draw keeps a static shape the JAX package's
    loses; the values are the same."""
    srng = m["RS"](seed=9)
    out = build(m, srng)
    ir = __import__(f"{m['pkg'].__name__}.graph.ir", fromlist=["graph_inputs"])
    ins = [v for v in ir.graph_inputs([out]) if not isinstance(v, ir.Constant)]
    fg = (JFG if m is JAX else PFG)(ins, [out], clone=False)
    (jin2out if m is JAX else pin2out)(rw).rewrite(fg)
    sizes = [n.inputs[1].type.shape for n in fg.toposort() if "rv" in str(n.op)]
    f = m["pkg"].function([], fg.outputs[0])
    return _host(f()), sizes


LIFTS = {
    "size": (lambda m, s: s.normal(np.zeros(3), np.ones(3), size=(3,)), "local_rv_size_lift"),
    "dimshuffle": (lambda m, s: s.normal(0.0, 1.0, size=(3, 4)).T, "local_dimshuffle_rv_lift"),
    "subtensor": (lambda m, s: s.normal(np.arange(5.0), np.ones(5))[1:4], "local_subtensor_rv_lift"),
}


@pytest.mark.parametrize("lift", list(LIFTS))
def test_each_random_lift_rewrites_as_the_jax_packages(lift):
    build, name = LIFTS[lift]
    want, want_sizes = _lifted(JAX, getattr(jrw, name), build)
    got, got_sizes = _lifted(PORT, getattr(prw, name), build)
    assert got_sizes == want_sizes
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert name in [rw.name for rw in prw.random_rewrites_db._names.values()]
