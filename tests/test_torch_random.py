"""Random streams of the port (``aesara_tpu_torch/tensor/random``, the
lowering ``link/torch/random_dispatch.py`` and the threefry kernel's plain
version ``link/torch/kernels/threefry.py``) against ``jax.random`` and the
JAX package's ``aesara_tpu/tensor/random`` on the CPU, with 64-bit mode on
as the JAX package runs there.

- ``prng_key``, ``fold_in``, ``split`` and the raw 32- and 64-bit bits are
  ``jax.random``'s bit for bit, at seeds 0, 42, 2**31, 2**32 + 5 and -1;
  so is the plain threefry draw (next key, bits, uniform floats), an
  all-ones key too.
- Every distribution of the JAX package draws its ``RandomStream`` values
  in float32 and float64, at parameters that reach each branch of the loop
  samplers: ``uniform``, ``bernoulli`` and every integer draw bit for bit;
  the others, whose transforms call ``erfinv``, ``log``, ``log1p``,
  ``tan`` or ``pow`` (XLA's and PyTorch's differ by a few ulps), within 4
  float32 ulps or 1e-6 relative in float32, and 1e-12 relative in float64
  (with 1e-12 of the distribution's scale as the floor where ``loc``
  cancels the draw near 0).  Poisson at λ = 1e4 is the one exception,
  counted (see its test).
- The loop samplers' plain versions (TG, TP, TB of
  ``link/torch/kernels/random_loops.py``) against ``jax.random``'s gamma,
  loggamma, Poisson and binomial directly, float32 gamma too, and the
  rejection loops' rule that an element keeps its k of the batch's last
  accepting round.
- A compiled function with a default update draws anew each call, the
  JAX package's values and keys call for call; re-seeding and
  ``shared(np.random.default_rng())`` give its keys.
- The random rewrites: the ``FAST_RUN`` op counts of graphs with draws
  are the JAX package's, and each lift of ``random_rewrites_db`` rewrites
  as the JAX package's does and keeps its values.
- A ``RandomVariable`` with no draw raises when compiled; a draw size
  computed from data refuses to compile.
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


@pytest.mark.parametrize("seed", [0, 42, -1])
def test_the_threefry_draw_without_its_split_is_jax_randoms_of_the_key_itself(seed):
    """``split=False``: the keys of ``jax.random.split(key, n)`` (the
    ``keys`` mode) and the bits and uniforms of the key itself, no next key."""
    data = rop.prng_key(seed)
    jkey, t = jr.wrap_key_data(data), torch.as_tensor(data)
    nk, keys = threefry.threefry_draw(t, (5,), threefry.KEYS, split=False)
    assert nk is None and keys.dtype == torch.uint32 and keys.shape == (5, 2)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jr.key_data(jr.split(jkey, 5))))
    for mode, want in (("bits32", jr.bits(jkey, (33,), "uint32")), ("bits64", jr.bits(jkey, (33,), "uint64")),
                       ("float32", jr.uniform(jkey, (33,), "float32")), ("float64", jr.uniform(jkey, (33,), "float64"))):
        got = threefry.threefry_draw(t, (33,), mode, split=False)[1].numpy()
        if mode.startswith("bits"):
            got = got.view(np.uint32 if mode == "bits32" else np.uint64)
        np.testing.assert_array_equal(got, np.asarray(want))


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
         ("gumbel", (0.5, 2.0), (1000,), 2.0),
         # the draws from a key, at parameters that reach each branch: gamma's
         # boosted (alpha < 1) and plain loops, Poisson's Knuth and rejection
         # (lambda 0, under and at 10), binomial's inversion, BTRS and
         # reflection (p > 0.5)
         ("gamma", (np.array([0.05, 0.7, 1.0, 3.5, 250.0]), 2.0), (200, 5), 1.0),
         ("beta", (np.array([0.05, 3.0]), np.array([2.5, 0.7])), (300, 2), 1.0),
         ("chisquare", (np.array([0.1, 3.0]),), (300, 2), 1.0), ("t", (4.0, 0.5, 2.0), (500,), 2.0),
         ("pareto", (2.0,), (500,), 1.0), ("geometric", (0.3,), (500,), 1.0),
         ("truncated_normal", (-1.0, 2.0), (500,), 1.0),
         ("vonmises", (0.5, np.array([2.0, 0.001])), (300, 2), 1.0),
         ("integers", (-3, 17), (500,), 1.0), ("randint", (0, 2**40), (500,), 1.0),
         ("integers_wide", (-2**62, 2**62), (500,), 1.0),
         ("poisson", (np.array([0.0, 0.5, 9.99, 10.0, 37.0]),), (200, 5), 1.0),
         ("binomial", (np.array([5, 40, 1000, 1e6, 30]), np.array([0.3, 0.2, 0.5, 0.01, 0.9])), (200, 5), 1.0),
         ("categorical", (np.array([0.1, 0.2, 0.3, 0.4]),), (500,), 1.0),
         ("choice", (np.arange(10) * 3,), (500,), 1.0), ("choice_scalar", (7,), (500,), 1.0),
         ("choice_p", (np.arange(4) * 5, np.array([0.1, 0.2, 0.3, 0.4])), (500,), 1.0),
         ("choice_noreplace", (np.arange(20) * 2,), (6,), 1.0),
         ("choice_noreplace_p", (np.arange(8), np.linspace(0.05, 0.2, 8)), (5,), 1.0),
         ("permutation", (np.arange(50),), None, 1.0),
         ("dirichlet", (np.array([0.05, 1.0, 3.0]),), (300,), 1.0),
         ("multivariate_normal", (np.array([1.0, -1.0]), np.array([[2.0, 0.3], [0.3, 0.5]])), (300,), 2.0),
         ("multinomial", (20, np.array([0.2, 0.3, 0.5])), (300,), 1.0),
         ("rayleigh", (2.0,), (500,), 2.0), ("invgamma", (3.0, 2.0), (500,), 1.0),
         ("wald", (1.5, 2.0), (500,), 1.5), ("triangular", (-1.0, 0.5, 2.0), (500,), 2.0),
         ("truncexpon", (2.0, 0.5, 1.5), (500,), 2.0), ("power", (2.5,), (500,), 1.0),
         ("f", (3.0, 5.0), (500,), 1.0), ("gengamma", (2.0, 1.5, 0.7), (500,), 1.0),
         ("nbinom", (5.0, 0.3), (500,), 1.0), ("betabinom", (20, 2.0, 3.0), (500,), 1.0),
         ("zipf", (2.5,), (500,), 1.0), ("hypergeometric", (10, 5, 4), (500,), 1.0)]
BITWISE = ("uniform", "bernoulli")


def _draw(m, name, params, size):
    """The stream's draw ``name`` (a test id: a method, or ``gen`` of an op
    the JAX package's stream has no method for, or a method with options)."""
    from importlib import import_module

    srng = m["RS"](seed=42)
    rb = import_module(f"{m['pkg'].__name__}.tensor.random.basic")
    if name in ("zipf", "hypergeometric"):
        return srng.gen(getattr(rb, name), *params, size=size)
    if name.startswith("choice_noreplace"):
        return srng.choice(*params[:1], size=size, replace=False, p=params[1] if len(params) > 1 else None)
    if name.startswith("choice_p"):
        return srng.choice(params[0], size=size, p=params[1])
    return getattr(srng, {"integers_wide": "integers", "choice_scalar": "choice"}.get(name, name))(*params, size=size)


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
            f = m["pkg"].function([], _draw(m, name, params, size))
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


class _NoDraw(rop.RandomVariable):
    """A distribution with neither ``sample`` nor ``sample_key``."""

    def __init__(self, name, ndims_params, dtype):
        super().__init__(name, 0, ndims_params, dtype)


def test_an_unported_distribution_and_a_size_from_data_refuse_to_compile():
    srng = PRS(seed=1)
    for op, params in ((_NoDraw("nodraw_gamma", (0, 0), "floatX"), (2.0, 1.0)),
                       (_NoDraw("nodraw_integers", (0, 0), "int64"), (0, 5)),
                       (_NoDraw("nodraw_categorical", (1,), "int64"), (np.full(4, 0.25),))):
        assert not op.ported
        with pytest.raises(NotImplementedError, match="no draw"):
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


# -- the loop samplers' plain versions against jax.random ---------------------------

from aesara_tpu_torch.link.torch.kernels import random_loops as rl  # noqa: E402

LOOP_KEY = np.asarray([12, 345], np.uint32)


def _jkey():
    return jr.wrap_key_data(jax.numpy.asarray(LOOP_KEY))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("log_space", [False, True], ids=["gamma", "loggamma"])
def test_tg_plain_version_is_jax_randoms_gamma(dtype, log_space):
    """TG's plain version: element i from split(key, n)[i], Marsaglia and
    Tsang with the boost below alpha = 1.  float64 within 1e-12 relative
    (1e-12 absolute for loggamma's values near 0); float32, whose erfinv
    ulps are cubed and, below alpha = 1, raised to 1/alpha, within 1e-4
    relative (or 1e-30 absolute for draws that underflow, and 1e-6 of the
    largest magnitude for loggamma's, which cancel near 0)."""
    alpha = np.repeat(np.array([0.05, 0.7, 1.0, 3.5, 250.0], dtype), 400)
    before = rl.gamma_draw.plain_calls
    got = rl.gamma_draw(torch.as_tensor(LOOP_KEY), torch.from_numpy(alpha), log_space).numpy()
    assert rl.gamma_draw.plain_calls == before + 1
    fn = jr.loggamma if log_space else jr.gamma
    want = np.asarray(fn(_jkey(), alpha, alpha.shape, dtype=dtype))
    assert got.dtype == want.dtype == np.dtype(dtype)
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 if log_space else 0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max() if log_space else 1e-30)


def test_tp_plain_version_is_jax_randoms_poisson_and_keeps_the_last_accepting_round():
    """TP's plain version at every branch (0, Knuth below 10, rejection at
    and above) in one batch, bit for bit.  ``jax.random``'s rejection loop
    overwrites k with every later accepting round until the whole batch
    has accepted: keeping each element's first acceptance instead changes
    most draws of the rejection branch."""
    lam = np.repeat(np.array([0.0, 0.5, 3.0, 9.99, 10.0, 37.0, 50.0], np.float32), 300)
    got = rl.poisson_draw(torch.as_tensor(LOOP_KEY), torch.from_numpy(lam)).numpy()
    want = np.asarray(jr.poisson(_jkey(), lam, lam.shape))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert np.all(got[lam == 0] == 0)

    def first_round(key, idx, step, work=None, own=None):
        k_out = accepted = None
        while accepted is None or not bool(accepted.all()):
            key, s0, s1 = rl._split(key, 3)
            k, accept = step(s0, s1)
            if k_out is None:
                k_out, accepted = torch.full_like(k, -1.0), torch.zeros_like(accept)
            k_out = torch.where(accept & ~accepted, k, k_out)
            accepted = accepted | accept
        return k_out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rl, "_rejection_rounds", first_round)
        other = rl.poisson_plain(torch.as_tensor(LOOP_KEY), torch.from_numpy(lam)).numpy()
    rejection = lam >= 10
    assert np.mean(other[rejection] != want[rejection]) > 0.5


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tb_plain_version_is_jax_randoms_binomial(dtype):
    """TB's plain version: inversion (n q <= 10), BTRS, the reflection at
    p > 0.5 and the invalid-parameter rules (nan for p < 0 or nan, a
    negative or nan count), bit for bit."""
    cases = np.array([(5, 0.3), (40, 0.2), (1000, 0.5), (1e6, 0.01), (30, 0.9), (2000, 0.7), (7, -0.1),
                      (7, np.nan), (-3, 0.4), (np.nan, 0.4), (0, 0.3), (12, 0.0), (12, 1.0)], dtype)
    count, prob = (np.repeat(cases[:, j], 150) for j in (0, 1))
    got = rl.binomial_draw(torch.as_tensor(LOOP_KEY), torch.from_numpy(count), torch.from_numpy(prob)).numpy()
    want = np.asarray(jr.binomial(_jkey(), count, prob, count.shape, dtype=dtype))
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)


def test_poisson_at_lambda_1e4_differs_only_by_rare_acceptance_flips():
    """At λ = 1e4 the rejection test compares float32 values near 8e4
    (lgamma(k + 1)), where one ulp is 0.008, and XLA's float32 log differs
    from PyTorch's by an ulp for about one input in seven: an acceptance
    then flips, and the element takes another round's k.  Everything else
    is the JAX package's; at most 1 in 500 draws may differ (3 in 10,000
    did on the CPU), and a differing draw is still a draw near λ."""
    results = []
    for m in (JAX, PORT):
        f = m["pkg"].function([], _draw(m, "poisson", (1e4,), (4000,)))
        results.append(_host(f()))
    want, got = results
    differ = got != want
    assert differ.sum() <= want.size // 500, differ.sum()
    assert np.all(np.abs(got[differ] - 1e4) < 600)


def test_the_loop_wrappers_refuse_mixed_devices_and_bad_types_and_bind_the_source():
    key = torch.as_tensor(LOOP_KEY)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rl.gamma_draw(key, torch.ones(3, device="meta"))
    with pytest.raises(TypeError, match="int32"):
        rl.mrg_draw(torch.ones((4, 6), dtype=torch.int64), 8, "float64")
    with pytest.raises(TypeError, match="float32 or float64"):
        rl.mrg_draw(torch.ones((4, 6), dtype=torch.int32), 8, "float16")
    import os

    from aesara_tpu_torch.link.torch.kernels.build import CSRC

    src = open(os.path.join(CSRC, "random_loops.cu")).read()
    for entry in ("int tg_gamma(", "int tp_poisson(", "int tb_binomial(", "int tm_mrg(",
                  "const char* random_loops_error_string("):
        assert entry in src
