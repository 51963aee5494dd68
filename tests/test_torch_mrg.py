"""MRG31k3p streams of the port (``aesara_tpu_torch/sandbox/rng_mrg.py``,
``sandbox/multinomial.py``, the lowering in ``link/torch/random_dispatch.py``
and TM's plain version in ``link/torch/kernels/random_loops.py``) against
the JAX package's ``aesara_tpu/sandbox`` on the CPU, bit for bit: the
draws of ``mrg_uniform`` (n a multiple of the stream count and not, float32
and float64) and the states after each of three calls, every method of
``MRG_RandomStream``, the host's jumps and ``DotModulo``.
"""

import numpy as np
import pytest
import torch

import jax

import aesara_tpu
from aesara_tpu.sandbox import rng_mrg as jm

import aesara_tpu_torch
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels import random_loops as rl
from aesara_tpu_torch.sandbox import rng_mrg as pm


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _run(build, calls=3):
    """Each package's draws and states after ``calls`` calls of the
    function ``build(stream)`` returns, from the same seed."""
    out = []
    for pkg, mod in ((aesara_tpu, jm), (aesara_tpu_torch, pm)):
        rs = mod.MRG_RandomStream(seed=2024)
        f = pkg.function([], build(rs))
        draws, states = [], []
        for _ in range(calls):
            res = f()
            draws.extend([_host(v) for v in res] if isinstance(res, list) else [_host(res)])
            states.append([_host(r.get_value()) for r, *_ in rs.state_updates])
        out.append((draws, states))
    return out


def _equal(runs):
    (jd, js), (pd, ps) = runs
    for a, b in zip(pd, jd):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ps, js):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,nstreams", [(12, 4), (7, 2), (5, 8), (1000, 7), (999, None), (46080, None)],
                         ids=["multiple", "ragged", "fewer_than_streams", "ragged_1000", "guessed", "three_steps"])
def test_mrg_uniform_is_the_jax_packages_bit_for_bit(n, nstreams, dtype):
    _equal(_run(lambda rs: rs.uniform(size=(n,), nstreams=nstreams, dtype=dtype)))


def test_mrg_uniform_of_two_dims_and_a_range():
    _equal(_run(lambda rs: [rs.uniform(size=(30, 7), dtype="float32"),
                            rs.uniform(size=(12,), nstreams=4, low=-2.0, high=3.0, dtype="float64")]))


def test_normal_binomial_multinomial_and_choice_are_the_jax_packages():
    pvals = np.array([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]])
    _equal(_run(lambda rs: rs.normal(size=(11, 3), avg=1.0, std=2.0, dtype="float64")))
    _equal(_run(lambda rs: rs.binomial(size=(50,), p=0.3)))
    _equal(_run(lambda rs: rs.multinomial(pvals=pvals)))
    _equal(_run(lambda rs: rs.choice(size=2, replace=False, p=pvals)))


def test_the_stream_objects_host_side_is_the_jax_packages():
    """Seeds and their checks, the substream states, the 2^134 jump,
    ``DotModulo``, ``guess_n_streams`` and the unsupported methods."""
    for seed in (12345, [1, 2, 3, 4, 5, 6]):
        js, ps = jm.MRG_RandomStream(seed), pm.MRG_RandomStream(seed)
        np.testing.assert_array_equal(ps.get_substream_rngs(9), js.get_substream_rngs(9))
        np.testing.assert_array_equal(ps.rstate, js.rstate)
    np.testing.assert_array_equal(pm.ff_2p134(np.arange(1, 7)), jm.ff_2p134(np.arange(1, 7)))
    np.testing.assert_array_equal(pm.multMatVect(np.arange(3, 9), pm.A1p72, pm.M1, pm.A2p72, pm.M2),
                                  jm.multMatVect(np.arange(3, 9), jm.A1p72, jm.M1, jm.A2p72, jm.M2))
    for size in ((5,), (7, 9), (4096, 64), "x"):
        assert pm.guess_n_streams(size) == jm.guess_n_streams(size)
    dot = pm.DotModulo()
    args = (pm.A1p134, np.array([5, 6, 7]), int(pm.M1), pm.A2p134, np.array([8, 9, 10]), int(pm.M2))
    node = dot.make_node(*args)
    storage = [[None]]
    dot.perform(node, list(args), storage)
    want = [[None]]
    jm.DotModulo().perform(None, list(args), want)
    np.testing.assert_array_equal(storage[0][0], want[0][0])
    for bad in (0, int(pm.M2), [0, 0, 0, 1, 1, 1]):
        with pytest.raises(ValueError):
            pm.MRG_RandomStream(seed=bad)
    with pytest.raises(NotImplementedError):
        pm.MRG_RandomStream(1).multinomial_wo_replacement()
    with pytest.raises(NotImplementedError):
        pm.MRG_RandomStream(1).binomial(size=(3,), n=2)


def test_reseeding_and_the_plain_version_against_the_host_recurrence():
    """``seed`` resets every stream's state as the JAX package's does;
    TM's plain version steps each stream as ``mrg_next_value`` does."""
    streams, fns = [], []
    for pkg, mod in ((aesara_tpu, jm), (aesara_tpu_torch, pm)):
        rs = mod.MRG_RandomStream(seed=77)
        fns.append(pkg.function([], rs.uniform(size=(20,), nstreams=6)))
        streams.append(rs)
    for f in fns:
        f()
    for rs in streams:
        rs.seed(99)
    np.testing.assert_array_equal(_host(fns[1]()), _host(fns[0]()))
    state = pm.MRG_RandomStream(5).get_substream_rngs(3)
    before = rl.mrg_draw.plain_calls
    new, draws = rl.mrg_draw(torch.from_numpy(state), 7, "float64")
    assert rl.mrg_draw.plain_calls == before + 1
    rows = [state[j].astype(np.int64) for j in range(3)]
    want = [pm.mrg_next_value(rows[i % 3]) for i in range(7)]
    np.testing.assert_array_equal(draws.numpy(), np.asarray(want))
    # streams 0 and 1 stepped 3 times, stream 2 twice
    np.testing.assert_array_equal(new.numpy(), np.stack(rows).astype(np.int32))
