"""MRG31k3p streams of the port (``aesara_tpu_torch/sandbox/rng_mrg.py``,
``sandbox/multinomial.py``, the lowering in ``link/torch/random_dispatch.py``
and TM's plain version in ``link/torch/kernels/random_loops.py``) against
the JAX package's ``aesara_tpu/sandbox`` on the CPU, bit for bit: the
draws of ``mrg_uniform`` (n a multiple of the stream count and not, float32
and float64) and the states after each of three calls, every method of
``MRG_RandomStream``, the host's jumps and ``DotModulo``.  TM's schedule
(a thread a chunk of a stream's steps, jumped there by the jump table, its
sums folded in 32 bits) is modelled here with int64 torch ops and held to
TM's plain version and the JAX package's lowering.
"""

import itertools

import numpy as np
import pytest
import torch

import jax

import aesara_tpu
from aesara_tpu.link.jax.dispatch import jax_funcify
from aesara_tpu.sandbox import rng_mrg as jm
from aesara_tpu.tensor.type import TensorType

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


def _box_muller(u, size, avg, std):
    """``MRG_RandomStream.normal``'s transform in NumPy float64 on the
    uniforms ``u`` of one call (z0 block, then z1 block)."""
    half = u.shape[0] // 2
    r = np.sqrt(-2.0 * np.log(u[:half]))
    theta = (2.0 * np.pi) * u[half:]
    z = np.concatenate([r * np.cos(theta), r * np.sin(theta)])[:int(np.prod(size))]
    return z.reshape(size) * std + avg


def _one_ulp_of_the_draw(got, want, avg):
    """``got`` within 1 ulp of ``want - avg``, the draw before its shift
    by ``avg``: the shift keeps the draw's absolute error but may halve the
    value's magnitude (1 + 2 * -0.27 = 0.46), so 1 ulp of the draw can be
    2 of the result."""
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want - avg))), np.abs(got - want) / np.spacing(want)


def test_normal_binomial_multinomial_and_choice_are_the_jax_packages():
    """The uniforms under ``normal`` and the states stay bitwise; the
    normal draws are held within 1 ulp each (``_one_ulp_of_the_draw``), of
    the JAX package's and of a NumPy Box-Muller on the port's own uniforms.  Box-Muller's radius
    passes through a float64 ``sqrt``: XLA's, NumPy's and the card's are
    correctly rounded, torch's CPU one is not on some installations (one
    ulp low at 1.9561459203565867), so a bitwise test of it would pass or
    fail by the machine.  Binomial, multinomial and choice stay bitwise."""
    pvals = np.array([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]])
    size, n_even = (11, 3), 34
    (jd, js), (pd, ps) = _run(lambda rs: rs.normal(size=size, avg=1.0, std=2.0, dtype="float64"))
    for a, b in zip(ps, js):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    uniforms = _run(lambda rs: rs.uniform(size=(n_even,), low=0.0, high=1.0, ndim=1, dtype="float64"))
    _equal(uniforms)
    for z, want, u in zip(pd, jd, uniforms[1][0]):
        assert z.dtype == want.dtype == np.float64 and z.shape == want.shape == size
        _one_ulp_of_the_draw(z, want, 1.0)
        _one_ulp_of_the_draw(z, _box_muller(u, size, 1.0, 2.0), 1.0)
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


# ---------------------------------------------------------------------------
# TM's schedule: jump tables, chunks and 32-bit folds
# ---------------------------------------------------------------------------

M1, M2, LOW31 = rl.M1, rl.M2, 2**31 - 1
#: the H100's resident threads (132 SMs of 2048), and a card small enough
#: that a few streams are cut into chunks
SLOTS = (132 * 2048, 64)


def _edge_states():
    """Every state whose components come from 0, 1, m2 - 1 and m1 - 1 (the
    last at or above m2 in the second triple): 4**6 streams."""
    return np.array(list(itertools.product((0, 1, M2 - 1, M1 - 1), repeat=6)), dtype=np.int32)


def _random_states(n_streams, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, M1, size=(n_streams, 3)), rng.integers(0, M2, size=(n_streams, 3))],
                          axis=1).astype(np.int32)


def _reduce_once(v, m):
    """The kernel's conditional subtract, on a value it holds in 32 bits
    that one subtract brings below ``m``."""
    assert bool((v >= 0).all() and (v < 2**32).all() and (v < 2 * m).all())
    return torch.where(v >= m, v - m, v)


def _y1(x12, x13):
    p = x12 * 4194304 + x13 * 129
    return _reduce_once((p & LOW31) + (p >> 31), M1)


def _y2(x21, x23):
    p = x21 * 32768 + x23 * 32769
    return _reduce_once((p & LOW31) + (p >> 31) * 21069, M2)


def _row(a, x, first):
    """A jump row times a triple, as the kernel folds it: the 64-bit sum P
    of three products (below 3 * 2**62) held as P >> 31 and P & (2**31 -
    1), folded twice."""
    prods = a * x
    lo = (prods & LOW31).sum(-1)
    hi = (prods >> 31).sum(-1) + (lo >> 31)
    lo = lo & LOW31
    if first:
        v = lo + hi
        assert bool((v < 2**33).all())
        return _reduce_once((v & LOW31) + (v >> 31), M1)
    v = lo + hi * 21069
    assert bool((v < 2**47).all())
    return _reduce_once((v & LOW31) + (v >> 31) * 21069, M2)


def _tm_model(state, n, dtype, chunk):
    """TM's launch as int64 torch ops on the CPU: thread (j, c) jumps stream
    j by row c of ``mrg_jump_table``, steps ``chunk`` times with the
    kernel's folds and writes its draws; the thread holding the stream's
    last own step writes its state (chunk 0 where it has none)."""
    n_streams = state.shape[0]
    steps = -(-n // n_streams) if n else 0
    chunks = max(1, -(-steps // chunk))
    table = torch.from_numpy(rl.mrg_jump_table(chunk, chunks).astype(np.int64))
    ids = torch.arange(n_streams * chunks)
    j, c = ids % n_streams, ids // n_streams
    rem = n % n_streams
    own = torch.where((j >= rem) & (rem != 0), steps - 1, steps)
    t0 = c * chunk
    last = c == torch.where(own > 0, torch.div(own - 1, chunk, rounding_mode="floor"), 0)
    x = torch.from_numpy(state.astype(np.int64))[j]
    a = table[c]
    jumped = torch.stack([_row(a[:, 3 * i:3 * i + 3], x[:, :3], True) for i in range(3)]
                         + [_row(a[:, 9 + 3 * i:12 + 3 * i], x[:, 3:], False) for i in range(3)], dim=1)
    x = torch.where((c > 0)[:, None], jumped, x)
    draws = torch.zeros(n, dtype=torch.int64)
    for k in range(chunk):
        t = t0 + k
        live = t < own
        y1, y2 = _y1(x[:, 1], x[:, 2]), _y2(x[:, 3], x[:, 5])
        stepped = torch.stack([y1, x[:, 0], x[:, 1], y2, x[:, 3], x[:, 4]], dim=1)
        x = torch.where(live[:, None], stepped, x)
        d = y1 - y2
        d = torch.where(d <= 0, d + M1, d)
        draws[(t * n_streams + j)[live]] = d[live]
    new_state = torch.from_numpy(state.copy())
    new_state[j[last]] = x[last].to(torch.int32)
    fdt = torch.float64 if dtype == "float64" else torch.float32
    return new_state, draws.to(fdt) * rl.MRG_NORM[dtype]


def test_jump_table_rows_are_the_stepped_states():
    """Row c of ``mrg_jump_table(L, rows)`` applied to a state (exactly, by
    the host's ``_mat_vec_mod``) is the state after c L steps of TM's plain
    step, from seeded states and from every edge state, at several L; its
    entries lie below their moduli and row 0 is the identity."""
    states = np.concatenate([_random_states(64, 5), _edge_states()])
    comps = tuple(torch.from_numpy(states[:, k].astype(np.int64)) for k in range(6))
    for chunk, rows in ((3, 9), (8, 16), (61, 5), (1093, 3)):
        table = rl.mrg_jump_table(chunk, rows)
        assert table.shape == (rows, 18) and table.dtype == np.uint32
        assert (table[:, :9] < M1).all() and (table[:, 9:] < M2).all()
        np.testing.assert_array_equal(table[0], np.eye(3, dtype=np.uint32).ravel().tolist() * 2)
        stepped = comps
        for c in range(1, rows):
            for _ in range(chunk):
                stepped = rl._mrg_step(stepped)
            want = torch.stack(stepped, dim=1).numpy()
            a1, a2 = (table[c, 9 * h:9 * h + 9].astype(np.int64).reshape(3, 3) for h in (0, 1))
            for i in range(0, len(states), 97):
                got = np.concatenate([pm._mat_vec_mod(a1, states[i, :3], M1), pm._mat_vec_mod(a2, states[i, 3:], M2)])
                np.testing.assert_array_equal(got, want[i], err_msg=f"L {chunk} row {c} state {states[i]}")


@pytest.mark.parametrize("n_streams,n,chunk", [
    (7, 0, None), (40, 13, None), (1, 1, None), (33, 33, None), (33, 34 * 33 - 5, None),
    (1, 4000, None), (1, 4000, 3), (1, 4000, 61), (5, 997, 7), (64, 64 * 300, None),
    (15360, 1 << 20, None), (15360, 1 << 20, 5), (15360, 15360 * 6, None), (166, 1000, None),
], ids=["n0", "fewer_than_streams", "one_step", "one_step_each", "ragged", "one_stream", "one_stream_L3",
        "one_stream_L61", "ragged_L7", "64_streams", "15360x69", "15360x69_L5", "15360x6", "guessed_1000"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tm_schedule_is_the_plain_version_and_the_jax_packages(n_streams, n, chunk, dtype):
    """TM's launch modelled on the CPU (its chunks from ``mrg_chunks`` at
    the H100's resident threads and at a card of 64 threads, or a given
    L) bit for bit against ``mrg_plain`` and the JAX package's lowering of
    ``mrg_uniform`` (a ``lax.scan``): draws and new states, from seeded
    states."""
    state = _random_states(n_streams, n_streams + n)
    steps = -(-n // n_streams) if n else 0
    chunks = {rl.mrg_chunks(n_streams, steps, slots)[0] for slots in SLOTS} if chunk is None else {chunk}
    want_state, want = rl.mrg_plain(torch.from_numpy(state), n, dtype)
    js, jd = jax_funcify(jm.mrg_uniform(TensorType(dtype, (None,))))(state, np.array([n]))
    np.testing.assert_array_equal(np.asarray(js), want_state.numpy())
    np.testing.assert_array_equal(np.asarray(jd), want.numpy())
    for L in chunks:
        got_state, got = _tm_model(state, n, dtype, L)
        assert got.dtype == want.dtype
        assert torch.equal(got_state, want_state), L
        assert torch.equal(got, want), L


@pytest.mark.parametrize("n", [1, 4096, 4096 * 40 - 3])
def test_tm_schedule_at_the_edge_states(n):
    """Every edge state (components 0, 1, m2 - 1, m1 - 1) as a stream of
    one draw: TM's modelled launch (one step, then 40 in chunks of 8 and of
    5) bit for bit against ``mrg_plain``, and against the JAX package's
    lowering where the state is one ``MRG_RandomStream`` admits (its second
    triple below m2)."""
    state = _edge_states()
    for dtype in ("float32", "float64"):
        want_state, want = rl.mrg_plain(torch.from_numpy(state), n, dtype)
        steps = -(-n // len(state))
        for L in {rl.mrg_chunks(len(state), steps, 64)[0], 5}:
            got_state, got = _tm_model(state, n, dtype, L)
            assert torch.equal(got_state, want_state) and torch.equal(got, want), (dtype, L)
        admitted = (state[:, 3:] < M2).all(axis=1)
        js, jd = jax_funcify(jm.mrg_uniform(TensorType(dtype, (None,))))(state[admitted], np.array([n]))
        ps, pd = rl.mrg_plain(torch.from_numpy(state[admitted]), n, dtype)
        np.testing.assert_array_equal(np.asarray(js), ps.numpy())
        np.testing.assert_array_equal(np.asarray(jd), pd.numpy())


def test_tm_chunks():
    """``mrg_chunks``: one chunk for short streams and for streams that fill
    the card alone; else chunks of at least ``MRG_MIN_CHUNK`` steps that
    cover the stream, at most ``MRG_MAX_CHUNKS`` of them, the last holding
    the rest."""
    h100 = SLOTS[0]
    assert rl.mrg_chunks(15360, 6, h100) == (6, 1)
    assert rl.mrg_chunks(166, 7, h100) == (7, 1)
    assert rl.mrg_chunks(7, 0, h100) == (1, 1)
    assert rl.mrg_chunks(h100, 50, h100) == (50, 1)
    for n_streams, steps in ((15360, 69), (15360, 1093), (64, 16384), (1, 1 << 24), (3, 100)):
        chunk, chunks = rl.mrg_chunks(n_streams, steps, h100)
        assert chunks > 1 and chunk >= rl.MRG_MIN_CHUNK and chunks <= rl.MRG_MAX_CHUNKS
        assert (chunks - 1) * chunk < steps <= chunks * chunk
    assert rl.mrg_chunks(15360, 69, h100) == (32, 3)
    assert rl.mrg_chunks(15360, 1093, h100) == (63, 18)
    assert rl.mrg_chunks(64, 16384, h100) == (32, 512)
    assert rl.mrg_chunks(1, 1 << 24, h100) == (256, 1 << 16)
