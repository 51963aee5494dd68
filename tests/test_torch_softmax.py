"""K4 (row softmax / log-softmax) and the softmax family of the port,
against the JAX package on the CPU.

The plain version of K4 is held against the Pallas kernel in interpret
mode (as ``tests/link/test_pallas.py`` runs it) and against ``jax.nn``,
which the JAX lowering calls, including −inf entries and a row that is
−inf throughout (nan in all three).  The ``Softmax`` / ``LogSoftmax`` /
``SoftmaxGrad`` lowerings and their gradients are held against JAX
FAST_RUN for axis −1, 0 and None.  Tolerance: 1e-6 absolute and relative
in float32 (one exp, one sum and one divide per value, in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.link.jax.pallas_kernels import log_softmax_rows, softmax_rows as jax_softmax_rows
from aesara_tpu.tensor import math as jtm
from aesara_tpu.tensor import special as jspecial

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.link.torch.kernels.softmax import (
    BLOCK_ROWS, LANE_GROUPS, TWO_PASS, launch_plan, softmax_rows, softmax_rows_plain,
)
from aesara_tpu_torch.tensor import math as ptm
from aesara_tpu_torch.tensor import special as pspecial


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


TOL = 1e-6
JAX = dict(pkg=aesara_tpu, at=jat, tm=jtm, special=jspecial, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, tm=ptm, special=pspecial, mode="TORCH")


def _rows(shape, seed=0, with_inf=False):
    x = np.random.default_rng(seed).normal(size=shape).astype("float32") * 3
    if with_inf:
        x[0, :] = -np.inf             # a row that is -inf throughout
        x[1, ::3] = -np.inf           # a row with some -inf entries
    return x


@pytest.mark.parametrize("shape", [(5, 37), (19, 20), (3, 300)])
@pytest.mark.parametrize("with_inf", [False, True], ids=["finite", "inf"])
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log_softmax"])
def test_plain_k4_matches_pallas_interpret_and_jax_nn(shape, with_inf, log):
    x = _rows(shape, with_inf=with_inf)
    got = softmax_rows_plain(torch.from_numpy(x), log).numpy()
    with pltpu.force_tpu_interpret_mode():
        kernel = (log_softmax_rows if log else jax_softmax_rows)(jnp.asarray(x))
    nn = (jax.nn.log_softmax if log else jax.nn.softmax)(jnp.asarray(x), axis=-1)
    for want in (np.asarray(kernel), np.asarray(nn)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if with_inf:
        assert np.isnan(got[0]).all()
        assert (got[1, ::3] == (-np.inf if log else 0.0)).all()


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    x = torch.from_numpy(_rows((4, 6)))
    before = softmax_rows.plain_calls
    torch.testing.assert_close(softmax_rows(x, log=True), softmax_rows_plain(x, log=True))
    assert softmax_rows.plain_calls == before + 1


@pytest.mark.parametrize("n,want", [
    (1, (LANE_GROUPS, 128)), (20, (LANE_GROUPS, 128)), (1023, (LANE_GROUPS, 128)), (1024, (LANE_GROUPS, 128)),
    (1025, (BLOCK_ROWS, 128)), (4096, (BLOCK_ROWS, 128)), (4097, (BLOCK_ROWS, 256)), (8193, (BLOCK_ROWS, 512)),
    (16384, (BLOCK_ROWS, 512)), (16385, (TWO_PASS, 256)), (32768, (TWO_PASS, 256))])
def test_k4_launch_plan_is_a_function_of_the_width(n, want):
    """The regime and tile K4 takes for rows of n values (the classifier's
    20 among them): lane groups in blocks of 128 threads up to 1,024
    values, one block a row up to 16,384 (the fewest threads, 128 at least,
    that hold 32 values each), then two passes.  Kept by the H100 sweeps of
    ``chip_smoke.py --k4-times``."""
    assert launch_plan(n) == want


def _combine(m1, s1, m2, s2):
    """Two (max, sum of exp(value - max)) pairs as one, as ``combine`` in
    ``softmax_rows.cu``: a pair whose max is -inf has sum 0."""
    m = np.maximum(m1, m2)
    with np.errstate(invalid="ignore"):
        s = s1 * np.exp(m1 - m) + s2 * np.exp(m2 - m)
    return m, np.where(m == -np.inf, np.float32(0), s).astype(np.float32)


def _two_pass_model(x, log, threads, ve):
    """K4's two-pass regime in its order, in float32 (``softmax_two_pass_kernel``):
    thread t takes the vectors t, t + threads, ... of ``ve`` values; a
    vector's max, then the thread's running pair (while it has seen only
    -inf its sum stays 0); the pairs combined by a butterfly inside each
    warp of 32, then the warps' in order; a second pass writes."""
    rows, n = x.shape
    vecs = x.reshape(rows, n // ve, ve)
    M = np.full((rows, threads), -np.inf, np.float32)
    S = np.zeros((rows, threads), np.float32)
    for k0 in range(0, n // ve, threads):
        chunk = vecs[:, k0:k0 + threads]
        t = chunk.shape[1]
        mn = np.maximum(M[:, :t], chunk.max(-1))
        add = np.zeros((rows, t), np.float32)
        with np.errstate(invalid="ignore"):
            for q in range(ve):
                add = add + np.exp(chunk[..., q] - mn)
            running = S[:, :t] * np.exp(M[:, :t] - mn) + add
        seen = mn != -np.inf
        S[:, :t] = np.where(seen, running, S[:, :t])
        M[:, :t] = np.where(seen, mn, M[:, :t])
    for off in (16, 8, 4, 2, 1):
        other = np.arange(threads) ^ off
        M, S = _combine(M, S, M[:, other], S[:, other])
    m, s = M[:, 0], S[:, 0]
    for w in range(1, threads // 32):
        m, s = _combine(m, s, M[:, 32 * w], S[:, 32 * w])
    with np.errstate(invalid="ignore", divide="ignore"):
        z = x - m[:, None]
        return z - np.log(s)[:, None] if log else np.exp(z) / s[:, None]


@pytest.mark.parametrize("threads,ve", [(256, 4), (1024, 4), (256, 1)])
@pytest.mark.parametrize("log", [False, True], ids=["softmax", "log_softmax"])
def test_two_pass_order_matches_plain_and_jax_nn(threads, ve, log):
    """The two-pass order on rows of 9,000 values whose first 5,000 are -inf
    (every thread's first vectors all -inf), -inf throughout (nan), every
    third -inf, and finite.  Tolerance 1e-5: sums of 9,000 float32 values
    in three orders."""
    x = _rows((4, 9000), seed=5)
    x[0, :5000] = -np.inf
    x[1, :] = -np.inf
    x[2, ::3] = -np.inf
    got = _two_pass_model(x, log, threads, ve)
    plain = softmax_rows_plain(torch.from_numpy(x), log).numpy()
    nn = np.asarray((jax.nn.log_softmax if log else jax.nn.softmax)(jnp.asarray(x), axis=-1))
    for want in (plain, nn):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.isnan(got[1]).all()
    assert (got[0, :5000] == (-np.inf if log else 0.0)).all()


def test_plain_k4_computes_bfloat16_in_fp32_and_float64_in_fp64():
    x = _rows((6, 33), seed=1)
    bf = softmax_rows_plain(torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16
    want = softmax_rows_plain(torch.from_numpy(x).to(torch.bfloat16).float())
    torch.testing.assert_close(bf, want.to(torch.bfloat16), atol=0, rtol=0)
    f64 = softmax_rows_plain(torch.from_numpy(x.astype("float64")), log=True)
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), np.asarray(jax.nn.log_softmax(x.astype("float64"))),
                               atol=1e-12, rtol=1e-12)


def _graph(m, op, axis):
    x = m["at"].tensor3("x")
    g = m["at"].tensor3("g")
    out = getattr(m["special"], op)(x, axis=axis)
    cost = m["tm"].sum(m["tm"].mul(out, g))
    return [x, g], [out, m["pkg"].grad(cost, x)]


@pytest.mark.parametrize("axis", [-1, 0, None], ids=["last", "first", "none"])
@pytest.mark.parametrize("op", ["softmax", "log_softmax"])
def test_lowerings_and_grads_match_jax(op, axis):
    rng = np.random.default_rng(2)
    values = [rng.normal(size=(3, 4, 5)).astype("float32") for _ in range(2)]
    results = []
    for m in (JAX, PORT):
        inputs, outputs = _graph(m, op, axis)
        f = m["pkg"].function(inputs, outputs, mode=m["mode"])
        results.append([np.asarray(v) for v in f(*values)])
    (jout, jgrad), (pout, pgrad) = results
    np.testing.assert_allclose(pout, jout, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pgrad, jgrad, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("axis", [-1, 0, None], ids=["last", "first", "none"])
def test_softmax_grad_op_matches_jax(axis):
    rng = np.random.default_rng(3)
    dy, x = (rng.normal(size=(4, 6)).astype("float32") for _ in range(2))
    results = []
    for m, mod in ((JAX, jspecial), (PORT, pspecial)):
        a, b = m["at"].matrix("dy"), m["at"].matrix("x")
        out = mod.SoftmaxGrad(axis)(a, mod.softmax(b, axis=axis))
        f = m["pkg"].function([a, b], out, mode=m["mode"])
        results.append(np.asarray(f(dy, x)))
    np.testing.assert_allclose(results[1], results[0], atol=TOL, rtol=TOL)


def test_softmax_graph_runs_k4_once_per_op():
    x = pat.matrix("x")
    f = aesara_tpu_torch.function([x], [pspecial.softmax(x), pspecial.log_softmax(x, axis=0)])
    before = softmax_rows.plain_calls
    sm, lsm = f(_rows((4, 5), seed=4))
    assert softmax_rows.plain_calls == before + 2
    np.testing.assert_allclose(sm.sum(-1).numpy(), np.ones(4), atol=1e-6)
    np.testing.assert_allclose(np.exp(lsm.numpy()).sum(0), np.ones(5), atol=1e-6)
