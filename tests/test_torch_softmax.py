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
from aesara_tpu_torch.link.torch.kernels.softmax import launch_config, softmax_rows, softmax_rows_plain
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
    (1, (True, 1024, 1, 4)), (20, (True, 32, 32, 4)), (33, (True, 16, 64, 4)), (1000, (True, 1, 1024, 4)),
    (2048, (True, 1, 2048, 4)), (4096, (True, 1, 4096, 8)), (8192, (True, 1, 8192, 8)),
    (8193, (False, 1, 2048, 8))])
def test_k4_launch_is_a_function_of_the_width(n, want):
    """The launch K4 takes for rows of n columns (the classifier's 20 among
    them): one pass up to 8,192 columns, a block of up to 1,024 values a
    program, kept by the H100 sweep of ``chip_smoke.py --k4-times``."""
    assert launch_config(n) == want


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
