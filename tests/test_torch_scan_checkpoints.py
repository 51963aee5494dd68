"""``scan_checkpoints`` on the port against the JAX package's, on the CPU:
the JAX package's own tests of it (``tests/scan/test_basic.py``,
``tests/scan/test_review_regressions.py``) run on the port, then the BPTT
gradient of config 4's recurrence through ``scan_checkpoints`` against the
plain ``scan``'s, in float64 within 1e-12 of each other and of the JAX
package's.
"""

import numpy as np
import pytest

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.scan.basic import scan as jscan
from aesara_tpu.scan.checkpoints import scan_checkpoints as jcheckpoints

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.scan.basic import scan as pscan
from aesara_tpu_torch.scan.checkpoints import scan_checkpoints as pcheckpoints


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's entry points run on the card by default; these tests ask
    for the CPU."""
    with config.change_flags(device="cpu"):
        yield


JAX = dict(pkg=aesara_tpu, at=jat, scan=jscan, checkpoints=jcheckpoints, mode="FAST_RUN")
PORT = dict(pkg=aesara_tpu_torch, at=pat, scan=pscan, checkpoints=pcheckpoints, mode="TORCH")


def _host(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def test_scan_checkpoints_is_at_the_jax_packages_paths():
    assert aesara_tpu_torch.scan_checkpoints is pcheckpoints


def test_scan_checkpoints_forward():
    x = pat.vector("x", dtype="float64")
    h, _ = pcheckpoints(lambda xt, acc: acc + xt, sequences=[x],
                        outputs_info=pat.constant(np.float64(0.0)), save_every_N=4)
    f = aesara_tpu_torch.function([x], h)
    v = np.random.default_rng(0).normal(size=12)
    np.testing.assert_allclose(_host(f(v)), np.cumsum(v)[3::4], rtol=1e-12)


def test_non_multiple_length_not_polluted():
    x = pat.matrix("x", dtype="float64")
    h, _ = pcheckpoints(lambda xt, htm1: htm1 + 1.0, sequences=[x],
                        outputs_info=pat.zeros((2,), dtype="float64"), save_every_N=10)
    f = aesara_tpu_torch.function([x], h[-1])
    np.testing.assert_allclose(_host(f(np.ones((15, 2)))), 15.0)


def test_n_steps_only_path():
    h, _ = pcheckpoints(lambda htm1: htm1 * 2.0, outputs_info=pat.ones((3,), dtype="float64"),
                        n_steps=7, save_every_N=3)
    f = aesara_tpu_torch.function([], h[-1])
    np.testing.assert_allclose(_host(f()), 2.0 ** 7)


def _rnn(m, T, B, H, D, checkpoint):
    at = m["at"]
    xs = at.tensor3("xs", dtype="float64")
    wx, wh = at.matrix("wx", dtype="float64"), at.matrix("wh", dtype="float64")
    h0 = at.zeros((B, H), dtype="float64")

    def step(x, h, wxx, whh):
        return at.tanh(at.dot(x, wxx) + at.dot(h, whh))

    if checkpoint:
        hs, _ = m["checkpoints"](step, sequences=[xs], outputs_info=h0, non_sequences=[wx, wh], save_every_N=checkpoint)
    else:
        hs, _ = m["scan"](step, sequences=[xs], outputs_info=h0, non_sequences=[wx, wh])
    loss = at.sum(hs[-1] ** 2)
    return [xs, wx, wh], [loss] + m["pkg"].grad(loss, [wx, wh])


@pytest.mark.parametrize("T,N", [(12, 4), (13, 5)])
def test_checkpointed_gradient_is_the_plain_scans(T, N):
    """The BPTT gradient through ``scan_checkpoints`` equals the plain
    scan's and the JAX package's, in float64 within 1e-12 (a length that
    is not a multiple of N pads the last segment)."""
    B, H, D = 3, 4, 5
    r = np.random.default_rng(T)
    vals = [r.normal(size=(T, B, D)), r.normal(scale=0.3, size=(D, H)), r.normal(scale=0.3, size=(H, H))]
    got = {}
    for name, m, ck in (("port_ck", PORT, N), ("port_plain", PORT, 0), ("jax_ck", JAX, N)):
        ins, outs = _rnn(m, T, B, H, D, ck)
        f = m["pkg"].function(ins, outs, mode=m["mode"])
        got[name] = [_host(o) for o in f(*vals)]
    for other in ("port_plain", "jax_ck"):
        for a, b in zip(got["port_ck"], got[other]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_doc_scan_md_call():
    """``doc/scan.md``'s ``scan_checkpoints(fn, sequences=[X],
    save_every_N=32)`` on the port, against the JAX package's."""
    res = []
    r = np.random.default_rng(3)
    X = r.normal(size=(70, 4)).astype("float32")
    for m in (JAX, PORT):
        at = m["at"]
        x = at.matrix("X")
        h, _ = m["checkpoints"](lambda xt, h: at.tanh(xt + h), sequences=[x],
                                outputs_info=at.zeros((4,), dtype="float32"), save_every_N=32)
        f = m["pkg"].function([x], [h, m["pkg"].grad(at.sum(h[-1]), x)], mode=m["mode"])
        res.append([_host(o) for o in f(X)])
    for p, j in zip(res[1], res[0]):
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6)
