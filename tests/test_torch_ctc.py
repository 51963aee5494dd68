"""The CTC loss of the port (``aesara_tpu_torch/tensor/nnet/ctc.py``,
lowered in ``link/torch/nnet_dispatch.py``) against the JAX package's
``aesara_tpu/tensor/nnet/ctc.py`` on the CPU, at T = 12, B = 4, C = 6,
L = 4, through each package's ``function()``.

The batch holds repeated labels, ``-1`` padding, a zero-length label, an
input length under T and an impossible alignment (a label that needs more
frames than its input has, whose loss is the DP's floor, about 1e30, in
both packages); the blank is 0 and C-1.  The loss and its gradient with
respect to the activations (through the log-softmax) agree within 1e-10
relative in float64 and 1e-5 in float32 (of each tensor's largest value:
the two DPs sum the same terms, the gradients' scatter in another order),
as do the updates of an sgd step of a linear CTC head.  Padded states read
class C-1, as ``jnp.take_along_axis`` wraps ``-1``: a test changes only
that column and sees both packages' losses move together.  Log-probabilities
with ``-inf`` give both packages' losses and gradients, nan entries at the
same places.
"""

import numpy as np
import pytest
import torch

import jax

import aesara_tpu
import aesara_tpu.tensor as jat
from aesara_tpu.tensor.nnet.ctc import CTCLoss as JCTCLoss, ctc as jctc

import aesara_tpu_torch
import aesara_tpu_torch.tensor as pat
from aesara_tpu_torch.config import config
from aesara_tpu_torch.tensor.nnet.ctc import CTCGrad, CTCLoss, ctc as pctc, ctc_grad_torch, ctc_loss_torch

T, B, C, L = 12, 4, 6, 4
TOL = {"float64": 1e-10, "float32": 1e-5}


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


JAX = dict(pkg=aesara_tpu, at=jat, ctc=jctc)
PORT = dict(pkg=aesara_tpu_torch, at=pat, ctc=pctc)


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _batch(dtype, blank, seed=0):
    """Activations, labels and input lengths: row 0 repeats a label and is
    padded, row 1 has no label, row 2 repeats its last label and is cut to
    9 frames, row 3 needs 4 frames but has 3."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, B, C)).astype(dtype)
    lo = 1 if blank == 0 else 0
    labels = rng.integers(lo, lo + C - 1, size=(B, L))
    labels[0] = [lo + 1, lo + 1, lo + 2, -1]
    labels[1] = -1
    labels[2, 3] = labels[2, 2]
    labels[3] = [lo, lo + 1, lo, lo + 1]
    return x, labels, np.array([T, T, 9, 3])


def _loss_and_grad(m, dtype, blank, batch, label_lengths=None):
    at = m["at"]
    x, lab, il = at.tensor3("x", dtype=dtype), at.lmatrix("l"), at.lvector("i")
    ins = [x, lab, il]
    if label_lengths is not None:
        ll = at.lvector("ll")
        ins.append(ll)
        loss = m["ctc"](x, lab, il, ll, blank=blank)
    else:
        loss = m["ctc"](x, lab, il, blank=blank)
    # weights per row, so each row's gradient is checked apart
    weights = np.arange(1.0, B + 1).astype(dtype)
    g = m["pkg"].grad(at.sum(loss * weights), x)
    f = m["pkg"].function(ins, [loss, g])
    args = list(batch) + ([label_lengths] if label_lengths is not None else [])
    return [_host(v) for v in f(*args)]


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("blank", [0, C - 1], ids=["blank0", "blankC-1"])
def test_loss_and_gradient_are_the_jax_packages(dtype, blank):
    batch = _batch(dtype, blank)
    (jl, jg), (pl, pg) = (_loss_and_grad(m, dtype, blank, batch) for m in (JAX, PORT))
    _close(pl, jl, dtype)
    _close(pg, jg, dtype)
    # the impossible alignment: the DP's finite floor, as the JAX package's
    assert np.all(np.isfinite(pl)) and pl[3] > 1e29
    assert np.all(np.isfinite(pg))


def test_explicit_label_lengths_and_padding_reads_the_last_class():
    """Given lengths equal the counted ones; the padded states of a row read
    column C-1 (the wrap of -1), so raising only that column's activation
    moves the loss of a padded row in both packages alike."""
    dtype, blank = "float64", 0
    x, lab, il = _batch(dtype, blank)
    ll = (lab >= 0).sum(axis=1)
    base = [_loss_and_grad(m, dtype, blank, (x, lab, il), ll) for m in (JAX, PORT)]
    _close(base[1][0], base[0][0], dtype)
    _close(base[1][1], base[0][1], dtype)
    counted = _loss_and_grad(PORT, dtype, blank, (x, lab, il))
    np.testing.assert_array_equal(counted[0], base[1][0])
    x2 = x.copy()
    x2[:, :, C - 1] += 3.0
    moved = [_loss_and_grad(m, dtype, blank, (x2, lab, il), ll) for m in (JAX, PORT)]
    _close(moved[1][0], moved[0][0], dtype)
    assert not np.allclose(moved[1][0], base[1][0])


def test_the_dp_functions_and_ops_on_the_host():
    """``ctc_loss_torch`` and ``ctc_grad_torch`` (the lowerings' forms) on
    CPU tensors, twice with the same bits, and the ops' ``perform`` giving
    the same values; labels and lengths have no gradient."""
    x, lab, il = _batch("float64", 0)
    lp = torch.log_softmax(torch.from_numpy(x), dim=-1)
    ll = torch.from_numpy((lab >= 0).sum(axis=1))
    lab_t, il_t = torch.from_numpy(lab), torch.from_numpy(il)
    loss = ctc_loss_torch(lp, lab_t, il_t, ll)
    gz = torch.arange(1.0, B + 1, dtype=torch.float64)
    g1, g2 = (ctc_grad_torch(lp, lab_t, il_t, ll, gz) for _ in range(2))
    assert torch.equal(g1, g2)
    loss_op, grad_op = CTCLoss(0), CTCGrad(0)
    lpv = pat.tensor3("lp", dtype="float64")
    node = loss_op.make_node(lpv, pat.lmatrix("l"), pat.lvector("i"), pat.lvector("ll"))
    storage = [[None]]
    loss_op.perform(node, [lp.numpy(), lab, il, ll.numpy()], storage)
    np.testing.assert_array_equal(storage[0][0], loss.numpy())
    gnode = grad_op.make_node(*node.inputs, pat.dvector("gz"))
    grad_op.perform(gnode, [lp.numpy(), lab, il, ll.numpy(), gz.numpy()], storage)
    np.testing.assert_array_equal(storage[0][0], g1.numpy())
    from aesara_tpu_torch.gradient import DisconnectedType

    grads = loss_op.L_op(node.inputs, node.outputs, [pat.dvector("g")])
    assert [isinstance(g.type, DisconnectedType) for g in grads] == [False, True, True, True]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_an_sgd_step_of_a_ctc_head_is_the_jax_packages(dtype):
    """A linear head (d = 8) on (T, B, d) features, trained by sgd at 0.1
    through ``function()`` with updates: loss and weights after each of
    two steps."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(T, B, 8)).astype(dtype)
    w0 = (rng.normal(size=(8, C)) * 0.3).astype(dtype)
    b0 = np.zeros(C, dtype)
    _, lab, il = _batch(dtype, 0)
    runs = []
    for m in (JAX, PORT):
        at, pkg = m["at"], m["pkg"]
        w, b = pkg.shared(w0.copy(), name="w"), pkg.shared(b0.copy(), name="b")
        x, lv, iv = at.tensor3("x", dtype=dtype), at.lmatrix("l"), at.lvector("i")
        loss = at.mean(m["ctc"](at.dot(x, w) + b, lv, iv))
        gw, gb = pkg.grad(loss, [w, b])
        step = pkg.function([x, lv, iv], loss, updates=[(w, w - 0.1 * gw), (b, b - 0.1 * gb)])
        out = []
        for _ in range(2):
            out.append(_host(step(feats, lab, il)))
            out.append(_host(w.get_value()))
            out.append(_host(b.get_value()))
        runs.append(out)
    for got, want in zip(runs[1], runs[0]):
        _close(np.asarray(got), np.asarray(want), dtype)


def test_minus_inf_log_probabilities_match_the_jax_packages():
    """Log-probabilities with -inf (a class never emitted, a blank ruled out
    at one step) into ``CTCLoss`` itself: the same losses, the impossible
    one the floor, and the same gradient, its nan entries (the JAX
    package's guard sends a zero cotangent through a 0/0) at the same
    places."""
    rng = np.random.default_rng(1)
    lp = np.log(rng.dirichlet(np.ones(C), size=(T, B)))
    lp[:, :, 3] = -np.inf
    lp[4, :, 0] = -np.inf
    lab = np.array([[1, 3, 2, -1], [1, 2, -1, -1], [2, 2, 1, 1], [5, 4, -1, -1]])
    il, ll = np.array([12, 12, 10, 7]), np.array([3, 2, 4, 2])
    weights = np.arange(1.0, B + 1)
    runs = []
    for m, op in ((JAX, JCTCLoss), (PORT, CTCLoss)):
        at = m["at"]
        x, lv, iv, lv2 = at.tensor3("lp", dtype="float64"), at.lmatrix("l"), at.lvector("i"), at.lvector("ll")
        loss = op(0)(x, lv, iv, lv2)
        f = m["pkg"].function([x, lv, iv, lv2], [loss, m["pkg"].grad(at.sum(loss * weights), x)])
        runs.append([_host(v) for v in f(lp, lab, il, ll)])
    (jl, jg), (pl, pg) = runs
    np.testing.assert_allclose(pl, jl, rtol=TOL["float64"])
    assert pl[0] > 1e29 and np.isnan(jg).sum() > 0
    np.testing.assert_array_equal(np.isnan(pg), np.isnan(jg))
    np.testing.assert_allclose(pg, jg, rtol=TOL["float64"], atol=TOL["float64"] * np.nanmax(np.abs(jg)), equal_nan=True)
